"""Replica synchronization on one mesh: the Connection protocol as
collectives.

The reference's distributed story is `Connection` (src/connection.js:33-109):
peers advertise vector clocks, ship the changes the other side is missing,
and converge because the CRDT engine is order-insensitive. Between hosts
this framework keeps that exact host-side protocol (sync/connection.py).
*Within* one mesh, the protocol's three primitives become collectives
instead of messages:

=====================  =======================================
Connection primitive   mesh equivalent (axis ``'peers'``)
=====================  =======================================
clock advertisement    :func:`~.mesh.pmax` of the [n_actors] clock
change shipping        :func:`~.mesh.all_gather` of packed op columns
(ring alternative)     :func:`~.mesh.ppermute` neighbor gossip rounds
convergent apply       the merge kernel on the gathered union
=====================  =======================================

Every peer resolves the identical op union with the identical
deterministic kernel, so all replicas converge in one step — the
collective IS the sync round. The ring variant ships ops hop-by-hop
(P-1 rounds) and bounds per-step traffic at 1/P of the all-gather.

The PyTorch port's copy of ``automerge_tpu/parallel/ici_sync.py``. Each
function takes and returns per-peer lists (:func:`shard_peers`,
:class:`~.mesh.Shards`): entry ``p`` is peer ``p``'s local block,
leading axis 1, on its mesh entry's device, and ``np.asarray`` of the
list is the reference's [P, ...] global array. The union resolve goes
through ``cuda_merge.dispatch_resolve``: the flat-map kernel on a CUDA
peer, its plain version on the CPU.
"""

import numpy as np
import torch

from ..device.cuda_merge import dispatch_resolve
from .mesh import (Mesh, Shards, _mesh_devices, all_gather, pmax, ppermute,
                   psum, shard_docs)

PEER_AXIS = 'peers'
_I32 = torch.int32


def make_peer_mesh(n_peers=None, devices=None, device=None):
    """A 1-D mesh whose axis enumerates replica peers, one mesh entry
    each: the visible cards (``device=None``), logical CPU entries
    (``device='cpu'``: one per peer), or an explicit ``devices`` list,
    which may repeat a device. Raises when more peers are asked for
    than there are devices."""
    if devices is None:
        devices = _mesh_devices(n_peers, device)
    devices = list(devices)
    if n_peers is not None:
        if n_peers > len(devices):
            raise ValueError(
                f'need {n_peers} devices for {n_peers} peers, '
                f'have {len(devices)}')
        devices = devices[:n_peers]
    return Mesh(tuple(devices), (PEER_AXIS,))


def _one_peer_each(*blocks):
    """One peer per mesh entry: a local peer axis > 1 would silently
    scope the collectives to co-located peers only (wrong clocks,
    partial unions)."""
    for b in blocks:
        if b.shape[0] != 1:
            raise ValueError(f'{b.shape[0]} peers share one mesh entry; '
                             f'use one mesh entry per peer')


def _resolve_union(seg, actor, seq, clock, is_del, valid, num_segments):
    return dispatch_resolve(seg, actor, seq, clock, is_del, valid,
                            num_segments=num_segments)


def _merged(outs):
    return {k: Shards(o[k] for o in outs)
            for k in ('surviving', 'winner', 'seg_max_actor')}


def sync_step(mesh, seg_id, actor, seq, clock, is_del, valid, peer_clock, *,
              num_segments):
    """Synchronize P mesh replicas in one collective round.

    Inputs are per-peer lists (:func:`shard_peers`), each entry a local
    block of leading axis 1: ``seg_id/actor/seq/is_del/valid``:
    int32/bool[1, n] — the peer's locally-generated packed ops;
    ``clock``: int32[1, n, A] per-op causal clocks; ``peer_clock``:
    int32[1, A] the peer's replica vector clock.

    Returns (union kernel outputs, per peer [1, P*n] — identical rows,
    proving convergence —, converged clocks per peer [1, A], stats)."""
    _one_peer_each(*seg_id)
    # -- change shipping: union of every peer's ops ------------------------
    def gather(xs):
        return [g.reshape((1, -1) + tuple(g.shape[2:]))
                for g in all_gather(xs, tiled=True)]
    u_seg, u_actor, u_seq, u_del, u_valid, u_clock = map(
        gather, (seg_id, actor, seq, is_del, valid, clock))

    # -- clock advertisement: converged replica clock = elementwise max ----
    new_clock = Shards(pmax(peer_clock))

    # -- convergent apply: deterministic resolve of the identical union ----
    outs = [_resolve_union(*args, num_segments) for args in
            zip(u_seg, u_actor, u_seq, u_clock, u_del, u_valid)]

    stats = {
        'ops_exchanged': psum([v.sum(dtype=_I32) for v in valid])[0],
        # every peer resolves the identical union; pmax of identical
        # values certifies the replication
        'ops_surviving': pmax([o['surviving'].sum(dtype=_I32)
                               for o in outs])[0],
    }
    return _merged(outs), new_clock, stats


def ring_sync_step(mesh, seg_id, actor, seq, clock, is_del, valid, *,
                   num_segments):
    """Ring-gossip variant of :func:`sync_step` (same convergent result):
    (P-1) rounds, each shipping one peer-slot of ops to the next ring
    neighbor with :func:`~.mesh.ppermute` and accumulating it. Per-step
    traffic is 1/P of the union."""
    _one_peer_each(*seg_id)
    n_peers = mesh.devices.size
    perm = [(i, (i + 1) % n_peers) for i in range(n_peers)]
    acc = [seg_id, actor, seq, clock, is_del, valid]
    hop = acc
    for _ in range(n_peers - 1):
        hop = [ppermute(x, perm) for x in hop]
        acc = [[torch.cat([a, h], dim=1) for a, h in zip(xa, xh)]
               for xa, xh in zip(acc, hop)]
    outs = [_resolve_union(*args, num_segments) for args in zip(*acc)]
    return _merged(outs)


def shard_peers(mesh, *arrays):
    """Split arrays (numpy or tensors) with their leading (peer) axis
    over the mesh: for each array, the per-peer list of local blocks,
    block ``p`` on entry ``p``'s device (:func:`~.mesh.shard_docs`)."""
    return shard_docs(mesh, *arrays)


# -- delta shipping: clock-diff windows ---------------------------------------
#
# The all-gather round above ships every peer's whole buffer every round —
# fine for a one-shot union, wrong bandwidth shape for repeated sync. The
# reference ships only what the peer is missing, derived from clocks
# (`maybeSendChanges`, src/connection.js:58-66). The static-shape
# version: each round every peer advertises its replica clock (tiny
# all_gather), selects up to `window` of its locally-held ops that some
# other peer's clock does NOT cover, and ships just that window. Receivers
# accept an op iff it extends their per-actor contiguous prefix (clock
# semantics preserved under partial windows), append it to their buffer,
# and advance their clock. Shipped-op counts shrink to zero at
# convergence — the per-round traffic is the clock diff, not the union.


def _lexsort(keys):
    """``jnp.lexsort(keys)`` on 1-D keys: the LAST key is primary; one
    stable sort per key, from the first key to the last."""
    order = None
    for k in keys:
        k = k.to(_I32) if k.dtype == torch.bool else k
        k_cur = k if order is None else k[order]
        o = torch.sort(k_cur, stable=True).indices
        order = o if order is None else order[o]
    return order


def _put(buf, slot, rows):
    """``buf.at[slot].set(rows, mode='drop')``: slots past the end land
    in a sink row that is sliced off."""
    n = buf.shape[0]
    out = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    out[slot] = rows.to(buf.dtype)
    return out[:n]


def _accept_incoming(in_actor, in_seq, in_clock, in_seg, in_del, in_valid,
                     buf, peer_clock, count, n_cap):
    """Fold incoming window rows into the local buffer.

    Dedups identical (actor, seq) rows (several peers may ship the same
    op), then accepts each actor's rows only as a contiguous seq prefix
    beyond the local clock — exactly `causallyReady` for per-actor op
    rows — and appends them at `count`.
    """
    n_act = peer_clock.shape[0]
    f_actor = torch.where(in_valid, in_actor, 0).to(_I32)
    f_seq = torch.where(in_valid, in_seq, 0).to(_I32)  # seq 0: never taken
    order = _lexsort((f_seq, f_actor))
    s_actor, s_seq = f_actor[order], f_seq[order]
    s_valid = in_valid[order]
    a_idx = s_actor.to(torch.int64).clamp(0, n_act - 1)
    have = peer_clock[a_idx]

    dev = s_actor.device
    first = torch.ones(1, dtype=torch.bool, device=dev)
    prev_same = torch.cat([
        ~first, (s_actor[1:] == s_actor[:-1]) & (s_seq[1:] == s_seq[:-1])])
    cand = s_valid & ~prev_same & (s_seq > have)

    # rank within each actor's candidate run (segmented cumsum)
    new_actor = torch.cat([first, s_actor[1:] != s_actor[:-1]])
    c32 = cand.to(_I32)
    r = torch.cumsum(c32, 0, dtype=_I32)
    base = torch.cummax(torch.where(new_actor, r - c32, 0), 0).values
    rank = r - base                                # 1-based among accepted
    accept = cand & (s_seq == have + rank)

    # append accepted rows at the end of the buffer; rows past capacity
    # are rejected outright (clock must not advance past stored ops).
    # Rejections are a suffix of each actor's accepted run, so per-actor
    # prefix contiguity survives.
    acc32 = accept.to(_I32)
    pos = count + torch.cumsum(acc32, 0, dtype=_I32) - acc32
    accept = accept & (pos < n_cap)
    acc32 = accept.to(_I32)
    slot = torch.where(accept, pos, n_cap).to(torch.int64)
    seg_b, actor_b, seq_b, clock_b, del_b, valid_b = buf
    actor_b = _put(actor_b, slot, s_actor)
    seq_b = _put(seq_b, slot, s_seq)
    seg_b = _put(seg_b, slot, in_seg[order])
    clock_b = _put(clock_b, slot, in_clock[order])
    del_b = _put(del_b, slot, in_del[order])
    valid_b = _put(valid_b, slot, torch.ones_like(s_valid))

    accepted_total = acc32.sum(dtype=_I32)
    new_count = (count + accepted_total).to(_I32)
    # duplicate actor indexes accumulate, as .at[].add does
    new_clock = peer_clock.index_add(0, a_idx, acc32)
    return (seg_b, actor_b, seq_b, clock_b, del_b, valid_b), \
        new_clock, new_count, accepted_total


def delta_sync_round(mesh, state, *, window=64, ring=False):
    """One clock-diff delta round. `state` is the 8-tuple of per-peer
    lists (seg_id, actor, seq, clock, is_del, valid, count, peer_clock);
    returns (new_state, shipped, accepted)."""
    seg_id, actor, seq, clock, is_del, valid, count, peer_clock = state
    _one_peer_each(*seg_id)
    n_peers = mesh.devices.size
    clocks_all = all_gather([c[0] for c in peer_clock])      # [P, A] each

    windows = []
    for me in range(n_peers):
        ac, sq, vd = actor[me][0], seq[me][0], valid[me][0]
        dev = ac.device
        a_idx = ac.to(torch.int64)
        if ring:
            # ship to the next ring neighbor only, against ITS clock
            target_clock = clocks_all[me][(me + 1) % n_peers]
            uncovered = target_clock[a_idx] < sq
        else:
            covered = clocks_all[me][:, a_idx] >= sq[None, :]   # [P, n]
            mine = (torch.arange(n_peers, device=dev) == me)[:, None]
            uncovered = ~torch.all(covered | mine, dim=0)
        needed = vd & uncovered
        # select up to `window` needed ops in (actor, seq) order, so a
        # truncated window still ships contiguous per-actor prefixes
        take = _lexsort((sq, ac, ~needed))[:window]
        windows.append((ac[take], sq[take], seg_id[me][0][take],
                        clock[me][0][take], is_del[me][0][take],
                        needed[take]))
    w_actor, w_seq, w_seg, w_clock, w_del, w_valid = \
        [list(x) for x in zip(*windows)]

    if ring:
        perm = [(i, (i + 1) % n_peers) for i in range(n_peers)]
        incoming = [ppermute(x, perm) for x in
                    (w_actor, w_seq, w_seg, w_clock, w_del, w_valid)]
    else:
        def g(xs):
            return [t.reshape((-1,) + tuple(t.shape[2:]))
                    for t in all_gather(xs)]
        incoming = [g(x) for x in (w_actor, w_seq, w_seg, w_clock, w_del)]
        v_all = all_gather(w_valid)
        incoming.append([
            (v & (torch.arange(n_peers, device=v.device) != me)[:, None])
            .reshape(-1) for me, v in enumerate(v_all)])
    in_actor, in_seq, in_seg, in_clock, in_del, in_valid = incoming

    new = [[] for _ in range(8)]
    accepted = []
    for me in range(n_peers):
        buf = (seg_id[me][0], actor[me][0], seq[me][0], clock[me][0],
               is_del[me][0], valid[me][0])
        n_cap = seg_id[me].shape[1]
        buf, new_clock, new_count, acc = _accept_incoming(
            in_actor[me], in_seq[me], in_clock[me], in_seg[me], in_del[me],
            in_valid[me], buf, peer_clock[me][0], count[me][0], n_cap)
        for i, x in enumerate(buf + (new_count, new_clock)):
            new[i].append(x[None])
        accepted.append(acc)
    shipped = psum([w.sum(dtype=_I32) for w in w_valid])[0]
    accepted = psum(accepted)[0]
    return tuple(map(Shards, new)), int(shipped), int(accepted)


def delta_sync_converge(mesh, state, *, window=64, ring=False,
                        max_rounds=1000):
    """Run delta rounds until a round ships nothing. Returns
    (state, shipped_per_round) — the last entry is always 0, certifying
    convergence; per-round traffic is bounded by P * window ops."""
    shipped_log = []
    for _ in range(max_rounds):
        state, shipped, _ = delta_sync_round(mesh, state, window=window,
                                             ring=ring)
        shipped_log.append(shipped)
        if shipped == 0:
            return state, shipped_log
    raise RuntimeError(f'no convergence after {max_rounds} delta rounds')


def make_delta_state(mesh, seg_id, actor, seq, clock, is_del, valid,
                     n_cap):
    """Build + place the per-peer delta-sync state from each peer's
    locally-generated ops ([P, n] columns). Buffers are padded to
    ``n_cap`` (capacity for the converged union); replica clocks start
    as each peer's own contribution.

    Preconditions (validated): each peer's ``valid`` rows form a
    contiguous prefix (accepted ops append at ``count``), and each
    (peer, actor)'s held seqs are contiguous from 1 — the clock-prefix
    model the acceptance logic relies on. Holes would silently corrupt
    buffers or stall convergence, so they are rejected here.
    """
    p, n = seg_id.shape
    a = clock.shape[-1]

    def pad(x, fill=0):
        out = np.full((p, n_cap) + x.shape[2:], fill, x.dtype)
        out[:, :n] = x
        return out

    counts = valid.sum(axis=1).astype(np.int32)
    peer_clock = np.zeros((p, a), np.int32)
    for i in range(p):
        if valid[i].any() and not valid[i][:counts[i]].all():
            raise ValueError(
                f'peer {i}: valid rows must form a contiguous prefix')
        acts, sqs = actor[i][valid[i]], seq[i][valid[i]]
        np.maximum.at(peer_clock[i], acts, sqs)
        held = np.bincount(acts, minlength=a)
        if (peer_clock[i] != held[:a]).any():
            bad = int(np.flatnonzero(peer_clock[i] != held[:a])[0])
            raise ValueError(
                f'peer {i}, actor {bad}: held seqs must be contiguous '
                f'from 1 (max seq {peer_clock[i][bad]}, '
                f'{held[bad]} ops held)')
    state = (pad(np.asarray(seg_id, np.int32)),
             pad(np.asarray(actor, np.int32)),
             pad(np.asarray(seq, np.int32)),
             pad(np.asarray(clock, np.int32)),
             pad(np.asarray(is_del, bool)),
             pad(np.asarray(valid, bool)),
             counts, peer_clock)
    return tuple(shard_peers(mesh, x) for x in state)
