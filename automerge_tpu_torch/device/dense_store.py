"""Device-resident dense document store: the collab-server engine.

This is the SURVEY §7 architecture taken to its conclusion: the CRDT
state of a whole DocSet lives in device memory as dense planes, and
`applyChanges` for a million-op block is a handful of scatter-max ops —
no host-side state walk at all. Wire traffic per apply is the
compressed change columns in (a few bytes per op), and patches come back
as device tensors with lazy host materialization.

Representation. For flat map documents, a field's CRDT state is at most
one surviving assignment per actor (same-actor ops on one field are
always causally ordered, so the later one supersedes —
op_set.js:180-219). That makes the whole store dense (all int32, no
int64 anywhere on the device path):

* ``ESeqDel[f, a]`` — ``(seq << 1) | is_del``: actor `a`'s latest
  assignment to field `f` (0 = none). Applying an op is one scatter-max:
  a later seq always wins.
* ``EVal[f, a]`` — the value ref of that assignment, kept consistent
  with ESeqDel by resetting every updated cell and re-scattering the
  ops that achieved the new maximum.
* ``M[f, a]`` — the running max over *every* applied op's transitive
  closure clock. Supersession needs ``max over ops j on f of
  clock_j[a]``; a superseding op's closure contains its victim's
  closure, so the max over live ops equals the max over all ops ever
  applied — M can accumulate monotonically (scatter-max, no removal).

An entry (f, a) is **alive** iff ``seq > 0`` and ``M[f, a] < seq`` (not
superseded) and not a delete; the winner is the alive entry with the
highest actor string rank (op_set.js:211), the rest are the conflicts.

Causal admission (vector-clock waves) and string interning stay on the
host (:mod:`.blocks`); everything per-op runs on device. Capacities
(docs, keys, actor slots) are fixed at construction — the price of dense
addressing — with clear errors on overflow; the general unbounded path
is :func:`automerge_tpu_torch.device.blocks.apply_block`. Actor slots
are PER DOCUMENT (``actor_capacity`` bounds the distinct actors editing
one document, not the store-wide actor population); winner election
reads a device-resident per-doc string-rank plane.

One scope limit vs the block path: two assignments to the same key
within one change (never emitted by the reference frontend —
`ensureSingleAssignment`, frontend/index.js:46) need two surviving
entries in one (field, actor) cell, which the dense planes cannot hold;
such blocks are rejected before any mutation with a clear error and
take :func:`automerge_tpu_torch.device.blocks.apply_block` instead.

The PyTorch port's copy of ``automerge_tpu/device/dense_store.py``. The
three device programs are torch functions on the store's device (they
were XLA programs in the reference, not Pallas kernels, so they stay
plain tensor ops). Where torch and the reference's array semantics
differ: dropped out-of-range scatters land in a sink row that is sliced
off; the static-size nonzero is a cumsum placement (no host sync);
the padded repeat is a ``searchsorted`` over the op-count prefix, its
padding rows taking the last change as the reference's does; argmax
keeps the FIRST maximum; every prefix sum is pinned to int32. The
store's ``device`` defaults to the card (:func:`~..config.
resolve_device`); the snapshot format is the reference's, so snapshots
cross-load between the two packages. With a ``mesh`` the planes are
doc-major row chunks, one per mesh entry on that entry's device, and
each apply routes the block's changes by document and runs the same
steps per shard on its own rows (bit-equal to the unsharded store).
"""

import numpy as np
import torch

from ..config import resolve_device
from ..utils.metrics import metrics
from . import blocks as _blocks
from .blocks import _SET, _DEL

_VAL_NONE = np.int32(-2147483648)      # "no value" sentinel for EVal
_I32 = torch.int32


def _unpack_bits(bits, n):
    """``[n]`` bool from np.packbits bytes (MSB first), on device."""
    idx = torch.arange(n, device=bits.device)
    return ((bits[idx >> 3].to(_I32) >> (7 - (idx & 7)).to(_I32)) & 1) \
        .bool()


def _scatter_max_rows(plane, rows, cols, src):
    """``plane.at[rows, cols].max(src, mode='drop')`` over a
    ``[n_fields, A]`` plane: out-of-range rows (the padding parked at
    ``n_fields``) land in a sink row that is sliced off. ``cols`` None
    scatters whole ``[len(rows), A]`` rows. Returns a new plane."""
    n, a = plane.shape
    out = torch.cat((plane, plane.new_zeros((1, a))))
    r = torch.where((rows >= 0) & (rows < n), rows, n).to(torch.int64)
    if cols is None:
        flat = (r[:, None] * a
                + torch.arange(a, device=r.device)).reshape(-1)
        src = src.reshape(-1)
    else:
        flat = r * a + cols.to(torch.int64)
    out.view(-1).scatter_reduce_(0, flat, src, 'amax', include_self=True)
    return out[:n]


def _apply_kernel(eseq, eval_, m, change_doc, change_actor, change_seq,
                  coo_row, coo_col, coo_val, op_counts, op_key,
                  op_isdel_bits, op_value, n_ops, key_capacity, v_base, *,
                  n_fields, n_actors, seq_values):
    """One block apply: expand change columns to op rows ON DEVICE, then
    scatter-maxes into the resident planes. Returns new planes.

    Wire-lean inputs: the change columns arrive in the narrowest dtype
    that fits (int16 docs/seqs, uint8 slots/counts — upcast here); the
    del mask arrives bit-packed (uint8, unpacked here); with
    ``seq_values`` the value refs are not shipped at all — set ops
    reference values sequentially from ``v_base`` (the layout
    ChangeBlock.from_changes and the workload generators produce), so the
    refs are a cumulative sum computed on device; and the closure clock
    plane is REBUILT ON DEVICE — a change's own-actor entry is always
    seq-1 (the transitiveDeps fold ends with that SET), so only the
    sparse cross-actor closure entries ship, as COO triples.
    """
    dev = eseq.device
    change_doc = change_doc.to(_I32)
    change_actor = change_actor.to(_I32)
    change_seq = change_seq.to(_I32)
    op_counts = op_counts.to(_I32)
    coo_col = coo_col.to(torch.int64)
    coo_val = coo_val.to(_I32)
    n_pad = op_key.shape[0]
    c_pad = change_doc.shape[0]
    # row c_pad is the sink of the padded COO triples (mode='drop')
    change_clock = torch.zeros((c_pad + 1, n_actors), dtype=_I32,
                               device=dev)
    change_clock[torch.arange(c_pad, device=dev),
                 change_actor.to(torch.int64)] = change_seq - 1
    crow = coo_row.to(torch.int64)
    crow = torch.where((crow >= 0) & (crow < c_pad), crow, c_pad)
    change_clock[crow, coo_col] = coo_val
    change_clock = change_clock[:c_pad]
    # jnp.repeat(arange(c_pad), op_counts, total_repeat_length=n_pad):
    # op i belongs to the first change whose count prefix passes i;
    # the padding rows take the last change, as the reference's fill
    ends = torch.cumsum(op_counts, 0, dtype=_I32)
    idx = torch.arange(n_pad, device=dev)
    op_change = torch.searchsorted(ends, idx.to(_I32), right=True) \
        .clamp_(max=c_pad - 1)
    valid = idx < n_ops

    op_isdel = _unpack_bits(op_isdel_bits, n_pad)
    if seq_values:
        sets = valid & ~op_isdel
        op_value = torch.where(
            sets, v_base + torch.cumsum(sets.to(_I32), 0, dtype=_I32) - 1,
            -1).to(_I32)
    else:
        op_value = op_value.to(_I32)

    fidx = change_doc[op_change] * key_capacity + op_key.to(_I32)
    # padding rows are parked at n_fields (out of bounds) and dropped by
    # the scatters — planes stay exactly [n_fields, A]
    fidx = torch.where(valid, fidx, n_fields).to(_I32)
    aslot = change_actor[op_change]
    seq_op = change_seq[op_change]

    seqdel = (seq_op << 1) | op_isdel.to(_I32)
    seqdel = torch.where(valid, seqdel, 0).to(_I32)
    new_eseq = _scatter_max_rows(eseq, fidx, aslot, seqdel)

    # cells whose max advanced get their value re-scattered by exactly
    # the ops that achieved the new maximum
    new_eval = torch.where(new_eseq != eseq, int(_VAL_NONE), eval_) \
        .to(_I32)
    at = torch.where(valid, fidx, 0).to(torch.int64)
    got = torch.where(valid, new_eseq[at, aslot.to(torch.int64)], 0)
    mine = valid & (seqdel == got)
    new_eval = _scatter_max_rows(new_eval, torch.where(mine, fidx, n_fields),
                                 aslot, op_value)

    clock_op = change_clock[op_change]                 # [n_pad, A]
    clock_op = torch.where(valid[:, None], clock_op, -1).to(_I32)
    new_m = _scatter_max_rows(m, fidx, None, clock_op)
    return new_eseq, new_eval, new_m


def _apply_extract_kernel(eseq, eval_, m, chg_doc, chg_actor, chg_seq,
                          chg_counts, coo_row, coo_col, coo_val, op_key,
                          op_isdel_bits, op_value, n_ops, key_capacity,
                          v_base, rank_plane, touched_bits, *, n_fields,
                          n_actors, seq_values, f_pad):
    """Apply + patch extraction in ONE device step. Change columns
    arrive in narrow dtypes and the touched-field mask bit-packed —
    wire bytes per 1M-op apply drop ~3x."""
    new_eseq, new_eval, new_m = _apply_kernel(
        eseq, eval_, m, chg_doc, chg_actor, chg_seq, coo_row,
        coo_col, coo_val, chg_counts, op_key, op_isdel_bits,
        op_value, n_ops, key_capacity, v_base, n_fields=n_fields,
        n_actors=n_actors, seq_values=seq_values)
    touched_mask = _unpack_bits(touched_bits, n_fields)
    extracted = _extract_kernel(
        new_eseq, new_eval, new_m, rank_plane, key_capacity,
        touched_mask, f_pad=f_pad)
    return (new_eseq, new_eval, new_m) + extracted


def _nonzero_padded(mask, size):
    """``jnp.nonzero(mask, size=size, fill_value=-1)[0]`` as int32
    without a host sync: each set index lands at its rank among the
    set bits; ranks past ``size`` go to a sink slot."""
    dev = mask.device
    rank = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    slot = torch.where(mask & (rank < size), rank, size).to(torch.int64)
    out = torch.full((size + 1,), -1, dtype=_I32, device=dev)
    out[slot] = torch.arange(mask.shape[0], dtype=_I32, device=dev)
    return out[:size]


def _extract_kernel(eseq, eval_, m, rank_plane, key_capacity,
                    touched_mask, *, f_pad):
    """Patch extraction for the touched fields, fully on device.

    ``rank_plane`` is the device-resident [n_docs, A] actor-string-rank
    table (slots are PER DOCUMENT); each touched field gathers its own
    document's row. Returns (touched fidx [f_pad], winner slot [f_pad],
    winner value [f_pad], alive mask [f_pad, A], values [f_pad, A]);
    -1 fidx rows are padding.
    """
    fidx = _nonzero_padded(touched_mask, f_pad)
    frow = torch.clamp(fidx, min=0).to(torch.int64)
    seqdel = eseq[frow]                                # [f_pad, A]
    mrows = m[frow]
    seq = seqdel >> 1
    is_del = (seqdel & 1) != 0
    alive = (seq > 0) & (mrows < seq) & ~is_del & (fidx >= 0)[:, None]

    f_rank = rank_plane[frow // key_capacity]          # [f_pad, A]
    rank = torch.where(alive, f_rank, -1).to(_I32)
    best = rank.max(dim=1).values
    # argmax keeps the FIRST maximum, as jnp.argmax does
    a = rank.shape[1]
    cols = torch.arange(a, dtype=_I32, device=rank.device)
    winner_slot = torch.where(rank == best[:, None], cols, a) \
        .min(dim=1).values
    has_winner = best >= 0
    winner_slot = torch.where(has_winner, winner_slot, -1).to(_I32)
    values = eval_[frow]                               # [f_pad, A]
    winner_value = torch.gather(
        values, 1, torch.clamp(winner_slot, min=0).to(torch.int64)
        [:, None])[:, 0]
    winner_value = torch.where(has_winner, winner_value, -1).to(_I32)
    return fidx, winner_slot, winner_value, alive, values


def _np(t):
    """Host numpy copy of a device tensor."""
    return t.cpu().numpy()


def _dev(arr, device):
    """A host array (or numpy scalar) as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _note_dense_dispatch(store, args, statics):
    """Shape-signature registry hook for the fused dense apply+extract
    dispatch (device/profiler.py): plane capacity + padded change/op/
    coo widths + the static args ARE the compile signature."""
    from . import profiler as _profiler
    _profiler.note_dispatch(
        'dense.apply_extract',
        ((store.n_fields, store.actor_capacity), args[0].shape,
         args[7].shape,
         args[4].shape, tuple(sorted(statics.items()))),
        rows=args[7].shape[0])


class DensePatch:
    """Patches from one dense apply, as device arrays; host
    materialization (`to_patch_block` / `diffs`) is lazy."""

    def __init__(self, store, fidx=None, winner_slot=None,
                 winner_value=None, alive=None, values=None):
        self._store = store
        self.fidx = fidx
        self.winner_slot = winner_slot
        self.winner_value = winner_value
        self.alive = alive
        self.values = values          # [f_pad, A] value refs per slot
        self._block = None
        self._event = None            # set by the async applier
        self._error = None

    def _resolve_async(self, outs):
        (self.fidx, self.winner_slot, self.winner_value, self.alive,
         self.values) = outs

    def _wait(self):
        if self._event is not None:
            self._event.wait()
            if self._error is not None:
                raise self._error

    def block_until_ready(self):
        self._wait()
        if self.winner_value.is_cuda:
            torch.cuda.synchronize(self.winner_value.device)
        return self

    def to_patch_block(self):
        """Fetch + reshape into a host :class:`~.blocks.PatchBlock`."""
        if self._block is not None:
            return self._block
        self._wait()
        store = self._store
        fidx = _np(self.fidx)
        live = fidx >= 0
        fidx = fidx[live]
        order = np.argsort(fidx, kind='stable')
        fidx = fidx[order]
        w_slot = _np(self.winner_slot)[live][order]
        w_value = _np(self.winner_value)[live][order]
        alive = _np(self.alive)[live][order]

        K = store.key_capacity
        f_doc = (fidx // K).astype(np.int32)
        f_key = (fidx % K).astype(np.int32)
        f_ptr = np.searchsorted(f_doc, np.arange(store.n_docs + 1)) \
            .astype(np.int32)
        has_winner = w_slot >= 0
        f_action = np.where(has_winner, _SET, _DEL).astype(np.int8)
        f_value = np.where(has_winner, w_value, -1).astype(np.int32)
        f_actor = np.where(has_winner,
                           store.slot_actor[f_doc, np.maximum(w_slot, 0)],
                           -1).astype(np.int32)

        # conflicts: alive minus winner, COO -> CSR per field
        losers = alive.copy()
        rows = np.arange(len(fidx))
        losers[rows[has_winner], w_slot[has_winner]] = False
        lf, ls = np.nonzero(losers)
        s_counts = np.bincount(lf, minlength=len(fidx))
        s_ptr = np.zeros(len(fidx) + 1, np.int32)
        np.cumsum(s_counts, out=s_ptr[1:])
        host = store.host
        s_actor = store.slot_actor[f_doc[lf], ls].astype(np.int32)
        values = _np(self.values)[live][order]
        s_value = values[lf, ls].astype(np.int32)

        self._block = _blocks.PatchBlock(
            store.n_docs, f_ptr, f_doc, f_key, f_action, f_value, f_actor,
            s_ptr, s_actor, s_value, host.keys, host.values, host.actors,
            host.c_doc.copy(), host.c_actor.copy(), host.c_seq.copy())
        return self._block

    def diffs(self, d):
        return self.to_patch_block().diffs(d)

    def to_patches(self):
        return self.to_patch_block().to_patches()


class DenseMapStore:
    """A DocSet of flat map documents resident in device memory.

    ``device`` — where the planes live (:func:`~..config.
    resolve_device`: None is the card, and raises without one; pass
    ``'cpu'`` for the host).

    With a ``mesh`` (a 1-D document-axis mesh,
    :func:`~..parallel.mesh.make_mesh`), the planes live sharded across
    its entries — rows are doc-major, so each entry holds whole
    documents' fields (:func:`~..parallel.mesh.doc_sharding`) and the
    apply scatters stay shard-local (dp for the dense engine).
    ``n_docs`` must divide evenly by the mesh size (doc-locality is the
    checked invariant). The patch tensors gather onto the mesh's first
    device, which is also ``device``.
    """

    def __init__(self, n_docs, key_capacity=64, actor_capacity=16,
                 options=None, mesh=None, retain_log=True, device=None):
        from .engine import as_options
        self.options = as_options(options)
        self.n_docs = n_docs
        self.key_capacity = key_capacity
        self.actor_capacity = actor_capacity
        self.n_fields = n_docs * key_capacity
        self.retain_log = retain_log
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self._shard_devices = [self.device]
            self._doc_ranges = [(0, n_docs)]
        else:
            from ..parallel.mesh import doc_sharding
            # whole documents per shard (doc-locality: apply scatters
            # stay shard-local), so the DOC count must divide
            if n_docs % mesh.devices.size:
                raise ValueError(
                    f'{n_docs} docs do not divide over '
                    f'{mesh.devices.size} devices')
            self.device = mesh.devices[0]
            self._shard_devices = list(mesh.devices)
            self._doc_ranges = doc_sharding(mesh, n_docs)
        self._rank_parts = None       # per-shard rows of the rank plane
        # interning/clock/log/queue
        self.host = _blocks.BlockStore(n_docs, retain_log=retain_log,
                                       device=self.device)
        self._applier = None          # lazy device-phase worker thread
        self._jobs = None
        self._last_async = None
        self._async_error = None      # first device-phase failure (fatal)
        self._alloc_planes()
        self._init_slots()

    def _init_slots(self):
        # per-DOC actor slots: actor_capacity bounds the number of
        # distinct actors per document, not store-wide. slot_actor is
        # the host mirror (doc, slot) -> store actor id; the string-rank
        # plane lives device-resident and re-ships only when it changes.
        self.slot_actor = np.full((self.n_docs, self.actor_capacity), -1,
                                  np.int32)
        self.slot_count = np.zeros(self.n_docs, np.int32)
        self._slot_keys = np.zeros(0, np.int64)   # sorted (doc<<32|actor)
        self._slot_vals = np.zeros(0, np.int32)   # parallel slot numbers
        self._rank_plane = None                   # device [D, A]
        self._rank_actors = -1    # actor-table size the plane was built at

    def _alloc_planes(self):
        # one [eseq, eval_, m] triple per shard (one shard without a
        # mesh), each on its shard's device
        kc, a = self.key_capacity, self.actor_capacity
        self._planes = []
        for (lo, hi), dev in zip(self._doc_ranges, self._shard_devices):
            shape = ((hi - lo) * kc, a)
            self._planes.append([
                torch.zeros(shape, dtype=_I32, device=dev),
                torch.full(shape, int(_VAL_NONE), dtype=_I32, device=dev),
                torch.full(shape, -1, dtype=_I32, device=dev)])

    def _plane(k):
        """Whole-store view of plane ``k`` (the shards' rows gathered
        onto ``device`` when sharded); assigning splits a whole plane
        back into the shards' rows."""
        def get(self):
            parts = [p[k] for p in self._planes]
            if len(parts) == 1:
                return parts[0]
            return torch.cat([t.to(self.device) for t in parts])

        def put(self, value):
            kc = self.key_capacity
            for p, (lo, hi), dev in zip(self._planes, self._doc_ranges,
                                        self._shard_devices):
                p[k] = value[lo * kc:hi * kc].to(dev)
        return property(get, put)

    eseq = _plane(0)
    eval_ = _plane(1)
    m = _plane(2)
    del _plane

    def reset(self):
        try:
            self.drain()
        except RuntimeError:
            pass          # reset discards the diverged planes anyway
        self._async_error = None
        self._alloc_planes()
        self.host = _blocks.BlockStore(self.n_docs,
                                       retain_log=self.retain_log,
                                       device=self.device)
        self._init_slots()

    # -- per-doc actor slots -------------------------------------------------

    def _slots_of(self, doc, actor, allocate=False):
        """Slot per (doc, store actor id) pair, vectorized; allocates
        fresh per-doc slots for unseen pairs when ``allocate``."""
        key = (doc.astype(np.int64) << 32) | actor
        pos = np.minimum(np.searchsorted(self._slot_keys, key),
                         max(len(self._slot_keys) - 1, 0))
        hit = (self._slot_keys[pos] == key) if len(self._slot_keys) \
            else np.zeros(len(key), bool)
        slots = np.full(len(key), -1, np.int32)
        if hit.any():
            slots[hit] = self._slot_vals[pos[hit]]
        miss = ~hit
        if allocate and miss.any():
            new_keys = np.unique(key[miss])
            new_docs = (new_keys >> 32).astype(np.int64)
            # per-doc sequential slot numbers continuing slot_count
            starts = np.flatnonzero(np.concatenate(
                [[True], new_docs[1:] != new_docs[:-1]]))
            run = np.arange(len(new_keys)) - np.repeat(
                starts, np.diff(np.append(starts, len(new_keys))))
            new_slots = (self.slot_count[new_docs] + run).astype(np.int32)
            if (new_slots >= self.actor_capacity).any():
                bad = int(new_docs[np.argmax(new_slots)])
                raise ValueError(
                    f'document {bad} exceeds actor_capacity='
                    f'{self.actor_capacity} distinct actors')
            self.slot_actor[new_docs, new_slots] = \
                (new_keys & 0xFFFFFFFF).astype(np.int32)
            np.maximum.at(self.slot_count, new_docs, new_slots + 1)
            merged = np.argsort(np.concatenate(
                [self._slot_keys, new_keys]), kind='stable')
            all_keys = np.concatenate([self._slot_keys, new_keys])
            all_vals = np.concatenate([self._slot_vals, new_slots])
            self._slot_keys = all_keys[merged]
            self._slot_vals = all_vals[merged]
            self._rank_actors = -1               # plane is stale
            # resolve the misses now that they exist
            pos = np.searchsorted(self._slot_keys, key[miss])
            slots[miss] = self._slot_vals[pos]
        elif miss.any():
            raise KeyError('unknown (doc, actor) pair in slot lookup')
        return slots

    def _rank_plane_dev(self):
        """Device-resident [D, A] actor string-rank plane, re-shipped
        only when slots were added or the actor table grew (global
        string ranks shift when a new actor interns)."""
        n_act = len(self.host.actors)
        if self._rank_plane is None or self._rank_actors != n_act:
            ranks = np.full((self.n_docs, self.actor_capacity), -1,
                            np.int64)
            filled = self.slot_actor >= 0
            ranks[filled] = self.host.actor_str_ranks()[
                self.slot_actor[filled]]
            self._rank_plane = _dev(ranks.astype(np.int32), self.device)
            self._rank_actors = n_act
            self._rank_parts = None
        return self._rank_plane

    def _rank_plane_parts(self):
        """Each shard's rows of the rank plane, on its device."""
        plane = self._rank_plane_dev()
        if self._rank_parts is None:
            self._rank_parts = [plane[lo:hi].to(dev) for (lo, hi), dev in
                                zip(self._doc_ranges, self._shard_devices)]
        return self._rank_parts

    def _gather_patch(self, parts, n_touched):
        """The unsharded patch tensors from the shards' extracts: each
        shard's touched rows (fidx lifted to store rows) in shard order,
        then the padding rows, which shard 0 extracted (they read row
        0 of the store, as the unsharded extract's padding does)."""
        kc = self.key_capacity
        heads, tail = [], None
        for s, (out, t, (lo, _)) in enumerate(zip(parts, n_touched,
                                                  self._doc_ranges)):
            out = [x.to(self.device) for x in out]
            fidx = out[0]
            out[0] = torch.where(fidx >= 0, fidx + lo * kc, fidx) \
                .to(_I32)
            heads.append([x[:t] for x in out])
            if s == 0:
                tail = [x[t:] for x in out]
        return tuple(torch.cat([h[i] for h in heads] + [tail[i]])
                     for i in range(5))

    def _shard_f_pads(self, mask, f_pad):
        """Each shard's touched count and its extract size: its own
        count, shard 0's also holding the padding rows."""
        kc = self.key_capacity
        counts = [int(mask[lo * kc:hi * kc].sum())
                  for lo, hi in self._doc_ranges]
        sizes = list(counts)
        sizes[0] += f_pad - sum(counts)
        return counts, sizes

    def _extract(self, mask):
        """Device patch extraction over a boolean field mask (shared by
        apply_block and extract_all)."""
        self.drain()
        f_pad = self.options.pad_segments(max(int(mask.sum()), 1))
        if self.mesh is None:
            return DensePatch(self, *_extract_kernel(
                self.eseq, self.eval_, self.m, self._rank_plane_dev(),
                self.key_capacity, _dev(mask, self.device), f_pad=f_pad))
        kc = self.key_capacity
        counts, sizes = self._shard_f_pads(mask, f_pad)
        parts = [_extract_kernel(*p, rank, kc,
                                 _dev(mask[lo * kc:hi * kc], p[0].device),
                                 f_pad=size)
                 for p, rank, (lo, hi), size in zip(
                     self._planes, self._rank_plane_parts(),
                     self._doc_ranges, sizes)]
        return DensePatch(self, *self._gather_patch(parts, counts))

    def extract_all(self):
        """Patch covering every populated field — materializes the whole
        store (the dense analogue of getPatch, backend/index.js:201-207)."""
        self.drain()
        populated = _np((self.eseq != 0).any(dim=1))
        return self._extract(populated)

    # -- packed checkpoint (SURVEY §5: replay-free resume) -------------------

    def save_snapshot(self):
        """Serialize the packed device planes + host tables to bytes.

        Resume is replay-free: the planes load straight back into HBM.
        Size is the dense capacity plus the interned value table and the
        per-change closure CSR (both grow with applied history — the
        metadata that keeps future causal checks exact)."""
        import io
        import json
        self.drain()
        host = self.host
        host.log_sorted_keys()     # fold pending appends into l_order
        meta = {'format': 'automerge-tpu-dense-snapshot@1',
                'n_docs': self.n_docs,
                'key_capacity': self.key_capacity,
                'actor_capacity': self.actor_capacity,
                'retain_log': self.retain_log,
                'actors': host.actors, 'keys': host.keys,
                'values': list(host.values), 'queue': host.queue}
        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            eseq=_np(self.eseq), eval=_np(self.eval_), m=_np(self.m),
            slot_actor=self.slot_actor, slot_count=self.slot_count,
            c_doc=host.c_doc, c_actor=host.c_actor, c_seq=host.c_seq,
            l_key=host.l_key, l_order=host.l_order,
            l_dep_ptr=host.l_dep_ptr, l_dep_actor=host.l_dep_actor,
            l_dep_seq=host.l_dep_seq,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
        return buf.getvalue()

    @classmethod
    def load_snapshot(cls, data, options=None, mesh=None, device=None):
        """Rebuild a store from :meth:`save_snapshot` bytes (either
        package's: the format is shared) onto ``device``.

        Meshes are runtime topology, not state, so the caller resupplies
        ``mesh`` to resume sharded (a store sized for a sharded
        footprint should not be resumed on one device)."""
        import io
        import json
        with np.load(io.BytesIO(data)) as z:
            meta = json.loads(bytes(z['meta']).decode())
            if meta.get('format') != 'automerge-tpu-dense-snapshot@1':
                raise ValueError('not a dense-store snapshot')
            store = cls(meta['n_docs'],
                        key_capacity=meta['key_capacity'],
                        actor_capacity=meta['actor_capacity'],
                        options=options, mesh=mesh,
                        retain_log=meta.get('retain_log', True),
                        device=device)
            want = (store.n_fields, store.actor_capacity)
            if z['eseq'].shape != want:
                raise ValueError(
                    f"incompatible snapshot: plane shape "
                    f"{z['eseq'].shape} != {want} (saved by an older "
                    f"format?)")
            store.eseq = _dev(z['eseq'], store.device)
            store.eval_ = _dev(z['eval'], store.device)
            store.m = _dev(z['m'], store.device)
            host = store.host
            host.actors = list(meta['actors'])
            host.actor_of = {a: i for i, a in enumerate(host.actors)}
            host.keys = list(meta['keys'])
            host.key_of = {k: i for i, k in enumerate(host.keys)}
            host.values = _blocks.ValueTable()
            host.values.extend(meta['values'])
            host.queue = [(d, ch) for d, ch in meta['queue']]
            host.c_doc = z['c_doc']
            host.c_actor = z['c_actor']
            host.c_seq = z['c_seq']
            # purity is an optimization hint; resumed chains re-derive
            # it conservatively (False costs a no-op closure gather)
            host.c_pure = np.zeros(len(host.c_doc), bool)
            host.l_key = z['l_key']
            host.l_order = z['l_order']
            host.l_dep_ptr = z['l_dep_ptr']
            host.l_dep_actor = z['l_dep_actor']
            host.l_dep_seq = z['l_dep_seq']
            # change bodies (retained blocks) are not serialized: the
            # resumed store can sync peers forward from here, but not
            # across the snapshot boundary
            host.log_truncated = True
            # dense snapshots do not carry state digests: the resumed
            # host store must not advertise zeros as real digests
            host._digest_valid = False
            if 'slot_actor' in z:
                store.slot_actor = z['slot_actor']
                store.slot_count = z['slot_count']
            else:
                # pre-slot snapshots used global slots == store ids
                n = len(host.actors)
                store.slot_actor[:, :n] = np.arange(n, dtype=np.int32)
                store.slot_count[:] = n
            # rebuild the sorted (doc<<32|actor) -> slot index
            docs, slots = np.nonzero(store.slot_actor >= 0)
            keys = (docs.astype(np.int64) << 32) \
                | store.slot_actor[docs, slots]
            order = np.argsort(keys, kind='stable')
            store._slot_keys = keys[order]
            store._slot_vals = slots[order].astype(np.int32)
        return store

    def _check_slot_capacity(self, block):
        """Reject a block whose (doc, actor) pairs would overflow any
        document's slot table — BEFORE any store mutation (conservative:
        counts queued and not-yet-admitted changes too)."""
        host = self.host
        tmp = {}

        def aid(name):
            """Stable counting id: store id, or a temporary for unseen."""
            i = host.actor_of.get(name)
            if i is None:
                i = tmp.get(name)
                if i is None:
                    i = tmp[name] = len(host.actors) + len(tmp)
            return i

        keys = np.zeros(0, np.int64)
        if block.n_changes:
            amap = np.asarray([aid(a) for a in block.actors], np.int64)
            keys = (block.doc.astype(np.int64) << 32) | amap[block.actor]
        if host.queue:
            qk = np.asarray(
                [(d << 32) | aid(ch['actor']) for d, ch in host.queue],
                np.int64)
            keys = np.concatenate([keys, qk])
        if not len(keys):
            return
        keys = np.unique(keys)
        pos = np.minimum(np.searchsorted(self._slot_keys, keys),
                         max(len(self._slot_keys) - 1, 0))
        exists = (self._slot_keys[pos] == keys) \
            if len(self._slot_keys) else np.zeros(len(keys), bool)
        fresh_docs = (keys[~exists] >> 32).astype(np.int64)
        if not len(fresh_docs):
            return
        counts = np.bincount(fresh_docs, minlength=self.n_docs)
        total = counts + self.slot_count
        if (total > self.actor_capacity).any():
            bad = int(np.argmax(total))
            raise ValueError(
                f'document {bad} would need {int(total[bad])} actor '
                f'slots, exceeding actor_capacity={self.actor_capacity}')

    def _stage_block(self, block):
        """Host phase of one apply: admission + wire-lean column
        packing. Returns (numpy kernel args, static kwargs) for
        :func:`_apply_extract_kernel` — the device phase (transfer +
        dispatch + plane swap) runs separately, either inline
        (:meth:`apply_block`) or on the applier thread
        (:meth:`apply_block_async`)."""
        import time
        host = self.host
        opts = self.options

        t0 = time.perf_counter()
        if block.is_general():
            raise ValueError(
                'block carries general ops (sequences/nested objects); '
                'apply through automerge_tpu_torch.device.general')
        if block.has_dup_keys():
            # one dense cell per (field, actor) cannot hold two surviving
            # assignments from one change; reject BEFORE any mutation so
            # the store stays usable (the general path handles the shape)
            raise ValueError(
                'change assigns the same key twice (self-conflict shape); '
                'the dense store holds one entry per (field, actor) — '
                'apply through device.blocks.apply_block instead')
        _blocks.check_block_ranges(host, block)   # clear range errors
        self._check_slot_capacity(block)
        st = _blocks._admit_and_stage(host, block,
                                      max_keys=self.key_capacity)
        block = st.block
        t1 = time.perf_counter()

        # ---- compress + ship change columns (narrowest dtypes) ----
        adm = st.admitted
        rows = np.flatnonzero(adm)
        c_pad = opts.pad_ops(max(len(rows), 1))
        n_chg = len(rows)
        max_seq = int(block.seq[rows].max()) if n_chg else 0
        d_dtype = np.int16 if self.n_docs < (1 << 15) else np.int32
        a_dtype = np.uint8 if self.actor_capacity <= 256 else np.int32
        s_dtype = np.int16 if max_seq < (1 << 15) else np.int32
        counts = np.diff(block.op_ptr)[rows] if n_chg else \
            np.zeros(0, np.int32)
        k_dtype = np.uint8 if (n_chg == 0 or int(counts.max()) < 256) \
            else np.int32
        change_doc = np.zeros(c_pad, d_dtype)
        change_actor = np.zeros(c_pad, a_dtype)
        change_seq = np.zeros(c_pad, s_dtype)
        op_counts = np.zeros(c_pad, k_dtype)
        change_doc[:n_chg] = block.doc[rows]
        change_actor[:n_chg] = self._slots_of(
            block.doc[rows], st.b_actor[rows], allocate=True)
        change_seq[:n_chg] = block.seq[rows]
        # closure EXCEPTIONS in per-doc slot coordinates: the kernel
        # sets every change's own-actor entry to seq-1 itself, so only
        # the sparse cross-actor closure entries ship (zero for fully
        # concurrent batches AND for plain per-actor chains)
        A = self.actor_capacity
        R = st.R
        coo_row = coo_col = coo_val = np.zeros(0, np.int32)
        if R.any():
            Radm = R[rows]
            nz_r, nz_c = np.nonzero(Radm)
            store_id = st.la.store_of(block.doc[rows[nz_r]], nz_c)
            own = store_id == st.b_actor[rows[nz_r]]
            coo_row = nz_r[~own].astype(np.int32)
            # a closure actor always has an applied change on the doc,
            # hence a slot
            coo_col = self._slots_of(block.doc[rows[nz_r[~own]]],
                                     store_id[~own]).astype(np.int32)
            coo_val = Radm[nz_r[~own], nz_c[~own]].astype(np.int32)
        nnz_pad = opts.pad_ops(max(len(coo_row), 1))
        coo_row_p = np.full(nnz_pad, c_pad, np.int32)  # padding rows drop
        coo_row_p[:len(coo_row)] = coo_row
        coo_col_p = np.zeros(nnz_pad, a_dtype)
        coo_col_p[:len(coo_col)] = coo_col
        # closure seqs can reference PRIOR history beyond this block's
        # own seq range — bound the dtype by the actual values
        v_dtype = np.int16 if (len(coo_val) == 0
                               or int(coo_val.max()) < (1 << 15)) \
            else np.int32
        coo_val_p = np.zeros(nnz_pad, v_dtype)
        coo_val_p[:len(coo_val)] = coo_val

        op_counts[:n_chg] = counts
        rank_plane = self._rank_plane_dev()
        n_ops = len(st.oc)
        n_pad = opts.pad_ops(max(n_ops, 1))
        key_dtype = np.uint8 if self.key_capacity <= 256 else np.int32
        t2 = time.perf_counter()

        def finish_pack():
            # PURE reads of the (now-immutable) staged columns + fresh
            # array builds: safe to run on the applier thread, so a
            # pipelined caller's main thread pays only the state-
            # mutating phase above (admission, slots, rank plane)
            op_key = np.zeros(n_pad, key_dtype)
            op_key[:n_ops] = st.o_key
            is_del = st.o_action == _DEL
            op_isdel = np.zeros(n_pad, bool)
            op_isdel[:n_ops] = is_del
            # wire-lean fast path: sequential value refs reconstruct
            # on device
            v_base = int(st.o_value[~is_del][0]) if (~is_del).any() \
                else 0
            seq_values = bool(
                np.array_equal(st.o_value[~is_del],
                               np.arange(v_base,
                                         v_base + int((~is_del).sum()),
                                         dtype=np.int32)))
            if seq_values:
                op_value = np.zeros(1, np.int32)    # unused placeholder
            else:
                op_value = np.full(n_pad, -1, np.int32)
                op_value[:n_ops] = st.o_value
            # touched fields, bit-packed for the wire
            touched = np.zeros(self.n_fields, bool)
            fk = st.o_doc.astype(np.int64) * self.key_capacity + st.o_key
            touched[fk] = True
            # floor the extract bucket at 4096 so sparse ticks share
            # ONE compile of the fused kernel (f_pad is static; an
            # unfloored pow2 would recompile per touched-count bucket)
            f_pad = opts.pad_segments(
                max(int(touched.sum()), min(4096, self.n_fields)))
            args = (change_doc, change_actor, change_seq, op_counts,
                    coo_row_p, coo_col_p, coo_val_p, op_key,
                    np.packbits(op_isdel), op_value, np.int32(n_ops),
                    np.int32(self.key_capacity), np.int32(v_base),
                    rank_plane, np.packbits(touched))
            statics = dict(n_fields=self.n_fields, n_actors=A,
                           seq_values=seq_values, f_pad=f_pad)
            return args, statics

        metrics.bump('dense_batches')
        metrics.bump('dense_ops', n_ops)
        return finish_pack, (t0, t1, t2)

    def _dispatch(self, args, statics):
        """Device phase of one apply: ship the packed columns, run the
        fused apply + extract, swap the planes in. Returns the patch
        tensors."""
        _note_dense_dispatch(self, args, statics)
        if self.mesh is not None:
            return self._dispatch_sharded(args, statics)
        dev = self.device
        # host columns to the device; the scalars stay Python ints and
        # the rank plane is already resident
        shipped = tuple(
            a if isinstance(a, torch.Tensor)
            else int(a) if np.ndim(a) == 0 else _dev(a, dev)
            for a in args)
        out = _apply_extract_kernel(self.eseq, self.eval_, self.m,
                                    *shipped, **statics)
        self.eseq, self.eval_, self.m = out[:3]
        return out[3:]

    def _dispatch_sharded(self, args, statics):
        """The device phase over the mesh: the block's changes route by
        document to the shard holding it (their ops, closure entries,
        touched fields and rank rows with them, in local coordinates),
        each shard runs the fused apply + extract on its own rows, and
        the patch gathers as :meth:`_gather_patch` lays it out."""
        (change_doc, change_actor, change_seq, op_counts, coo_row,
         coo_col, coo_val, op_key, isdel_bits, op_value, n_ops, kc,
         v_base, _, touched_bits) = args
        n_ops, kc, v_base = int(n_ops), int(kc), int(v_base)
        c_pad, n_pad = len(change_doc), len(op_key)
        isdel = np.unpackbits(isdel_bits)[:n_pad].astype(bool)
        if statics['seq_values']:
            # the value refs the kernel would rebuild, made explicit so
            # each shard's subsequence keeps its global refs
            sets = (np.arange(n_pad) < n_ops) & ~isdel
            op_value = np.where(sets, v_base + np.cumsum(sets) - 1, -1)
        op_value = np.asarray(op_value, np.int32)
        touched = np.unpackbits(touched_bits)[:self.n_fields].astype(bool)
        counts, sizes = self._shard_f_pads(touched, statics['f_pad'])
        op_chg = np.repeat(np.arange(c_pad), op_counts.astype(np.int64))
        parts = []
        for s, ((lo, hi), p, rank) in enumerate(zip(
                self._doc_ranges, self._planes, self._rank_plane_parts())):
            dev = p[0].device
            doc = change_doc.astype(np.int64)
            sel = np.flatnonzero((doc >= lo) & (doc < hi))
            local = np.full(c_pad + 1, -1, np.int64)   # change -> local
            local[sel] = np.arange(len(sel))
            ops = np.flatnonzero(local[op_chg] >= 0)
            n_c, n_o = max(len(sel), 1), len(ops)
            c_row = local[np.minimum(coo_row.astype(np.int64), c_pad)]
            keep = c_row >= 0
            # padded closure triples point past the last change (dropped)
            c_row = np.concatenate([c_row[keep], [n_c]]).astype(np.int32)
            c_col = np.concatenate([coo_col[keep], [0]]).astype(np.int32)
            c_val = np.concatenate([coo_val[keep], [0]]).astype(np.int32)
            o_pad = max(n_o, 1)

            def put(a, idx, n, dtype):
                out = np.zeros(n, dtype)
                out[:len(idx)] = a[idx]
                return out
            cols = (put(change_doc.astype(np.int64) - lo, sel, n_c,
                        np.int32),
                    put(change_actor, sel, n_c, np.int32),
                    put(change_seq, sel, n_c, np.int32),
                    put(op_counts, sel, n_c, np.int32),
                    c_row, c_col, c_val,
                    put(op_key, ops, o_pad, np.int32),
                    np.packbits(put(isdel, ops, o_pad, bool)),
                    put(op_value, ops, o_pad, np.int32))
            f_lo, f_hi = lo * kc, hi * kc
            out = _apply_extract_kernel(
                *p, *(_dev(c, dev) for c in cols), n_o, kc, 0, rank,
                _dev(np.packbits(touched[f_lo:f_hi]), dev),
                n_fields=f_hi - f_lo, n_actors=statics['n_actors'],
                seq_values=False, f_pad=sizes[s])
            p[:] = out[:3]
            parts.append(out[3:])
        return self._gather_patch(parts, counts)

    def apply_block(self, block, return_timing=False):
        """Apply a :class:`~.blocks.ChangeBlock`; returns a
        :class:`DensePatch` (device-resident; materialize lazily)."""
        import time
        self.drain()
        finish_pack, (t0, t1, t2) = self._stage_block(block)
        patch = DensePatch(self, *self._dispatch(*finish_pack()))
        t3 = time.perf_counter()
        if return_timing:
            return patch, {'admit': t1 - t0, 'pack': t2 - t1,
                           'dispatch': t3 - t2}
        return patch

    def apply_block_async(self, block):
        """Apply with the device phase (H2D transfer + dispatch + plane
        swap) on the store's applier thread: the caller's next host
        staging overlaps this block's transfers and device program —
        the frontend/backend overlap the reference's split anticipates
        (frontend/index.js:91-104), engine-side. Returns a
        :class:`DensePatch` whose reads wait for the device phase.

        Host staging stays on the calling thread (store host state is
        single-writer); successive async applies are serialized by the
        applier queue. Synchronous readers (:meth:`apply_block`,
        :meth:`extract_all`, :meth:`reset`, :meth:`save_snapshot`)
        drain the queue first."""
        import threading
        if self._async_error is not None:
            raise RuntimeError(
                'a previous async apply failed on device; the device '
                'planes no longer match the host clock/log — restore '
                'from a snapshot or rebuild the store') \
                from self._async_error
        finish_pack, _ = self._stage_block(block)
        patch = DensePatch(self)
        patch._event = threading.Event()

        def job():
            try:
                if self._async_error is not None:
                    # a predecessor failed: the planes are behind the
                    # host clock/log; refuse rather than diverge further
                    raise RuntimeError(
                        'skipped: a previous async apply failed') \
                        from self._async_error
                patch._resolve_async(self._dispatch(*finish_pack()))
            except BaseException as e:       # surfaced on drain/reads
                patch._error = e
                if self._async_error is None:
                    self._async_error = e
            finally:
                patch._event.set()

        self._submit(job)
        self._last_async = patch
        return patch

    def _submit(self, job):
        if self._applier is None:
            import queue
            import threading
            self._jobs = queue.Queue()

            def run():
                while True:
                    j = self._jobs.get()
                    if j is None:
                        return
                    j()

            self._applier = threading.Thread(target=run, daemon=True)
            self._applier.start()
        self._jobs.put(job)

    def drain(self):
        """Wait for any in-flight async applies (device-phase order is
        the applier queue order, so waiting on the last one suffices).
        Raises the FIRST async failure — a failed device phase leaves
        the planes behind the already-committed host clock/log, which
        only a snapshot restore or rebuild can reconcile."""
        p = self._last_async
        if p is not None:
            self._last_async = None
            if p._event is not None:
                p._event.wait()
        if self._async_error is not None:
            raise RuntimeError(
                'an async apply failed on device; the planes are behind '
                'the committed host clock/log — reset() or restore from '
                'a snapshot') from self._async_error

    def close(self):
        """Stop the applier thread (after draining). The store remains
        usable synchronously; a later apply_block_async restarts it."""
        try:
            self.drain()
        finally:
            if self._applier is not None:
                self._jobs.put(None)
                self._applier.join()
                self._applier = None
                self._jobs = None
