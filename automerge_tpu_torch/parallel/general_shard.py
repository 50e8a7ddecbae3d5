"""Sharded sequence ordering for the general engine: dirty objects
across the mesh.

The general bulk engine's heavy device work is the per-dirty-object RGA
ordering pass (:mod:`automerge_tpu_torch.device.sequence` over the
[K, m] job planes). Jobs are independent documents' insertion trees —
embarrassingly parallel — so the job axis partitions over a device mesh:
each shard orders its slice of the dirty objects, global length
statistics reduce with :func:`~.mesh.psum`, and the result is
bit-identical to the single-device order.

The PyTorch port's copy of ``automerge_tpu/parallel/general_shard.py``.
A ``shard_map`` body is a loop over the mesh entries, each shard's
tensors on its entry's device; each shard's slice goes through
``sequence._rga_order_batched``, so a CUDA shard launches the RGA
kernel (narrow, wide or grid, by its own dispatch). Outputs gather onto
the mesh's first device.
"""

import numpy as np
import torch

from ..device import sequence
from ..device.merge import _resolve
from .mesh import all_gather, pmax, psum, shard_docs

_I32 = torch.int32


def _rga_body(parent, elem, actor, visible, valid):
    out = sequence._rga_order_batched(parent, elem, actor, visible, valid)
    stats = (out['length'].sum(dtype=_I32),
             torch.tensor(parent.shape[0], dtype=_I32,
                          device=parent.device))
    return out, stats


def _scatter_max_flags(n, flat, flags):
    """``zeros(n, bool).at[flat].max(flags, mode='drop')`` as int32: an
    out-of-range ``flat`` lands in a sink slot that is sliced off."""
    tgt = torch.where((flat >= 0) & (flat < n), flat, n).to(torch.int64)
    out = torch.zeros(n + 1, dtype=_I32, device=flat.device)
    out.scatter_reduce_(0, tgt, flags.to(_I32), 'amax', include_self=True)
    return out[:n]


def sharded_general_step(mesh, ops_actor, ops_seq, ops_slot, boundary,
                         is_del, valid, coo_row, coo_col, coo_val,
                         seq_planes, seq_nj, seq_prior_vis, *,
                         num_segments, a_pad):
    """The general engine's FUSED step (field resolution + element
    visibility + RGA ordering) over a device mesh: assignment ROWS
    shard across devices for the resolve phase, the per-object
    visibility contributions reduce with :func:`~.mesh.pmax`, and the
    dirty-object JOBS shard for the ordering phase — dp over ops and
    over documents' objects, in one two-phase step.

    Inputs are exactly the wire-lean staged planes
    :func:`automerge_tpu_torch.device.general._fused_general` consumes
    (rows FIELD-SORTED, so row ranges partition cleanly); outputs are
    bit-identical to the single-device program.
    """
    n_dev = mesh.devices.size
    boundary = np.asarray(boundary).astype(bool)
    valid = np.asarray(valid).astype(bool)
    n = len(boundary)
    K, m = seq_planes[0].shape

    # host split: row ranges SNAPPED to segment boundaries (rows are
    # field-sorted), so no segment straddles a shard — each shard's
    # resolve is then collective-free, and the per-segment winners
    # combine with one pmax
    bpos = np.flatnonzero(boundary)
    targets = (np.arange(1, n_dev) * n) // n_dev
    cuts = bpos[np.minimum(np.searchsorted(bpos, targets),
                           max(len(bpos) - 1, 0))] if len(bpos) else \
        np.zeros(n_dev - 1, np.int64)
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [n]])
    n_shard = int(np.maximum(ends - starts, 1).max())
    # boundaries strictly BEFORE each start (a snapped start of row 0 has
    # zero preceding boundaries even though boundary[0] is set)
    seg_base = np.where(
        starts > 0, np.cumsum(boundary)[np.maximum(starts - 1, 0)], 0) \
        .astype(np.int32)

    def shardify(a, fill=0):
        out = np.full((n_dev, n_shard) + a.shape[1:], fill, a.dtype)
        for s, (lo, hi) in enumerate(zip(starts, ends)):
            out[s, :hi - lo] = a[lo:hi]
        return out

    s_actor_r = shardify(np.asarray(ops_actor))
    s_seq_r = shardify(np.asarray(ops_seq))
    s_slot_r = shardify(np.asarray(ops_slot), fill=-1)
    s_bnd_r = shardify(boundary)
    s_del_r = shardify(np.asarray(is_del).astype(bool))
    s_val_r = shardify(valid)
    # COO rows land in their owning shard, in local coordinates
    coo_row = np.asarray(coo_row)
    live = coo_row < n
    shard_of = np.searchsorted(ends, coo_row, side='right')
    shard_of = np.minimum(shard_of, n_dev - 1)
    nnz_shard = max(int(np.bincount(shard_of[live],
                                    minlength=n_dev).max())
                    if live.any() else 0, 1)
    c_row = np.full((n_dev, nnz_shard), n_shard, np.int32)
    c_col = np.zeros((n_dev, nnz_shard), np.asarray(coo_col).dtype)
    c_val = np.zeros((n_dev, nnz_shard), np.asarray(coo_val).dtype)
    for s in range(n_dev):
        sel = live & (shard_of == s)
        cnt = int(sel.sum())
        c_row[s, :cnt] = coo_row[sel] - starts[s]
        c_col[s, :cnt] = np.asarray(coo_col)[sel]
        c_val[s, :cnt] = np.asarray(coo_val)[sel]
    row_starts = starts.astype(np.int32)

    def phase_a(actor_l, seq_l, slot_l, bnd_l, del_l, val_l, base_l,
                start_l, cr, cc, cv):
        """One shard's resolve: its rows' winners in global row ids and
        its per-object visibility and touched contributions."""
        actor32 = actor_l[0].to(_I32)
        seq32 = seq_l[0].to(_I32)
        bnd = bnd_l[0]
        val = val_l[0]
        seg_id = base_l[0] + torch.cumsum(bnd.to(_I32), 0, dtype=_I32) - 1
        seg_id = torch.clamp(seg_id, min=0)       # padding-only prefixes
        nl = actor32.shape[0]
        dev = actor32.device
        # row nl is the sink of the padded COO triples (mode='drop')
        clock = torch.zeros((nl + 1, a_pad), dtype=_I32, device=dev)
        clock[torch.arange(nl, device=dev), actor32.to(torch.int64)] = \
            seq32 - 1
        crow = cr[0].to(torch.int64)
        crow = torch.where((crow >= 0) & (crow < nl), crow, nl)
        clock[crow, cc[0].to(torch.int64)] = cv[0].to(_I32)
        out = _resolve(seg_id, actor32, seq32, clock[:nl], del_l[0], val,
                       num_segments)
        # winner ids are LOCAL row indexes; lift to global coordinates
        winner = torch.where(out['winner'] >= 0,
                             out['winner'] + start_l[0], -1).to(_I32)
        flat = torch.where(slot_l[0] >= 0, slot_l[0], K * m) \
            .to(torch.int64)
        vis_hit = _scatter_max_flags(K * m, flat, out['surviving'])
        touched = _scatter_max_flags(K * m, flat, val)
        return out['surviving'], winner, vis_hit, touched

    placed = shard_docs(mesh, s_actor_r, s_seq_r, s_slot_r, s_bnd_r,
                        s_del_r, s_val_r, seg_base, row_starts, c_row,
                        c_col, c_val)
    per_shard = [phase_a(*args) for args in zip(*placed)]
    winner = pmax([p[1] for p in per_shard])[0]
    vis_hit = pmax([p[2] for p in per_shard])[0].bool()
    touched = pmax([p[3] for p in per_shard])[0].bool()

    # reassemble the row-sharded survivors into flat row order
    surviving_flat = np.zeros(n, bool)
    for s, (lo, hi) in enumerate(zip(starts, ends)):
        surviving_flat[lo:hi] = per_shard[s][0].cpu().numpy()[:hi - lo]

    s_parent, s_elem, s_actor = (np.asarray(seq_planes[0]),
                                 np.asarray(seq_planes[1]),
                                 np.asarray(seq_planes[2]))
    s_valid = (np.arange(m, dtype=np.int32)[None, :]
               < np.asarray(seq_nj)[:, None])
    visible = (np.where(
        touched.cpu().numpy().reshape(K, m),
        vis_hit.cpu().numpy().reshape(K, m),
        np.asarray(seq_prior_vis).astype(bool)) & s_valid).astype(bool)
    ordered, _ = sharded_rga_jobs(
        mesh, s_parent.astype(np.int32), s_elem.astype(np.int32),
        s_actor.astype(np.int32), visible, s_valid)
    return {'surviving': surviving_flat,
            'winner': winner.cpu().numpy(),
            'visible': visible,
            'vis_index': ordered['vis_index'].cpu().numpy()}


def fleet_rollup(mesh, per_shard):
    """Cross-shard fleet-statistic reduction: ``per_shard`` is an
    ``[S, k]`` matrix of per-shard stat vectors (doc counts, dirty
    totals, byte estimates, digest-valid flags — whatever the caller
    stacks); the return is the length-``k`` fleet total.

    Over a multi-entry mesh the reduction runs per entry and combines
    with :func:`~.mesh.psum` — the collective form of the rollup
    ``ShardedGeneralDocSet.fleet_status()`` serves. On a single device
    it degrades to the numerically identical numpy sum. Values ride as
    int64 host-side; the device path sums int32 lanes (as the
    reference's, whose JAX x64 is off), which bounds each STAT at 2 GiB
    per shard — callers with wider values keep the numpy path."""
    arr = np.asarray(per_shard, np.int64)
    if arr.ndim != 2:
        raise ValueError('per_shard must be [n_shards, k]')
    n_dev = 0 if mesh is None else mesh.devices.size
    if n_dev <= 1 or (np.abs(arr) >= 2**31).any():
        return arr.sum(axis=0)
    s = arr.shape[0]
    s_pad = -(-max(s, 1) // n_dev) * n_dev
    padded = np.zeros((s_pad, arr.shape[1]), np.int32)
    padded[:s] = arr
    parts = [t.sum(dim=0, dtype=_I32) for t in shard_docs(mesh, padded)]
    return np.asarray(psum(parts)[0].cpu().numpy(), np.int64)


def sharded_fleet_order(mesh, shard_jobs):
    """The BATCHED-apply ordering entry for a sharded fleet: every
    shard's dirty-object job planes (``(parent, elem, actor, visible,
    valid)`` per shard, each ``[k_i, m_i]``) pack into one job plane
    with the job axis aligned so each mesh entry orders one shard's
    jobs, then ONE :func:`sharded_rga_jobs` pass runs the RGA order
    for the whole fleet with psum'd fleet stats.

    Returns ``(per-shard output list, stats)`` where each output dict
    (numpy arrays) slices back to that shard's real jobs —
    bit-identical to running the RGA order per shard."""
    n_shards = len(shard_jobs)
    if n_shards == 0:
        return [], {'visible_total': 0, 'jobs': 0}
    ks = [max(p[0].shape[0], 1) for p in shard_jobs]
    ms = [p[0].shape[1] if p[0].ndim == 2 else 1 for p in shard_jobs]
    k_align = max(ks)
    m = max(max(ms), 1)

    def pack(field, fill=0, head_valid=False):
        out = np.full((n_shards * k_align, m), fill,
                      np.asarray(shard_jobs[0][field]).dtype
                      if shard_jobs else np.int32)
        if head_valid:
            out[:, :] = 0
            out[:, 0] = 1              # padded jobs: lone valid head
        for s, planes in enumerate(shard_jobs):
            a = np.asarray(planes[field])
            if a.ndim == 1:
                a = a[:, None]
            out[s * k_align:s * k_align + a.shape[0], :a.shape[1]] = a
        return out

    parent = pack(0).astype(np.int32)
    elem = pack(1).astype(np.int32)
    actor = pack(2).astype(np.int32)
    visible = pack(3).astype(bool)
    valid = pack(4, head_valid=True).astype(bool)
    out, stats = sharded_rga_jobs(mesh, parent, elem, actor, visible,
                                  valid)
    out = {name: arr.cpu().numpy() for name, arr in out.items()}
    per_shard = []
    for s, planes in enumerate(shard_jobs):
        k_s, m_s = np.asarray(planes[0]).shape
        per_shard.append({
            name: arr[s * k_align:s * k_align + k_s][..., :m_s]
            if arr.ndim == 2 else arr[s * k_align:s * k_align + k_s]
            for name, arr in out.items()})
    return per_shard, stats


def sharded_rga_jobs(mesh, parent, elem, actor, visible, valid):
    """Order a batch of insertion trees with the job axis sharded over
    `mesh`. Pads the job axis to the mesh size; padded jobs are a lone
    valid head node and order to nothing.

    Returns (rga outputs for the REAL jobs — int32 tensors gathered
    onto the mesh's first device —, stats as Python ints).
    """
    n_dev = mesh.devices.size
    arrays = [np.asarray(a) if not isinstance(a, torch.Tensor)
              else a.cpu().numpy()
              for a in (parent, elem, actor, visible, valid)]
    k = arrays[0].shape[0]
    k_pad = -(-max(k, 1) // n_dev) * n_dev
    if k_pad != k:
        def pad_jobs(a, head_valid=False):
            out = np.zeros((k_pad,) + a.shape[1:], a.dtype)
            out[:k] = a
            if head_valid:
                out[k:, 0] = 1       # node 0 valid (a lone head)
            return out
        arrays = [pad_jobs(a) for a in arrays[:4]] + \
            [pad_jobs(arrays[4].astype(bool), head_valid=True)]
    placed = shard_docs(mesh, *arrays)
    outs, partials = [], []
    for args in zip(*placed):
        o, st = _rga_body(*args)
        outs.append(o)
        partials.append(st)
    out = {name: all_gather([o[name] for o in outs], tiled=True)[0][:k]
           for name in ('tree_pos', 'vis_index', 'node_at_pos', 'length')}
    stats = {name: int(psum([p[i] for p in partials])[0])
             for i, name in enumerate(('visible_total', 'jobs'))}
    return out, stats


def sharded_step_from_capture(mesh, store, patch, captured):
    """Re-run a captured general apply through the sharded step and
    return (sharded outputs, fused reference outputs) for equality
    gating.

    `captured` is the dict the engine hands to
    ``general._STAGE_CAPTURE`` (staged wire planes + the fused
    program's outputs, whichever variant ran); the job planes rebuild
    HOST-side from the pool, whose host visibility columns are still
    the PRE-apply state (the mirror has not been synced).
    """
    from ..device import general
    from ..device.blocks import _span_indices

    def host(t):
        return t.cpu().numpy()

    ops_slot = captured['ops_slot']
    n_pad = len(ops_slot)
    bits = np.unpackbits(captured['flags_u8'])
    bnd = bits[:n_pad].astype(bool)
    isdel = bits[n_pad:2 * n_pad].astype(bool)
    vmask = np.arange(n_pad) < int(captured['n_rows'])

    raw = patch._raw
    dirty, n_j = raw['dirty'], raw['dirty_n']
    rows_flat = raw['rows_flat']()   # lazy node-row gather
    mj = captured['m_pad']
    Kj = max(len(dirty), 1)
    pool = store.pool
    seq_planes = np.zeros((3, Kj, mj), np.int32)
    prior_vis = np.zeros((Kj, mj), bool)
    if len(dirty):
        flat = _span_indices(np.arange(Kj, dtype=np.int64) * mj, n_j)
        seq_planes[0].reshape(-1)[flat] = pool.parent[rows_flat]
        seq_planes[1].reshape(-1)[flat] = pool.elemc[rows_flat]
        ranks = np.zeros(len(rows_flat), np.int64)
        real = pool.actor[rows_flat] >= 0
        ranks[real] = store.actor_str_ranks()[pool.actor[rows_flat][real]]
        seq_planes[2].reshape(-1)[flat] = ranks
        prior_vis.reshape(-1)[flat] = pool.visible[rows_flat]
    n_j_arr = np.zeros(Kj, np.int32)
    n_j_arr[:len(n_j)] = n_j

    sharded = sharded_general_step(
        mesh, captured['ops_actor'], captured['ops_seq'], ops_slot,
        bnd, isdel, vmask, captured['coo_row'], captured['coo_col'],
        captured['coo_val'], seq_planes, n_j_arr, prior_vis,
        num_segments=captured['num_segments'],
        a_pad=captured['a_pad'])

    if captured['vis_planes'] is None:     # no dirty sequence objects
        vis_ref = np.zeros((Kj, mj), bool)
        idx_ref = np.full((Kj, mj), -1, np.int64)
    elif captured['vis_fmt'] == 'packed':
        _, vis_ref, _, idx_ref = general.unpack_vis_word(
            host(captured['vis_planes']).view(np.uint32))
    elif captured['vis_fmt'] == 'wide':
        vis_ref, idx_ref = general.unpack_wide_word(
            host(captured['vis_planes'][1]))
    else:
        pl = [host(x) for x in captured['vis_planes']]
        vis_ref, idx_ref = pl[1], pl[3].astype(np.int64)
    fused = {
        'surviving': np.unpackbits(
            host(captured['surv_u8'])).astype(bool)[:n_pad],
        'winner': host(captured['winner']),
        # the fused planes carry the BUCKETED job axis (padding jobs
        # are all-masked rows); the equality gate compares real jobs
        'visible': np.asarray(vis_ref)[:Kj],
        'vis_index': np.asarray(idx_ref, np.int64)[:Kj],
    }
    sharded['vis_index'] = np.asarray(sharded['vis_index'], np.int64)
    return sharded, fused
