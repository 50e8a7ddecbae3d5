"""Batched map-field conflict resolution (PyTorch).

The port of ``automerge_tpu/device/merge.py``: every assignment op
touching a document (new ops plus the prior surviving field state) is
resolved in one shot with segment reductions, replacing the reference's
per-op assignment loop (`applyAssign`, op_set.js:180-219).

Semantics (equivalent to the sequential reference loop under causal
delivery):

* An op is **superseded** iff some other op on the same (obj, key)
  causally follows it: ``superseded[i] = (max_{j in segment}
  clock_j[actor_i]) >= seq_i``. An op's own clock row never includes
  itself (clock_i[actor_i] = seq_i - 1), so self-comparison is harmless.
* Surviving non-delete ops form the field's op set; the **winner** is
  the op with the highest actor rank (op_set.js:211), ties (several
  assignments within ONE change) to the LOWEST op index.

The JAX package reduces segments with ``segment_max`` (unsorted rows)
and with forward + backward associative scans (field-sorted rows). Here
both are a ``scatter_reduce(amax)`` into one slot per segment followed
by a gather back to the rows — row for row the same maxima, and
deterministic on CUDA (max is order-free). Every scatter whose target
the reference drops (``mode='drop'``) lands in a sink slot that is
sliced off. Integer dtypes are pinned to int32 throughout (torch widens
``cumsum`` of bool/int32 to int64).
"""

import torch

from ..config import as_tensor

_I32 = torch.int32
_INT32_MIN = -(1 << 31)


def _seg_max(idx, vals, n_seg, fill):
    """[n_seg] (or [n_seg, C]) max of ``vals`` per segment id ``idx``
    (each id in [0, n_seg)); segments without rows hold ``fill``."""
    if vals.dim() == 1:
        out = torch.full((n_seg,), fill, dtype=vals.dtype,
                         device=vals.device)
        return out.scatter_reduce(0, idx, vals, 'amax', include_self=True)
    out = torch.full((n_seg, vals.shape[1]), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(
        0, idx[:, None].expand(-1, vals.shape[1]), vals, 'amax',
        include_self=True)


def _seg_slots(seg_id, S):
    """(scatter target, gather index) per row for segment ids against S
    segments: an id outside [0, S) scatters into the sink slot S (the
    reference's ``segment_max`` drops it) and gathers the way a jnp
    index does (negative ids wrap once, then clamp into range)."""
    seg_id = seg_id.to(torch.int64)
    in_rng = (seg_id >= 0) & (seg_id < S)
    tgt = torch.where(in_rng, seg_id, torch.full_like(seg_id, S))
    g = torch.where(seg_id < 0, seg_id + S, seg_id).clamp(0, S - 1)
    return tgt, g


def _resolve_core(tgt, g, n_slots, S_of, actor, seq, clock, is_del,
                  valid, n):
    """Shared body of `_resolve` and its batch form: ``tgt`` scatters
    each row into one of ``n_slots`` segment slots, ``g`` gathers each
    row's segment back; ``n`` is the per-document row count that the
    winner's negated index is measured against."""
    actor = actor.to(_I32)
    seq = seq.to(_I32)
    clock = clock.to(_I32)
    valid = valid.to(torch.bool)
    is_del = is_del.to(torch.bool)
    dev = actor.device
    masked_clock = torch.where(valid[:, None], clock,
                               torch.full((), -1, dtype=_I32, device=dev))
    seg_clock_max = _seg_max(tgt, masked_clock, n_slots, _INT32_MIN)
    a_idx = actor.to(torch.int64).clamp(0, clock.shape[1] - 1)
    seen = torch.gather(seg_clock_max[g], 1, a_idx[:, None])[:, 0]
    superseded = seen >= seq
    surviving = valid & ~superseded & ~is_del

    actor_score = torch.where(surviving, actor, torch.full_like(actor, -1))
    seg_max_actor = _seg_max(tgt, actor_score, n_slots, _INT32_MIN)
    at_winner_actor = surviving & (actor == seg_max_actor[g])
    ar = S_of(torch.arange(actor.shape[0], dtype=_I32, device=dev))
    idx_score = torch.where(at_winner_actor, -ar,
                            torch.full_like(ar, -n - 1))
    neg_winner = _seg_max(tgt, idx_score, n_slots, _INT32_MIN)
    winner = torch.where(neg_winner < -n, torch.full_like(neg_winner, -1),
                         -neg_winner)
    return surviving, winner, seg_max_actor


def _resolve(seg_id, actor, seq, clock, is_del, valid, num_segments):
    """Unsorted rows: segment maxima over ``seg_id`` (ids outside
    [0, num_segments) are dropped, as ``jax.ops.segment_max`` does).
    Returns {'surviving' bool[N], 'winner' int32[S], 'seg_max_actor'
    int32[S]}; empty segments hold -1 / INT32_MIN. Takes tensors,
    numpy arrays or any other array (on the host), as the reference
    takes any array."""
    seg_id, actor, seq, clock, is_del, valid = map(
        as_tensor, (seg_id, actor, seq, clock, is_del, valid))
    n = actor.shape[0]
    S = num_segments
    tgt, g = _seg_slots(seg_id, S)
    surviving, winner, seg_max_actor = _resolve_core(
        tgt, g, S + 1, lambda r: r, actor, seq, clock, is_del, valid, n)
    return {'surviving': surviving, 'winner': winner[:S],
            'seg_max_actor': seg_max_actor[:S]}


def _seg_scan_max(flags, vals):
    """Inclusive SEGMENTED cummax along axis 0 (``flags[i]`` marks the
    first row of a segment; ``flags`` is [n] or the shape of ``vals``,
    as in the reference): per-row max over the rows of its segment
    up to and including itself. One ``torch.cummax`` over an int64 key
    whose high half is the segment number: segment ids never decrease,
    so a running max never carries across a segment start."""
    seg = torch.cumsum(flags.to(torch.int64), 0)
    v = vals.to(torch.int64)
    if v.dim() == 2 and seg.dim() == 1:
        seg = seg[:, None].expand_as(v)
    key = (seg << 32) + (v - _INT32_MIN)
    run = torch.cummax(key, dim=0).values
    return ((run & 0xFFFFFFFF) + _INT32_MIN).to(vals.dtype)


def _seg_row_max(boundary, vals):
    """Per-row max of ``vals`` over the row's whole (contiguous)
    segment (``vals`` is [n] or [n, C]): one scatter-max into a slot per
    segment, gathered back to the rows. Rows before the first boundary
    form their own segment, as in the reference's scans."""
    seg = torch.cumsum(boundary.to(torch.int64), 0)     # 0 = leading rows
    n_seg = int(boundary.shape[0]) + 1
    fill = torch.iinfo(vals.dtype).min
    smax = _seg_max(seg, vals, n_seg, fill)
    return smax[seg]


def _resolve_sorted(boundary, actor, seq, clock, is_del, valid,
                    num_segments):
    """`_resolve` for rows already SORTED by segment (the general
    engine's field-sorted staging): contiguous segments are marked by one
    boundary bit per row. Bit-identical to the JAX `_resolve_sorted`
    (same superseded rule, same actor-descending winner with min-index
    tie-break, [S] outputs materialized at the boundary rows)."""
    n = actor.shape[0]
    dev = actor.device
    boundary = boundary.to(torch.bool)
    actor = actor.to(_I32)
    seq = seq.to(_I32)
    valid = valid.to(torch.bool)
    is_del = is_del.to(torch.bool)
    seg = torch.cumsum(boundary.to(torch.int64), 0)     # 0 = leading rows

    masked_clock = torch.where(valid[:, None], clock.to(_I32),
                               torch.full((), -1, dtype=_I32, device=dev))
    seen_cols = _seg_row_max(boundary, masked_clock)          # [n, A]
    a_idx = actor.to(torch.int64).clamp(0, clock.shape[1] - 1)
    seen = torch.gather(seen_cols, 1, a_idx[:, None])[:, 0]
    superseded = seen >= seq
    surviving = valid & ~superseded & ~is_del

    # winner = surviving row with max actor rank, min row index on ties:
    # the lexicographic max of (actor, n-1-idx) over the segment
    idx = torch.arange(n, dtype=_I32, device=dev)
    a_score = torch.where(surviving, actor, torch.full_like(actor, -1))
    i_score = torch.where(surviving, (n - 1) - idx,
                          torch.full_like(idx, -1))
    seg_max_actor_row = _seg_row_max(boundary, a_score)
    best_i = _seg_row_max(boundary, torch.where(
        a_score == seg_max_actor_row, i_score, torch.full_like(i_score, -1)))
    winner_row = torch.where(seg_max_actor_row >= 0, (n - 1) - best_i,
                             torch.full_like(idx, -1))

    # [S] materialization: one scatter at the boundary rows (the sink
    # slot S takes every other row and out-of-range segment)
    S = num_segments
    seg_of = seg - 1
    tgt = torch.where(boundary & (seg_of < S), seg_of,
                      torch.full_like(seg_of, S))
    winner = torch.full((S + 1,), -1, dtype=_I32, device=dev)
    winner = winner.scatter(0, tgt, winner_row)[:S]
    seg_max_actor = torch.full((S + 1,), _INT32_MIN, dtype=_I32,
                               device=dev)
    seg_max_actor = seg_max_actor.scatter(0, tgt, seg_max_actor_row)[:S]
    return {'surviving': surviving, 'winner': winner,
            'seg_max_actor': seg_max_actor}


def resolve_assignments(seg_id, actor, seq, clock, is_del, valid, *,
                        num_segments):
    """Resolve a batch of assignment ops grouped by field.

    Args:
      seg_id: int32[N]    field group id per op (padding ops carry any
                          in-range seg_id with valid=False)
      actor:  int32[N]    actor rank per op (rank order == actor string order)
      seq:    int32[N]    change seq per op
      clock:  int32[N,A]  transitive-deps clock row per op
      is_del: bool[N]     deletion ops
      valid:  bool[N]     padding mask
      num_segments: segment count (>= max seg_id + 1)

    Returns dict of surviving bool[N], winner int32[S] (-1 if none) and
    seg_max_actor int32[S]. Takes any array, as :func:`_resolve` does.
    """
    return _resolve(seg_id, actor, seq, clock, is_del, valid,
                    num_segments)


def resolve_assignments_batch(seg_id, actor, seq, clock, is_del, valid, *,
                              num_segments):
    """A leading document axis written out: [D, N] rows and [D, N, A]
    clocks, each document's segments resolved independently (one flat
    reduction over ``D * (S + 1)`` slots — slot S of each document is
    its sink). Takes any array, as :func:`resolve_assignments` does."""
    seg_id, actor, seq, clock, is_del, valid = map(
        as_tensor, (seg_id, actor, seq, clock, is_del, valid))
    D, N = seg_id.shape
    S = num_segments
    dev = seg_id.device
    tgt, g = _seg_slots(seg_id, S)
    base = (torch.arange(D, device=dev, dtype=torch.int64)
            * (S + 1))[:, None]
    surviving, winner, seg_max_actor = _resolve_core(
        (tgt + base).reshape(-1), (g + base).reshape(-1), D * (S + 1),
        lambda r: r % N, actor.reshape(-1), seq.reshape(-1),
        clock.reshape(D * N, -1), is_del.reshape(-1), valid.reshape(-1),
        N)
    return {'surviving': surviving.reshape(D, N),
            'winner': winner.reshape(D, S + 1)[:, :S],
            'seg_max_actor': seg_max_actor.reshape(D, S + 1)[:, :S]}
