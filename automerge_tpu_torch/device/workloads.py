"""Synthetic device-kernel workload generators (shared by
``chip_smoke.py`` and the tests).

The PyTorch port's copy of ``automerge_tpu/device/workloads.py``: for
one seed both give identical arrays (and identical change blocks).

The merge kernels assume causal delivery, which the generator encodes as
an invariant: each op's clock row covers exactly its own actor's prior ops
(``clock[i, actor_i] = seq_i - 1``), optionally plus a causally-consistent
prefix of other actors' ops. Keeping the construction in one place keeps
the smoke run and the kernel differential tests on the same op
distribution.
"""

import numpy as np


def gen_docset_workload(n_docs=10240, n_ops=128, n_actors=8, n_keys=32,
                        seed=0, del_p=0.05, invalid_p=0.0, cross_clock=False):
    """A DocSet batch: per doc, ``n_ops`` concurrent 'set' ops from
    ``n_actors`` actors spread over ``n_keys`` root fields.

    Each actor's ops are sequential for itself and (by default) fully
    concurrent across actors — the worst case for conflict resolution.
    With ``cross_clock`` some ops additionally cover a prefix of other
    actors' ops, exercising supersession.

    Returns (seg_id, actor, seq, clock, is_del, valid) numpy arrays with
    shapes [D,N] / [D,N,A].
    """
    rng = np.random.default_rng(seed)
    seg_id = rng.integers(0, n_keys, size=(n_docs, n_ops)).astype(np.int32)
    actor = rng.integers(0, n_actors, size=(n_docs, n_ops)).astype(np.int32)
    # validity is drawn BEFORE seq/clock construction so that both count
    # only ops that exist — clocks never reference masked-out (phantom) ops
    valid = rng.random((n_docs, n_ops)) >= invalid_p
    # seq numbers: per (doc, actor) running count of VALID ops in op order
    seq = np.ones((n_docs, n_ops), dtype=np.int32)
    for a in range(n_actors):
        mask = actor == a
        running = np.cumsum(mask & valid, axis=1)
        seq[mask] = running[mask]
    seq = np.maximum(seq, 1)  # invalid ops before an actor's first valid op
    clock = np.zeros((n_docs, n_ops, n_actors), dtype=np.int32)
    d_idx, o_idx = np.indices((n_docs, n_ops))
    if cross_clock:
        # Causally valid cross-actor coverage via knowledge frontiers: op i
        # (column o) covers every valid op in columns < f_i, with f_i drawn
        # in [f_prev_own, o] (monotone per actor). Monotonicity makes the
        # clocks transitively closed — if i covers j then f_i > o_j >= f_j,
        # so i covers everything j covers — and counts tally only valid
        # ops, so no phantom dependencies exist even with invalid_p > 0.
        onehot = np.zeros((n_docs, n_ops, n_actors), dtype=np.int32)
        onehot[d_idx, o_idx, actor] = valid.astype(np.int32)
        # counts[d, o, b] = number of valid b-ops in columns < o
        counts = np.zeros((n_docs, n_ops + 1, n_actors), dtype=np.int32)
        counts[:, 1:] = np.cumsum(onehot, axis=1)
        f_prev = np.zeros((n_docs, n_actors), dtype=np.int64)
        docs = np.arange(n_docs)
        for o in range(n_ops):
            a = actor[:, o]
            lo = f_prev[docs, a]
            f = lo + (rng.random(n_docs) * (o - lo + 1)).astype(np.int64)
            f_prev[docs, a] = f
            clock[:, o, :] = counts[docs, f, :]
    clock[d_idx, o_idx, actor] = seq - 1
    is_del = rng.random((n_docs, n_ops)) < del_p
    return seg_id, actor, seq, clock, is_del, valid


def gen_block_workload(n_docs=10240, n_actors=10, ops_per_change=10,
                       n_keys=40, seed=0, del_p=0.0, seq0=1):
    """The BASELINE config-5 workload as wire changes: a ChangeBlock with
    one change per (doc, actor), all cross-actor concurrent (seq =
    ``seq0``, empty deps), each change carrying ``ops_per_change`` set
    ops on distinct root keys. ``seq0`` > 1 produces the k-th block of a
    STREAM of such batches (each actor's chain advancing one seq per
    block) — apply blocks seq0=1..k in order.

    Total ops = n_docs * n_actors * ops_per_change. With the defaults this
    is the 1M-op / 10k-doc north-star shape, expressed in the columnar
    wire encoding (the JSON dict encoding of the same changes is
    ``block.to_changes()``).
    """
    from .blocks import ChangeBlock
    rng = np.random.default_rng(seed)
    n_changes = n_docs * n_actors
    n_ops = n_changes * ops_per_change
    doc = np.repeat(np.arange(n_docs, dtype=np.int32), n_actors)
    actor = np.tile(np.arange(n_actors, dtype=np.int32), n_docs)
    seq = np.full(n_changes, seq0, np.int32)
    dep_ptr = np.zeros(n_changes + 1, np.int32)
    op_ptr = np.arange(n_changes + 1, dtype=np.int32) * ops_per_change
    # distinct keys per change (first ops_per_change of a random key perm)
    key = rng.random((n_changes, n_keys)).argsort(axis=1) \
        [:, :ops_per_change].astype(np.int32).ravel()
    action = (rng.random(n_ops) < del_p).astype(np.int8)
    value = np.where(action == 0, np.arange(n_ops, dtype=np.int32), -1)
    values = rng.integers(0, 1 << 20, n_ops).tolist()
    z32 = np.zeros(0, np.int32)
    return ChangeBlock(
        n_docs, doc, actor, seq, dep_ptr, z32, z32, op_ptr, action,
        key, value.astype(np.int32),
        [f'peer-{i:03d}' for i in range(n_actors)],
        [f'field{i:02d}' for i in range(n_keys)], values,
        dup_keys=False)          # keys are distinct per change by draw
