"""Field resolution: the PyTorch port's merge functions against the JAX
package's on the same numpy-seeded inputs — exact equality, dtypes
included. Covers padding rows, empty segments, deletes and same-change
actor ties (several assignments of one change to one field)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.device import merge as jm
from automerge_tpu_torch.device import merge as tm

torch.set_num_threads(1)

# jitted once per shape: one compile instead of one per eager op
_J_RESOLVE = jax.jit(jm._resolve, static_argnums=6)
_J_RESOLVE_SORTED = jax.jit(jm._resolve_sorted, static_argnums=6)


def _rows(rng, n, n_valid, S, A, sorted_segs):
    """Seeded resolve inputs. Segment ids leave some segments empty;
    actor ties within a segment share a seq (one change's double
    assignment); closure clocks supersede some rows."""
    seg = rng.integers(0, max(S - 2, 1), n).astype(np.int32)
    if sorted_segs:
        seg = np.sort(seg)
    actor = rng.integers(0, A, n).astype(np.int32)
    seq = rng.integers(1, 6, n).astype(np.int32)
    # same-change ties: copy (actor, seq) onto a neighbour in the segment
    tie = rng.random(n) < 0.2
    tie[0] = False
    actor[tie] = actor[np.flatnonzero(tie) - 1]
    seq[tie] = seq[np.flatnonzero(tie) - 1]
    clock = rng.integers(0, 6, (n, A)).astype(np.int32)
    clock[np.arange(n), actor] = seq - 1
    is_del = rng.random(n) < 0.15
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return seg, actor, seq, clock, is_del, valid


def _same(jout, tout):
    for k in ('surviving', 'winner', 'seg_max_actor'):
        a = np.asarray(jout[k])
        b = tout[k].numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.array_equal(a, b), k


def _to_j(*xs):
    return [jnp.asarray(x) for x in xs]


def _to_t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('n,n_valid,S,A', [(8, 8, 4, 2), (64, 50, 16, 4),
                                           (128, 97, 40, 8)])
def test_resolve_matches_jax(seed, n, n_valid, S, A):
    rng = np.random.default_rng(seed)
    args = _rows(rng, n, n_valid, S, A, sorted_segs=False)
    jout = _J_RESOLVE(*_to_j(*args), S)
    tout = tm._resolve(*_to_t(*args), S)
    _same(jout, tout)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('n,n_valid,S,A', [(8, 8, 8, 2), (64, 50, 64, 4),
                                           (128, 97, 128, 8)])
def test_resolve_sorted_matches_jax(seed, n, n_valid, S, A):
    rng = np.random.default_rng(100 + seed)
    seg, actor, seq, clock, is_del, valid = _rows(rng, n, n_valid, S, A,
                                                  sorted_segs=True)
    boundary = np.ones(n, bool)
    boundary[1:] = seg[1:] != seg[:-1]
    boundary[n_valid:] = False               # padding joins the last one
    args = (boundary, actor, seq, clock, is_del, valid)
    jout = _J_RESOLVE_SORTED(*_to_j(*args), S)
    tout = tm._resolve_sorted(*_to_t(*args), S)
    _same(jout, tout)


def test_resolve_sorted_without_rows_and_fewer_segments():
    """No valid rows (no boundary at all), and more boundaries than
    segment slots (the extras are dropped)."""
    rng = np.random.default_rng(9)
    _, actor, seq, clock, is_del, _ = _rows(rng, 16, 16, 8, 4, True)
    for boundary, valid, S in (
            (np.zeros(16, bool), np.zeros(16, bool), 8),
            (np.ones(16, bool), np.ones(16, bool), 5)):
        args = (boundary, actor, seq, clock, is_del, valid)
        _same(_J_RESOLVE_SORTED(*_to_j(*args), S),
              tm._resolve_sorted(*_to_t(*args), S))


@pytest.mark.parametrize('seed', range(3))
def test_resolve_assignments_batch_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    D, n, S, A = 5, 32, 12, 4
    cols = [_rows(rng, n, int(rng.integers(0, n + 1)), S, A, False)
            for _ in range(D)]
    args = [np.stack([c[i] for c in cols]) for i in range(6)]
    jout = jm.resolve_assignments_batch(*_to_j(*args), num_segments=S)
    tout = tm.resolve_assignments_batch(*_to_t(*args), num_segments=S)
    _same(jout, tout)
    # and the single-document entry point
    jout1 = jm.resolve_assignments(*_to_j(*[a[0] for a in args]),
                                   num_segments=S)
    tout1 = tm.resolve_assignments(*_to_t(*[a[0] for a in args]),
                                   num_segments=S)
    _same(jout1, tout1)


@pytest.mark.parametrize('cols', [None, 3])
def test_segmented_scans_match_jax(cols):
    rng = np.random.default_rng(5)
    n = 40
    flags = rng.random(n) < 0.3
    shape = (n,) if cols is None else (n, cols)
    vals = rng.integers(-5, 50, shape).astype(np.int32)
    f_j, v_j = jnp.asarray(flags), jnp.asarray(vals)
    f_t, v_t = torch.as_tensor(flags), torch.as_tensor(vals)
    b_j = jnp.broadcast_to(f_j[:, None], vals.shape) if cols else f_j
    b_t = f_t[:, None].expand(vals.shape) if cols else f_t
    a = np.asarray(jax.jit(jm._seg_scan_max)(b_j, v_j))
    b = tm._seg_scan_max(b_t, v_t).numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)
    a = np.asarray(jax.jit(jm._seg_row_max)(f_j, v_j))
    b = tm._seg_row_max(f_t, v_t).numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)


class _ArrayLike:
    """An array that is neither a tensor nor a numpy array: it has only
    ``__array__``."""

    def __init__(self, a):
        self._a = np.asarray(a)

    def __array__(self, dtype=None, copy=None):
        return self._a if dtype is None else self._a.astype(dtype)


def _same_tensors(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same_tensors(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)


_WRAPS = pytest.mark.parametrize('wrap', [np.asarray, _ArrayLike,
                                          jnp.asarray],
                                 ids=['numpy', 'array-like', 'jax'])


@_WRAPS
def test_resolve_assignments_take_any_array(wrap):
    """``resolve_assignments[_batch]`` take numpy arrays and any other
    array, as the reference's do, and give what CPU tensors of the same
    rows give (bool and int32 outputs, on the host)."""
    rng = np.random.default_rng(300)
    D, n, S, A = 3, 32, 12, 4
    cols = [_rows(rng, n, int(rng.integers(1, n + 1)), S, A, False)
            for _ in range(D)]
    args = [np.stack([c[i] for c in cols]) for i in range(6)]
    want = tm.resolve_assignments_batch(*_to_t(*args), num_segments=S)
    _same_tensors(tm.resolve_assignments_batch(
        *map(wrap, args), num_segments=S), want)
    want1 = tm.resolve_assignments(*_to_t(*cols[0]), num_segments=S)
    _same_tensors(tm.resolve_assignments(*map(wrap, cols[0]),
                                         num_segments=S), want1)
    assert want1['surviving'].dtype == torch.bool
    assert want1['winner'].dtype == torch.int32


@_WRAPS
def test_clock_functions_take_any_array(wrap):
    """``less_or_equal``, ``union``, ``causally_ready`` and ``advance``
    (``device/clock.py``) take numpy arrays and any other array, as the
    reference's do, and give what CPU tensors give (bool and int32
    outputs); the values are the JAX package's."""
    from automerge_tpu.device import clock as jc
    from automerge_tpu_torch.device import clock as tc
    rng = np.random.default_rng(301)
    C, A = 12, 5
    doc_clock = rng.integers(0, 4, A).astype(np.int32)
    deps = rng.integers(0, 4, (C, A)).astype(np.int32)
    actor = rng.integers(0, A, C).astype(np.int32)
    seq = rng.integers(1, 6, C).astype(np.int32)
    other = rng.integers(0, 4, (C, A)).astype(np.int32)
    ready = tc.causally_ready(*_to_t(doc_clock, deps, actor, seq))
    cases = [
        (tc.less_or_equal, jc.less_or_equal, (deps, doc_clock)),
        (tc.union, jc.union, (deps, other)),
        (tc.causally_ready, jc.causally_ready, (doc_clock, deps, actor,
                                                seq)),
        (tc.advance, jc.advance, (doc_clock, actor, seq,
                                  ready.numpy()))]
    for port, ref, args in cases:
        want = port(*_to_t(*args))
        got = port(*map(wrap, args))
        _same_tensors(got, want)
        assert np.array_equal(np.asarray(ref(*_to_j(*args))), want.numpy())
        assert np.asarray(ref(*_to_j(*args))).dtype == want.numpy().dtype
