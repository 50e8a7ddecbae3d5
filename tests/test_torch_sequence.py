"""RGA ordering: the PyTorch port's ``_rga_order`` / ``_rga_order_batched``
against the JAX package's on numpy-seeded insertion trees, at every
plane width where the JAX package picks a different variant (bf16
one-hot up to m = 257, f32 one-hot up to 512, gathers above) — the
port uses direct gathers at every width. vis_index, node_at_pos and
length must match on all rows (dtypes included), tree_pos on valid
rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.device import sequence as js
from automerge_tpu_torch.device import sequence as ts

torch.set_num_threads(1)


def _trees(rng, K, m, full_row=True):
    """[K, m] job planes: row k holds a random insertion tree of n_k
    valid nodes (node 0 the head; every node's parent is an earlier
    node), random Lamport counters (ties among siblings included) and
    actor ranks, random tombstones; padding rows beyond n_k. The first
    row is full when ``full_row``; one row is empty padding."""
    parent = np.zeros((K, m), np.int32)
    elem = np.zeros((K, m), np.int32)
    actor = np.zeros((K, m), np.int32)
    visible = np.zeros((K, m), bool)
    valid = np.zeros((K, m), bool)
    for k in range(K):
        n = m if (k == 0 and full_row) else \
            0 if k == K - 1 else int(rng.integers(1, m + 1))
        if n == 0:
            continue
        valid[k, :n] = True
        if n > 1:
            # mostly chains (typing) with random branches
            chain = np.arange(n - 1)
            jump = (rng.random(n - 1) * np.arange(1, n)).astype(np.int32)
            parent[k, 1:n] = np.where(rng.random(n - 1) < 0.6, chain, jump)
        elem[k, 1:n] = rng.integers(1, max(n // 2, 2), n - 1)
        actor[k, 1:n] = rng.integers(0, 4, n - 1)
        visible[k, 1:n] = rng.random(n - 1) < 0.7
    return parent, elem, actor, visible, valid


def _check(jout, tout, valid):
    for k in ('vis_index', 'node_at_pos', 'length'):
        a = np.asarray(jout[k])
        b = tout[k].numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), k
    a = np.asarray(jout['tree_pos'])
    b = tout['tree_pos'].numpy()
    assert a.dtype == b.dtype
    assert np.array_equal(a[valid], b[valid]), 'tree_pos'


@pytest.mark.parametrize('seed', range(2))
@pytest.mark.parametrize('K,m', [(6, 16), (4, 257), (3, 300), (2, 600)])
def test_rga_order_batched_matches_jax(seed, K, m):
    rng = np.random.default_rng(1000 * m + seed)
    planes = _trees(rng, K, m)
    jout = js.rga_order_batch(*[jnp.asarray(p) for p in planes])
    tout = ts._rga_order_batched(*[torch.as_tensor(p) for p in planes])
    _check(jout, tout, planes[4])


@pytest.mark.parametrize('m', [9, 130])
def test_rga_order_single_tree_matches_jax(m):
    rng = np.random.default_rng(m)
    planes = [p[0] for p in _trees(rng, 1, m)]
    jout = js.rga_order(*[jnp.asarray(p) for p in planes])
    tout = ts.rga_order(*[torch.as_tensor(p) for p in planes])
    _check(jout, tout, planes[4])


def test_stable_lexsort_matches_jnp_lexsort():
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, 3, (4, 50)).astype(np.int64) for _ in range(3)]
    want = np.stack([np.asarray(jnp.lexsort([jnp.asarray(k[r])
                                             for k in keys]))
                     for r in range(4)])
    got = ts._stable_lexsort([torch.as_tensor(k) for k in keys]).numpy()
    assert np.array_equal(want, got)
    # jnp.lexsort is the stable numpy lexsort
    assert np.array_equal(want[0], np.lexsort([k[0] for k in keys]))


@pytest.mark.parametrize('K,m', [(6, 9), (5, 33), (4, 129), (2, 513)])
def test_rga_delta_order_matches_jax(K, m):
    """The delta orderer's plain version (the CPU path of
    ``_rga_delta_order_batched``) against the JAX package's on seeded
    delta forests: anchors up to 2^22 - 1, elems past 2^15, ties, and
    padding rows with garbage parents; tree_pos on valid rows."""
    from chip_smoke import delta_forests
    planes = delta_forests(np.random.default_rng(7 * m + K), K, m)
    want = np.asarray(js._rga_delta_order_batched(
        *[jnp.asarray(p) for p in planes]))
    got = ts._rga_delta_order_batched(*[torch.as_tensor(p)
                                        for p in planes]).numpy()
    valid = planes[4]
    assert want.dtype == got.dtype
    assert np.array_equal(want[valid], got[valid])


class _ArrayLike:
    """An array that is neither a tensor nor a numpy array: it has only
    ``__array__``."""

    def __init__(self, a):
        self._a = a

    def __array__(self, dtype=None, copy=None):
        return self._a if dtype is None else self._a.astype(dtype)


def _same_tensors(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].device == want[k].device, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize('wrap', [np.asarray, _ArrayLike, jnp.asarray],
                         ids=['numpy', 'array-like', 'jax'])
def test_rga_order_takes_any_array(wrap):
    """``rga_order`` and ``rga_order_batch`` take numpy arrays and any
    other array, as the reference's take any array, and give what CPU
    tensors of the same planes give (int32 outputs, on the host)."""
    planes = _trees(np.random.default_rng(21), 4, 33)
    want = ts.rga_order_batch(*map(torch.as_tensor, planes))
    _same_tensors(ts.rga_order_batch(*map(wrap, planes)), want)
    want1 = ts.rga_order(*(torch.as_tensor(p[0]) for p in planes))
    _same_tensors(ts.rga_order(*(wrap(p[0]) for p in planes)), want1)
    assert want1['vis_index'].dtype == torch.int32
