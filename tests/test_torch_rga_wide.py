"""The wide RGA kernel (one block a row, the child sort inside; rows past
``cuda_sequence.M_NARROW`` nodes that are not a few long ones) and what
it rests on. On the CPU: the plain versions it is held to
(``sequence._rga_order_plain`` and ``_rga_delta_order_plain``) against
the JAX package at 513-2,048 nodes on random, prepend, chain and
wide-key trees, on rows of a valid prefix and padding and on rows whose
valid node hangs under an invalid parent; the premise of its extent
(the plain version over a row's first E slots gives the padded row's
outputs); the dispatch and the shared-memory budget as pure functions.
On the card (``cuda``-marked; ``python -m pytest
tests/test_torch_rga_wide.py -m cuda``): the kernel against its plain
version, every output bit for bit (``tree_pos`` on valid rows), at the
same shapes, at the shared-memory edge and with each variant forced.
The JAX package is imported inside the tests that compare with it."""

import functools

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device import cuda_grid, cuda_sequence, sequence

from chip_smoke import TREES, delta_forests, wide_key_trees

torch.set_num_threads(1)

OUTS = ('tree_pos', 'vis_index', 'node_at_pos', 'length')
# wide-key trees need 64-bit and 128-bit sort keys
ALL_TREES = {**TREES, 'wide-key': wide_key_trees}


def orphan_trees(rng, K, m):
    """:func:`chip_smoke.random_trees` with one interior node of each row
    of more than three nodes made invalid: its children are valid nodes
    under an invalid parent, the rows the wide kernel works on at full
    width."""
    parent, elem, actor, visible, valid = TREES['random'](rng, K, m)
    valid = valid.copy()
    for k in range(K):
        nk = int(valid[k].sum())
        if nk > 3:
            valid[k, rng.integers(1, nk - 1)] = False
    return parent, elem, actor, visible & valid, valid


def padded_rows(rng, K, m, fill=None):
    """Rows of ``fill`` valid nodes (a valid prefix, random trees) padded
    to ``m`` slots, with garbage parents, elems and actors in the padding
    (the general engine pads every job row of a tick to its widest)."""
    fill = min(fill or max(2, m // 7), m)
    parent, elem, actor, visible, valid = TREES['random'](rng, K, fill)
    out = []
    for p, lo, hi in ((parent, -3, m + 3), (elem, -50, 50), (actor, -2, 9)):
        g = rng.integers(lo, hi, (K, m)).astype(np.int32)
        g[:, :fill] = p
        out.append(g)
    vis = np.zeros((K, m), bool)
    val = np.zeros((K, m), bool)
    vis[:, :fill] = visible
    val[:, :fill] = valid
    return out[0], out[1], out[2], vis, val


def _positions_unique(out, valid):
    """Rows whose chain positions are unique (no two on-chain nodes claim
    one position): where they are not, the scatter of ``node_at_pos`` has
    no defined winner in any version."""
    tp = np.asarray(out['tree_pos']).astype(np.int64)
    on = np.asarray(valid) & (tp > 0)
    rows = []
    for k in range(tp.shape[0]):
        t = tp[k][on[k]]
        rows.append(len(np.unique(t)) == len(t))
    return np.array(rows, bool)


def _same(got, want, valid, rows=None):
    """Every output bit for bit (``tree_pos`` on valid nodes); the other
    outputs only on ``rows`` where given."""
    valid = np.asarray(valid)
    for k in OUTS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if k == 'tree_pos':
            assert np.array_equal(a[valid], b[valid]), k
        elif rows is None:
            assert np.array_equal(a, b), k
        else:
            assert np.array_equal(a[rows], b[rows]), k


def _jax_rga(planes):
    import jax.numpy as jnp
    from automerge_tpu.device import sequence as js
    out = js.rga_order_batch(*(jnp.asarray(p) for p in planes))
    return {k: np.asarray(v) for k, v in out.items()}


def _plain(planes):
    out = sequence._rga_order_batched(*(torch.as_tensor(p) for p in planes))
    return {k: v.numpy() for k, v in out.items()}


def _jax_safe(planes):
    """Wide-key planes with INT32_MIN elems and actors moved up by one:
    the JAX package's descending keys negate int32 values, and
    -INT32_MIN wraps (the port's plain version negates in int64)."""
    lo = np.iinfo(np.int32).min
    return tuple(np.where(p == lo, lo + 1, p) if p.dtype == np.int32
                 and i in (1, 2) else p for i, p in enumerate(planes))


@pytest.mark.parametrize('tree', sorted(ALL_TREES))
@pytest.mark.parametrize('K,m', [(3, 513), (2, 2048)])
def test_plain_matches_jax_past_the_narrow_width(tree, K, m):
    """The CPU path of the dispatch (the plain version) against the JAX
    package's ``rga_order_batch`` at the wide kernel's widths; wide-key
    trees take 64-bit and 128-bit sort keys."""
    planes = ALL_TREES[tree](np.random.default_rng(K * 7 + m), K, m)
    if tree == 'wide-key':
        planes = _jax_safe(planes)
    _same(_plain(planes), _jax_rga(planes), planes[4])


@pytest.mark.parametrize('kind', ['padded', 'orphan'])
def test_plain_matches_jax_on_padded_and_orphan_rows(kind):
    """Rows of a valid prefix and garbage padding (the extent case), and
    rows whose valid node hangs under an invalid parent (the full-width
    case): ``tree_pos`` on valid nodes, the other outputs on every row
    whose chain positions are unique."""
    rng = np.random.default_rng(91 if kind == 'padded' else 92)
    planes = padded_rows(rng, 4, 1100) if kind == 'padded' else \
        orphan_trees(rng, 4, 777)
    want = _jax_rga(planes)
    got = _plain(planes)
    rows = _positions_unique(got, planes[4])
    assert rows.any()
    _same(got, want, planes[4], rows)
    ext = cuda_sequence.wide_extent(torch.as_tensor(planes[0]),
                                    torch.as_tensor(planes[4]))
    m = planes[0].shape[1]
    if kind == 'padded':
        assert (ext < m).all()
    else:
        assert (ext == m).any()


@functools.cache
def _jax_delta_order():
    import jax
    from automerge_tpu.device import sequence as js
    return jax.jit(js._rga_delta_order_batched)


@pytest.mark.parametrize('K,m', [(3, 600), (2, 2048)])
def test_delta_plain_matches_jax_past_the_narrow_width(K, m):
    """The delta orderer's plain version against the JAX package's at
    widths past ``M_NARROW`` (seeded delta forests, anchors up to
    2^22 - 1, garbage parents in the padding); tree_pos on valid rows."""
    import jax.numpy as jnp
    planes = delta_forests(np.random.default_rng(K + m), K, m)
    want = np.asarray(_jax_delta_order()(*[jnp.asarray(p) for p in planes]))
    got = sequence._rga_delta_order_batched(
        *[torch.as_tensor(p) for p in planes]).numpy()
    valid = planes[4]
    assert want.dtype == got.dtype
    assert np.array_equal(want[valid], got[valid])


def _extent_planes():
    """Rows for the extent premise: every tree kind, padded rows, and
    rows of a single node."""
    rng = np.random.default_rng(5)
    rows = [ALL_TREES[t](rng, 5, 640) for t in sorted(ALL_TREES)]
    rows.append(padded_rows(rng, 4, 640))
    rows.append(padded_rows(rng, 3, 640, fill=1))
    return rows


@pytest.mark.parametrize('i', range(6))
def test_plain_over_the_extent_is_the_padded_rows_order(i):
    """The premise of the wide kernel's extent: where every valid node's
    parent is the head or an earlier valid node, the plain version over
    a row's first E slots (E = ``wide_extent``) gives the padded row's
    tree_pos on valid nodes, vis_index and length, and its node_at_pos
    once the fill of its unfilled positions (E - 1) is widened to the
    padded row's (m - 1) and the padding's positions added."""
    planes = _extent_planes()[i]
    m = planes[0].shape[1]
    full = _plain(planes)
    ext = cuda_sequence.wide_extent(torch.as_tensor(planes[0]),
                                    torch.as_tensor(planes[4])).numpy()
    assert (ext <= m).all() and (ext >= 1).all()
    for k in range(planes[0].shape[0]):
        e = int(ext[k])
        if e == m:
            continue
        row = [p[k:k + 1, :e] for p in planes]
        part = _plain(row)
        valid = planes[4][k, :e]
        assert not planes[4][k, e:].any()
        assert np.array_equal(part['tree_pos'][0][valid],
                              full['tree_pos'][k, :e][valid])
        assert part['length'][0] == full['length'][k]
        assert np.array_equal(part['vis_index'][0], full['vis_index'][k, :e])
        assert (full['vis_index'][k, e:] == -1).all()
        on = valid & (part['tree_pos'][0] > 0)
        nap = part['node_at_pos'][0].copy()
        filled = np.zeros(e, bool)
        filled[part['tree_pos'][0][on]] = True
        filled[0] = True
        nap[~filled] = m - 1
        assert np.array_equal(nap, full['node_at_pos'][k, :e])
        assert (full['node_at_pos'][k, e:] == m - 1).all()


def test_extent_vote():
    """``wide_extent``: the valid extent where every valid node's parent
    is the head or an earlier valid node, else the whole width."""
    parent = torch.tensor([[0, 0, 1, 2, 9, 9],     # a chain, padded
                           [0, 0, 1, 0, 0, 0],     # node 3 invalid, 4 under 0
                           [0, 0, 3, 1, 0, 0],     # node 2 under a later node
                           [0, 0, 1, 1, 0, 0],     # node 3 under invalid 1
                           [0, 0, 0, 0, 0, 0],     # nothing valid
                           [0, 7, 1, 2, 0, 0]],    # node 1 out of range
                          dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1, 0, 0],
                          [1, 1, 1, 0, 1, 0],
                          [1, 1, 1, 1, 0, 0],
                          [1, 0, 1, 1, 0, 0],
                          [0, 0, 0, 0, 0, 0],
                          [1, 1, 1, 1, 0, 0]], dtype=torch.bool)
    got = cuda_sequence.wide_extent(parent, valid).tolist()
    assert got == [4, 5, 6, 6, 1, 6]


def test_wide_dispatch_and_budget():
    """The wide variant's shared-memory budget and the dispatch as pure
    functions: ``'wide'`` past ``M_NARROW`` up to the budget's edge (the
    order mode 9,771 nodes, the delta mode 8,599), ``'wide-global'``
    past it, ``'wide-grid'`` (the only variant behind a PyTorch child
    sort) for a few long rows."""
    n = cuda_sequence.M_NARROW
    limit = cuda_sequence.WIDE_SMEM_LIMIT
    assert limit == 232448 - 17 * 1024
    for delta, edge in ((False, 9771), (True, 8599)):
        assert cuda_sequence.wide_fits_smem(edge, delta)
        assert not cuda_sequence.wide_fits_smem(edge + 1, delta)
        assert cuda_sequence.wide_smem_bytes(edge, delta) <= limit < \
            cuda_sequence.wide_smem_bytes(edge + 1, delta)
    assert cuda_sequence.wide_smem_bytes(6144) == \
        5 * 4 * 6148 + 2 * 6144
    assert cuda_sequence.wide_smem_bytes(6144, True) == \
        6 * 4 * 6148 + 6144
    for K, m, want, want_delta in (
            (2048, 6144, 'wide', 'wide'),       # the mixed tick
            (128, 1024, 'wide', 'wide'),        # its pasted paragraphs
            (1, 3072, 'wide', 'wide'),
            (132, 8192, 'wide', 'wide'),
            (132, 9000, 'wide', 'wide-global'),
            (528, 12288, 'wide-global', 'wide-global'),
            (1, 12288, 'wide-global', 'wide-global'),
            (32, 12800, 'wide-global', 'wide-global'),
            (4, 16384, 'wide-grid', 'wide-global'),
            (8, 24576, 'wide-grid', 'wide-grid'),
            (32, 32768, 'wide-grid', 'wide-global'),
            (1, 196608, 'wide-grid', 'wide-grid')):
        assert cuda_sequence.variant(K, m) == want
        assert cuda_sequence.delta_variant(K, m) == want_delta
    assert cuda_sequence.variant(64, n) == 'narrow'
    assert cuda_sequence.delta_variant(64, n) == 'narrow'
    assert cuda_sequence.delta_variant(64, n + 1) == 'wide'
    for delta, bands in ((False, cuda_sequence.GRID_BANDS),
                         (True, cuda_sequence.DELTA_GRID_BANDS)):
        for bound, rows in bands:
            m = bound or 196608
            assert cuda_sequence.sorted_variant(rows + 1, m, delta) == \
                ('wide' if cuda_sequence.wide_fits_smem(m, delta)
                 else 'wide-global')
            if rows and cuda_grid.fits(rows, rows * (m + 1)):
                assert cuda_sequence.sorted_variant(rows, m, delta) == \
                    'wide-grid'


def test_cpu_planes_take_the_plain_version():
    planes = [torch.as_tensor(p)
              for p in padded_rows(np.random.default_rng(8), 3, 600)]
    before = dict(cuda_sequence.launches)
    got = sequence._rga_order_batched(*planes)
    assert cuda_sequence.launches == before
    want = sequence._rga_order_plain(*planes)
    for k in OUTS:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError):
        cuda_sequence.rga_wide_cuda(*planes, rounds=11)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_rga_wide.py -m cuda)')
    return torch.device('cuda')


CARD_TREES = {**ALL_TREES, 'orphan': orphan_trees, 'padded': padded_rows}


def _on(planes, dev):
    return [torch.as_tensor(p).to(dev) for p in planes]


def _card_check(planes, dev, force=None, delta=False):
    """The kernel (through the dispatch, or forced) against the plain
    version computed on the host (where on-chain positions collide the
    host's scatter is the defined one): every output bit for bit on rows
    with unique chain positions, tree_pos on valid nodes everywhere."""
    cpu = [torch.as_tensor(p) for p in planes]
    card = _on(planes, dev)
    K, m = cpu[0].shape
    rounds = sequence._ceil_log2(m) + 1
    before = dict(cuda_sequence.launches)
    if delta:
        want = sequence._rga_delta_order_plain(*cpu)
        if force is None:
            got = sequence._rga_delta_order_batched(*card)
        else:
            got = cuda_sequence.rga_wide_cuda(
                card[0], card[2], card[3], None, card[4], rounds=rounds,
                anchor=card[1], force=force)
        torch.cuda.synchronize()
        valid = cpu[4]
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu()[valid], want[valid])
        mode = 'order' if force is None and \
            cuda_sequence.delta_variant(K, m) == 'wide-grid' else 'delta'
    else:
        want = {k: v.numpy() for k, v in sequence._rga_order_plain(*cpu)
                .items()}
        if force is None:
            got = sequence._rga_order_batched(*card)
        else:
            got = cuda_sequence.rga_wide_cuda(*card, rounds=rounds,
                                              force=force)
        torch.cuda.synchronize()
        rows = _positions_unique(want, planes[4])
        _same({k: v.cpu().numpy() for k, v in got.items()}, want,
              planes[4], rows)
        mode = 'order'
    v = force or (cuda_sequence.delta_variant(K, m) if delta
                  else cuda_sequence.variant(K, m))
    assert cuda_sequence.last_variant == v
    added = {k: n - before.get(k, 0) for k, n in
             cuda_sequence.launches.items() if n != before.get(k, 0)}
    assert added == {(mode, v): 1}


@pytest.mark.cuda
@pytest.mark.parametrize('tree', sorted(CARD_TREES))
@pytest.mark.parametrize('K,m', [(3, 513), (5, 1100), (4, 2048), (3, 6144),
                                 (3, 9771), (40, 3071), (132, 1024)])
def test_cuda_wide_matches_plain(cuda_device, tree, K, m):
    planes = CARD_TREES[tree](np.random.default_rng(K * 3 + m), K, m)
    assert cuda_sequence.variant(K, m) == 'wide'
    _card_check(planes, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize('tree', sorted(CARD_TREES))
@pytest.mark.parametrize('K,m', [(1, 1), (2, 2), (3, 33), (4, 512),
                                 (3, 1390), (2, 4097), (2, 9772),
                                 (1, 12288)])
def test_cuda_wide_forced_matches_plain(cuda_device, tree, K, m):
    """Each variant forced at widths the dispatch gives others: the
    shared-memory variant up to its edge, the global-memory one at every
    width (past the edge it is the dispatch's)."""
    planes = CARD_TREES[tree](np.random.default_rng(K * 5 + m), K, m)
    forced = ['wide-global']
    if cuda_sequence.wide_fits_smem(m):
        forced.append('wide')
    for force in forced:
        _card_check(planes, cuda_device, force=force)


@pytest.mark.cuda
@pytest.mark.parametrize('K,m', [(1, 1), (3, 33), (4, 513), (3, 1100),
                                 (2, 4096), (3, 8599), (3, 8600)])
def test_cuda_wide_delta_matches_plain(cuda_device, K, m):
    """The delta mode of the wide kernel: through the dispatch past
    ``M_NARROW`` and forced at every width, tree_pos on valid rows."""
    planes = delta_forests(np.random.default_rng(K + m), K, m)
    if m > cuda_sequence.M_NARROW:
        _card_check(planes, cuda_device, delta=True)
    forced = ['wide-global']
    if cuda_sequence.wide_fits_smem(m, delta=True):
        forced.append('wide')
    for force in forced:
        _card_check(planes, cuda_device, force=force, delta=True)


@pytest.mark.cuda
def test_cuda_wide_smem_fit_agrees_with_the_c_side(cuda_device):
    for delta in (False, True):
        for m in (513, 1390, 6144, 8191, 8599, 8600, 9771, 9772, 40000):
            assert cuda_sequence.uses_global_scratch(m, delta) == \
                (not cuda_sequence.wide_fits_smem(m, delta))


@pytest.mark.cuda
def test_cuda_wide_path_makes_no_sort(cuda_device, monkeypatch):
    """Rows that take the wide variant reach the kernel with no PyTorch
    child sort, in both modes."""
    rows = padded_rows(np.random.default_rng(3), 64, 6144, fill=900)
    forest = delta_forests(np.random.default_rng(4), 16, 1024)
    want = sequence._rga_order_plain(*(torch.as_tensor(p) for p in rows))
    want_d = sequence._rga_delta_order_plain(*(torch.as_tensor(p)
                                               for p in forest))

    def no_sort(*a, **kw):
        raise AssertionError('the child sort on the wide RGA path')
    monkeypatch.setattr(sequence, '_child_sort', no_sort)
    monkeypatch.setattr(torch, 'sort', no_sort)
    got = sequence._rga_order_batched(*_on(rows, cuda_device))
    got_d = sequence._rga_delta_order_batched(*_on(forest, cuda_device))
    torch.cuda.synchronize()
    _same({k: v.cpu().numpy() for k, v in got.items()},
          {k: v.numpy() for k, v in want.items()}, rows[4])
    valid = torch.as_tensor(forest[4])
    assert torch.equal(got_d.cpu()[valid], want_d[valid])
