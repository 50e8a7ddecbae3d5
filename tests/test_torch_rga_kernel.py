"""RGA ordering and its CUDA kernels. The PyTorch port's plain version
(``sequence._rga_order_plain`` — ``_child_sort``, then
``_order_from_sorted_plain`` — the CPU path of ``_rga_order_batched``)
against the JAX package's ``_rga_order_batched`` (the one-hot MXU variant
up to m = 512, the gather variant above) on every output, and against
its Pallas kernel ``rga_order_batch_pallas`` in interpret mode on
``vis_index`` and ``length`` (the outputs the Pallas kernel has), on
numpy-seeded random, prepend and chain trees — exact equality, dtypes
included. The CUDA kernels are held against the plain versions on the
card (``cuda``-marked cases: every output, ``tree_pos`` on valid rows;
the narrow kernel at every width up to 512, the wide one at every width
including its global-memory variant; the delta mode, narrow and through
the sort + wide kernel, on ``tree_pos`` of valid rows; run there with
``python -m pytest tests/test_torch_rga_kernel.py -m cuda``). The JAX
package is imported
inside the tests that compare with it, so the card's cases need only the
port."""

import functools

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device import cuda_grid, cuda_sequence, sequence

from chip_smoke import TREES, delta_forests, random_trees, wide_key_trees

torch.set_num_threads(1)

OUTS = ('tree_pos', 'vis_index', 'node_at_pos', 'length')


def _sorted_inputs(planes):
    """The inputs of the wide kernel and its plain version."""
    parent, elem, actor, visible, valid = planes
    return (*sequence._child_sort(parent, elem, actor, valid), visible,
            valid)


def _same(got, want, valid, keys=OUTS):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if k == 'tree_pos':
            a, b = a[valid], b[valid]
        assert np.array_equal(a, b), k


@pytest.mark.parametrize('K,m', [(3, 16), (9, 130)])
def test_plain_matches_jax_pallas_interpret(K, m):
    import jax.numpy as jnp
    from automerge_tpu.device.pallas_sequence import rga_order_batch_pallas
    planes = random_trees(np.random.default_rng(K * 100 + m), K, m)
    want = rga_order_batch_pallas(*(jnp.asarray(p) for p in planes),
                                  interpret=True)
    got = sequence._order_from_sorted_plain(
        *_sorted_inputs([torch.as_tensor(p) for p in planes]))
    for k in ('vis_index', 'length'):
        a = np.asarray(want[k])
        b = got[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize('tree', ['prepend', 'chain'])
def test_rga_plain_matches_jax_pallas_interpret(tree):
    import jax.numpy as jnp
    from automerge_tpu.device.pallas_sequence import rga_order_batch_pallas
    planes = TREES[tree](np.random.default_rng(17), 4, 40)
    want = rga_order_batch_pallas(*(jnp.asarray(p) for p in planes),
                                  interpret=True)
    got = sequence._rga_order_plain(*(torch.as_tensor(p) for p in planes))
    _same({k: v.numpy() for k, v in got.items()}, want, planes[4],
          keys=('vis_index', 'length'))


@pytest.mark.parametrize('tree', sorted(TREES))
@pytest.mark.parametrize('K,m', [(5, 33), (3, 600)])
def test_rga_plain_matches_jax_rga_order_batched(tree, K, m):
    import jax.numpy as jnp
    from automerge_tpu.device import sequence as js
    planes = TREES[tree](np.random.default_rng(K * 1000 + m), K, m)
    want = js.rga_order_batch(*(jnp.asarray(p) for p in planes))
    got = sequence._rga_order_plain(*(torch.as_tensor(p) for p in planes))
    _same({k: v.numpy() for k, v in got.items()}, want, planes[4])


def test_cpu_planes_take_the_plain_version():
    planes = [torch.as_tensor(p)
              for p in random_trees(np.random.default_rng(4), 5, 40)]
    before = sum(cuda_sequence.launches.values())
    got = sequence._rga_order_batched(*planes)
    assert sum(cuda_sequence.launches.values()) == before
    want = sequence._order_from_sorted_plain(*_sorted_inputs(planes))
    for k in OUTS:
        assert got[k].dtype == torch.int32 and torch.equal(got[k], want[k])
    with pytest.raises(ValueError):
        cuda_sequence.order_from_sorted_cuda(
            *(t.to(torch.int32) for t in _sorted_inputs(planes)[:3]),
            planes[3], planes[4], rounds=7)
    with pytest.raises(ValueError):
        cuda_sequence.rga_order_cuda(*planes, rounds=7)


def test_dispatch_bounds():
    assert 1 <= cuda_sequence.M_NARROW <= 512
    assert cuda_sequence.variant(1, 1) == 'narrow'
    assert cuda_sequence.variant(1, cuda_sequence.M_NARROW) == 'narrow'
    assert cuda_sequence.variant(12288, 9) == 'narrow'


@pytest.mark.parametrize('K,m,want', [
    (12288, 64, 'narrow'),          # config 5's rebuild tick
    (1, 196608, 'wide-grid'),       # config 4's replay and facade edits
    (1, 49152, 'wide-grid'),        # the long text's rebuild arm
    (1, 65536, 'wide-grid'),        # config 4's bulk line
    (528, 4096, 'wide'),            # rows that fill the card
    (528, 9771, 'wide'),
    (528, 12799, 'wide-global'),
    (1, 8192, 'wide'),              # one short row: the block wins
    (2, 10240, 'wide-global'),
    (3, 10240, 'wide-global'),
    (8, 12799, 'wide-global'),
    (1, 14336, 'wide-global'),      # the bands' edges (PERF.md)
    (1, 14337, 'wide-grid'),
    (4, 16384, 'wide-grid'),
    (5, 16384, 'wide-global'),
    (8, 24576, 'wide-grid'),
    (9, 24576, 'wide-global'),
    (9, 12799, 'wide-global'),
    (32, 40000, 'wide-grid'),
    (132, 49152, 'wide-global'),    # past the cap, rows that fill it
    (32, 8388606, 'wide-grid'),     # one grid launch's last slots
    (32, 8388608, 'wide-global'),   # past them
])
def test_variant_at_the_main_paths_shapes(K, m, want):
    """The pure dispatch at the shapes the main paths hand the RGA
    kernel: a few long rows take the grid variant, a batch that fills
    the card one block per row."""
    assert cuda_sequence.variant(K, m) == want
    assert cuda_sequence.sorted_variant(K, m) == \
        ('wide' if m <= cuda_sequence.M_NARROW else want)


def test_variant_smem_fit_and_grid_bands():
    assert cuda_sequence.wide_fits_smem(9771)
    assert not cuda_sequence.wide_fits_smem(9772)
    for bound, rows in cuda_sequence.GRID_BANDS:
        m = bound or 196608
        if rows:
            assert cuda_sequence.variant(rows, m) == 'wide-grid'
        assert cuda_sequence.variant(rows + 1, m) == \
            ('wide' if cuda_sequence.wide_fits_smem(m) else 'wide-global')


@pytest.mark.parametrize('tree', ['chain', 'prepend'])
def test_rga_plain_matches_jax_on_one_long_row(tree):
    """A K = 1 row past 4,096 nodes (ceil(log2 m) = 13, so 14 doubling
    rounds), the grid variant's shape: the plain version against the JAX
    package."""
    import jax.numpy as jnp
    from automerge_tpu.device import sequence as js
    planes = TREES[tree](np.random.default_rng(4097), 1, 4097)
    assert sequence._ceil_log2(4097) + 1 == 14
    want = js.rga_order_batch(*(jnp.asarray(p) for p in planes))
    got = sequence._rga_order_plain(*(torch.as_tensor(p) for p in planes))
    _same({k: v.numpy() for k, v in got.items()}, want, planes[4])


@functools.cache
def _jax_delta_order():
    """The JAX package's ``_rga_delta_order_batched`` under one
    ``jax.jit`` (one XLA compile a width, not one a primitive)."""
    import jax
    from automerge_tpu.device import sequence as js
    return jax.jit(js._rga_delta_order_batched)


@pytest.mark.parametrize('m', range(1, 17))
def test_delta_plain_matches_jax_at_short_widths(m):
    """The delta orderer's plain version against the JAX package's
    ``_rga_delta_order_batched`` at every width the subwarp variant takes
    on the main paths (seeded delta forests: anchors up to 2^22 - 1,
    anchor and elem ties, garbage in the padding); tree_pos on valid
    rows."""
    import jax.numpy as jnp
    planes = delta_forests(np.random.default_rng(100 + m), 6, m)
    want = np.asarray(_jax_delta_order()(*[jnp.asarray(p)
                                           for p in planes]))
    got = sequence._rga_delta_order_batched(
        *[torch.as_tensor(p) for p in planes]).numpy()
    valid = planes[4]
    assert want.dtype == got.dtype
    assert np.array_equal(want[valid], got[valid])


def test_delta_variant_bounds():
    assert 1 <= cuda_sequence.M_SUBWARP <= 32
    assert cuda_sequence.delta_variant(12288, 9) == 'subwarp'   # tick 2
    assert cuda_sequence.delta_variant(1, 1) == 'subwarp'
    m = cuda_sequence.M_SUBWARP
    assert cuda_sequence.delta_variant(12288, m) == 'subwarp'
    assert cuda_sequence.delta_variant(12288, m + 1) == 'narrow'
    assert cuda_sequence.delta_variant(4, 513) == \
        cuda_sequence.variant(4, 513)


def test_cpu_delta_planes_take_the_plain_version():
    planes = [torch.as_tensor(p)
              for p in delta_forests(np.random.default_rng(4), 5, 33)]
    before = sum(cuda_sequence.launches.values())
    got = sequence._rga_delta_order_batched(*planes)
    assert sum(cuda_sequence.launches.values()) == before
    assert got.dtype == torch.int32
    assert torch.equal(got, sequence._rga_delta_order_plain(*planes))
    with pytest.raises(ValueError):
        cuda_sequence.rga_delta_cuda(*planes, rounds=7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_rga_kernel.py -m cuda)')
    return torch.device('cuda')


# wide-key trees take the narrow kernel's 64-bit and 128-bit key paths
# (the others its 32-bit one); the JAX package negates int32 keys, so
# they are held against the port's plain version only
CARD_TREES = {**TREES, 'wide-key': wide_key_trees}


def _card_planes(tree, K, m, dev):
    return [torch.as_tensor(p).to(dev)
            for p in CARD_TREES[tree](np.random.default_rng(K + m), K, m)]


@pytest.mark.cuda
@pytest.mark.parametrize('K,m', [(1, 2), (6, 16), (37, 200), (12288, 64),
                                 (64, 4096), (2, 40000)])
def test_cuda_kernel_matches_plain(cuda_device, K, m):
    planes = [torch.as_tensor(p).to(cuda_device)
              for p in random_trees(np.random.default_rng(K + m), K, m)]
    want = sequence._order_from_sorted_plain(*_sorted_inputs(planes))
    before = sum(cuda_sequence.launches.values())
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert sum(cuda_sequence.launches.values()) == before + 1
    assert cuda_sequence.uses_global_scratch(m) == (m == 40000) == \
        (not cuda_sequence.wide_fits_smem(m))
    assert cuda_sequence.last_variant == cuda_sequence.variant(K, m)
    valid = planes[4]
    for k in OUTS:
        assert got[k].dtype == want[k].dtype, k
        if k == 'tree_pos':
            assert torch.equal(got[k][valid], want[k][valid]), k
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('m', [2231, 2232])
def test_cuda_wide_kernel_at_the_default_smem_edge(cuda_device, m):
    """Widths on both sides of 48 KB of the wide kernel's dynamic
    shared memory, both past it with the sort's static count table: the
    launch must opt in."""
    assert cuda_sequence.wide_smem_bytes(2231) <= 48 * 1024 < \
        cuda_sequence.wide_smem_bytes(2232)
    planes = _card_planes('random', 4, m, cuda_device)
    want = sequence._rga_order_plain(*planes)
    got = cuda_sequence.rga_wide_cuda(
        *(t.to(torch.int32) for t in planes[:3]), planes[3], planes[4],
        rounds=sequence._ceil_log2(m) + 1, force='wide')
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'wide'
    _same({k: v.cpu() for k, v in got.items()},
          {k: v.cpu() for k, v in want.items()}, planes[4].cpu())


def _widths():
    n = cuda_sequence.M_NARROW
    return [1, 2, 31, 32, 33, 64, n, n + 1, 4096, 12799, 12800, 40000]


@pytest.mark.cuda
@pytest.mark.parametrize('tree', sorted(CARD_TREES))
@pytest.mark.parametrize('i', range(12))
def test_cuda_dispatch_matches_plain(cuda_device, tree, i):
    m = _widths()[i]
    K = max(2, min(64, 200_000 // m))
    planes = _card_planes(tree, K, m, cuda_device)
    want = sequence._rga_order_plain(*planes)
    before = sum(cuda_sequence.launches.values())
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert sum(cuda_sequence.launches.values()) == before + 1
    expect = 'narrow' if m <= cuda_sequence.M_NARROW else \
        'wide-grid' if K <= cuda_grid.band_rows(cuda_sequence.GRID_BANDS,
                                                m) else \
        'wide' if cuda_sequence.wide_fits_smem(m) else 'wide-global'
    assert cuda_sequence.variant(K, m) == cuda_sequence.last_variant == \
        expect
    _same({k: v.cpu() for k, v in got.items()},
          {k: v.cpu() for k, v in want.items()}, planes[4].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize('tree', sorted(CARD_TREES))
@pytest.mark.parametrize('m', [1, 2, 31, 32, 33, 64, 100, 256, 257, 512])
def test_cuda_narrow_and_wide_match_plain(cuda_device, tree, m):
    K = max(2, min(300, 100_000 // m))
    planes = _card_planes(tree, K, m, cuda_device)
    want = sequence._rga_order_plain(*planes)
    rounds = sequence._ceil_log2(m) + 1
    narrow = cuda_sequence.rga_order_cuda(
        *(t.to(torch.int32) for t in planes[:3]), planes[3], planes[4],
        rounds=rounds)
    assert cuda_sequence.last_variant == 'narrow'
    wide = cuda_sequence.rga_wide_cuda(
        *(t.to(torch.int32) for t in planes[:3]), planes[3], planes[4],
        rounds=rounds)
    assert cuda_sequence.last_variant == 'wide'
    torch.cuda.synchronize()
    valid = planes[4].cpu()
    for got in (narrow, wide):
        _same({k: v.cpu() for k, v in got.items()},
              {k: v.cpu() for k, v in want.items()}, valid)


@pytest.mark.cuda
def test_cuda_narrow_path_makes_no_sort(cuda_device, monkeypatch):
    planes = _card_planes('random', 512, 64, cuda_device)
    want = sequence._rga_order_plain(*planes)

    def no_sort(*a, **kw):
        raise AssertionError('torch.sort on the narrow RGA path')
    monkeypatch.setattr(torch, 'sort', no_sort)
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'narrow'
    _same({k: v.cpu() for k, v in got.items()},
          {k: v.cpu() for k, v in want.items()}, planes[4].cpu())


# the grid variant's shapes: long single rows (config 4's replay at
# 196,608, the long text's rebuild at 49,152), a few rows at 40,000,
# and forced launches at widths the dispatch gives the wide variant
GRID_SHAPES = [(1, 16384), (1, 49152), (1, 196608), (2, 40000), (5, 40000)]


@pytest.mark.cuda
@pytest.mark.parametrize('tree', sorted(TREES))
@pytest.mark.parametrize('K,m', GRID_SHAPES)
def test_cuda_grid_dispatch_matches_plain(cuda_device, tree, K, m):
    planes = _card_planes(tree, K, m, cuda_device)
    want = sequence._rga_order_plain(*planes)
    before = cuda_sequence.launches.get(('order', 'wide-grid'), 0)
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'wide-grid'
    assert cuda_sequence.launches[('order', 'wide-grid')] == before + 1
    _same({k: v.cpu() for k, v in got.items()},
          {k: v.cpu() for k, v in want.items()}, planes[4].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize('tree', sorted(CARD_TREES))
@pytest.mark.parametrize('K,m', [(1, 513), (1, 3071), (64, 513),
                                 (300, 3071), (40, 4096)])
def test_cuda_grid_forced_matches_plain(cuda_device, tree, K, m):
    """The grid variant forced at widths and row counts the dispatch
    gives the wide one (several rows a CTA, rows straddling CTAs)."""
    planes = _card_planes(tree, K, m, cuda_device)
    want = sequence._rga_order_plain(*planes)
    got = cuda_sequence.order_from_sorted_cuda(
        *(t.to(torch.int32) for t in _sorted_inputs(planes)[:3]),
        planes[3], planes[4], rounds=sequence._ceil_log2(m) + 1)
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'wide-grid'
    _same({k: v.cpu() for k, v in got.items()},
          {k: v.cpu() for k, v in want.items()}, planes[4].cpu())


def _delta_planes(K, m, dev, seed=0):
    return [torch.as_tensor(p).to(dev)
            for p in delta_forests(np.random.default_rng(K + m + seed), K,
                                   m)]


@pytest.mark.cuda
@pytest.mark.parametrize('K,m', [(64, 9), (37, 33), (16, 129), (4, 513),
                                 (10240, 9), (1, 4096)])
def test_cuda_delta_dispatch_matches_plain(cuda_device, K, m):
    """The delta orderer on the card: the delta mode up to M_NARROW (its
    subwarp variant up to M_SUBWARP), the sort with the anchor key + wide
    kernel above; the
    anchors reach 2^22 - 1 and the elems pass 2^15, so the packed key
    takes its 64-bit word or the full key."""
    planes = _delta_planes(K, m, cuda_device)
    want = sequence._rga_delta_order_plain(*planes)
    before = dict(cuda_sequence.launches)
    got = sequence._rga_delta_order_batched(*planes)
    torch.cuda.synchronize()
    v = cuda_sequence.delta_variant(K, m)
    key = ('order' if v == 'wide-grid' else 'delta', v)
    assert cuda_sequence.last_variant == v
    assert cuda_sequence.launches[key] == before.get(key, 0) + 1
    valid = planes[4]
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got[valid], want[valid])


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 2, 31, 32, 33, 64, 100, 256, 257, 512])
def test_cuda_delta_narrow_at_every_width(cuda_device, m):
    K = max(2, min(300, 100_000 // m))
    planes = _delta_planes(K, m, cuda_device, seed=1)
    want = sequence._rga_delta_order_plain(*planes)
    before = cuda_sequence.launches.get(('delta', 'narrow'), 0)
    got = cuda_sequence.rga_delta_cuda(*planes[:4], planes[4],
                                       rounds=sequence._ceil_log2(m) + 1,
                                       force='narrow')
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'narrow'
    assert cuda_sequence.launches[('delta', 'narrow')] == before + 1
    valid = planes[4]
    assert torch.equal(got[valid], want[valid])


@pytest.mark.cuda
def test_cuda_delta_with_zero_anchors_is_the_rebuild_order(cuda_device):
    """With every anchor 0 the delta key is the rebuild's key: the delta
    mode's tree_pos equals the narrow kernel's on the same tree."""
    planes = _card_planes('random', 300, 64, cuda_device)
    parent, elem, actor, visible, valid = planes
    rounds = sequence._ceil_log2(64) + 1
    want = cuda_sequence.rga_order_cuda(parent, elem, actor, valid, valid,
                                        rounds=rounds)['tree_pos']
    got = cuda_sequence.rga_delta_cuda(parent, torch.zeros_like(parent),
                                       elem, actor, valid, rounds=rounds)
    torch.cuda.synchronize()
    assert torch.equal(got[valid], want[valid])


def _wide_key_delta(planes, rng):
    """Delta planes whose elems and actors span the full int32 range, so
    that with the anchors no packed key fits 63 bits: the full two-word
    key."""
    parent, anchor, elem, actor, valid = planes
    elem = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, elem.shape,
                                        dtype=np.int64).astype(np.int32))
    actor = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, actor.shape,
                                         dtype=np.int64).astype(np.int32))
    return [parent, anchor, elem.to(parent.device),
            actor.to(parent.device), valid]


@pytest.mark.cuda
@pytest.mark.parametrize('K', [1, 3, 12288])
@pytest.mark.parametrize('m', range(1, 33))
def test_cuda_delta_subwarp_matches_plain(cuda_device, K, m):
    """The subwarp variant, forced, at every width it takes and at one
    row, a partial warp and config 5's tick-2 row count, against the
    plain version and the narrow variant (tree_pos on valid rows): the
    anchors reach 2^22 - 1 (the packed 64-bit key), and a second draw
    spans full int32 elems and actors (the full key)."""
    rng = np.random.default_rng(K * 64 + m)
    rounds = sequence._ceil_log2(m) + 1
    for planes in (_delta_planes(K, m, cuda_device, seed=2),
                   _wide_key_delta(_delta_planes(K, m, cuda_device, seed=3),
                                   rng)):
        want = sequence._rga_delta_order_plain(*planes)
        before = cuda_sequence.launches.get(('delta', 'subwarp'), 0)
        got = cuda_sequence.rga_delta_cuda(*planes[:4], planes[4],
                                           rounds=rounds, force='subwarp')
        narrow = cuda_sequence.rga_delta_cuda(*planes[:4], planes[4],
                                              rounds=rounds, force='narrow')
        torch.cuda.synchronize()
        assert cuda_sequence.launches[('delta', 'subwarp')] == before + 1
        valid = planes[4]
        assert got.dtype == torch.int32
        assert torch.equal(got[valid], want[valid])
        assert torch.equal(narrow[valid], want[valid])


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 2, 5, 9, 16, 17, 32])
def test_cuda_delta_subwarp_with_zero_anchors_is_the_rebuild_order(
        cuda_device, m):
    """With every anchor 0 the subwarp variant's tree_pos equals the
    narrow kernel's rebuild order on the same tree (random, prepend and
    chain trees; the packed 32-bit key)."""
    rounds = sequence._ceil_log2(m) + 1
    for tree in ('random', 'prepend', 'chain'):
        parent, elem, actor, visible, valid = _card_planes(tree, 300, m,
                                                           cuda_device)
        want = cuda_sequence.rga_order_cuda(
            parent, elem, actor, valid, valid, rounds=rounds)['tree_pos']
        got = cuda_sequence.rga_delta_cuda(
            parent, torch.zeros_like(parent), elem, actor, valid,
            rounds=rounds, force='subwarp')
        torch.cuda.synchronize()
        assert torch.equal(got[valid], want[valid]), tree


@pytest.mark.cuda
def test_cuda_delta_subwarp_refuses_wide_rows(cuda_device):
    planes = _delta_planes(4, 33, cuda_device)
    before = dict(cuda_sequence.launches)
    with pytest.raises(ValueError):
        cuda_sequence.rga_delta_cuda(*planes[:4], planes[4], rounds=7,
                                     force='subwarp')
    assert cuda_sequence.launches == before


@pytest.mark.cuda
def test_cuda_grid_refuses_past_its_rows(cuda_device):
    """A forced grid launch of more rows than one launch takes raises
    before it reaches the card; the dispatch gives those rows one block
    each."""
    K, m = cuda_grid.GRID_MAX_ROWS + 1, 513
    planes = _card_planes('random', K, m, cuda_device)
    want = sequence._rga_order_plain(*planes)
    srt = [t.to(torch.int32) for t in _sorted_inputs(planes)[:3]]
    rounds = sequence._ceil_log2(m) + 1
    before = dict(cuda_sequence.launches)
    with pytest.raises(ValueError):
        cuda_sequence.order_from_sorted_cuda(*srt, planes[3], planes[4],
                                             rounds=rounds)
    assert cuda_sequence.launches == before
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == cuda_sequence.variant(K, m) == \
        'wide'
    _same({k: v.cpu() for k, v in got.items()},
          {k: v.cpu() for k, v in want.items()}, planes[4].cpu())
