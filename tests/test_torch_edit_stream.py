"""The edit stream: the PyTorch port's plain versions against the JAX
package's ``edit_stream`` / ``edit_stream_packed`` / ``edit_stream_wide``
(and once against the
Pallas kernel in interpret mode) on numpy-seeded planes, including
``e_pad`` below the class counts (the drop path), ``e_pad`` = 1 and
``e_pad`` = m. ``dispatch_edit_stream`` runs the plain version for CPU
tensors; the CUDA kernel's variants (one warp per row, one block per
row, the block's global-memory bitmasks) are held against the plain
version on the card (``cuda``-marked cases; run there with ``python -m
pytest tests/test_torch_edit_stream.py -m cuda``)."""

import jax
import numpy as np
import pytest
import torch

from automerge_tpu.device import pallas_view as jv
from automerge_tpu_torch.device import cuda_grid
from automerge_tpu_torch.device import cuda_view as tv

from chip_smoke import random_planes, wide_planes

torch.set_num_threads(1)


def _same(jout, tout):
    jout = jax.device_get(jout)
    assert len(jout) == len(tout) == 6
    for a, b in zip(jout, tout):
        a = np.asarray(a)
        b = b.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


CASES = [(1, 8, 8), (5, 64, 8), (5, 64, 24), (7, 200, 16), (3, 200, 64),
         (2, 40, 1), (4, 33, 1), (4, 33, 33), (2, 200, 200)]


@pytest.mark.parametrize('K,m,e_pad', CASES)
def test_plain_packed_matches_jax(K, m, e_pad):
    rng = np.random.default_rng(K * 1000 + m + e_pad)
    pv, nv, pi, ni, tb, packed = random_planes(rng, K, m)
    _same(jv.edit_stream_packed(packed, tb, e_pad=e_pad),
          tv.edit_stream_packed(*_t(packed, tb), e_pad=e_pad))


@pytest.mark.parametrize('K,m,e_pad', CASES)
def test_plain_cols_matches_jax(K, m, e_pad):
    rng = np.random.default_rng(K * 1000 + m + e_pad + 7)
    pv, nv, pi, ni, tb, packed = random_planes(rng, K, m)
    _same(jv.edit_stream(pv, nv, pi, ni, tb, e_pad=e_pad),
          tv.edit_stream(*_t(pv, nv, pi, ni, tb), e_pad=e_pad))


@pytest.mark.parametrize('K,m,e_pad', CASES)
def test_plain_wide_matches_jax(K, m, e_pad):
    rng = np.random.default_rng(K * 1000 + m + e_pad + 11)
    pv, nv, pi, ni, tb, _ = random_planes(rng, K, m)
    vp, vn = wide_planes(pv, nv, pi, ni)
    _same(jv.edit_stream_wide(vp, vn, tb, e_pad=e_pad),
          tv.edit_stream_wide(*_t(vp, vn, tb), e_pad=e_pad))


def test_drop_path_counts_are_not_clamped():
    rng = np.random.default_rng(2)
    pv, nv, pi, ni, tb, packed = random_planes(rng, 4, 64)
    out = tv.edit_stream_packed(*_t(packed, tb), e_pad=4)
    cnt = out[5].numpy()
    assert (cnt > 4).any()            # the drop path ran
    assert np.array_equal(cnt[:, 0], (pv & ~nv).sum(axis=1))
    assert np.array_equal(cnt[:, 1], (nv & ~pv).sum(axis=1))


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(42)
    pv, nv, pi, ni, tb, packed = random_planes(rng, 3, 32)
    _same(jv.edit_stream_pallas(pv, nv, pi, ni, tb, e_pad=8,
                                interpret=True),
          tv.edit_stream(*_t(pv, nv, pi, ni, tb), e_pad=8))


def _host_planes(fmt, pv, nv, pi, ni, packed):
    return {'packed': packed, 'cols': (pv, nv, pi, ni),
            'wide': wide_planes(pv, nv, pi, ni)}[fmt]


def _torch_planes(fmt, host, dev='cpu'):
    if fmt == 'packed':
        return torch.as_tensor(host).to(dev)
    return tuple(x.to(dev) for x in _t(*host))


def _plain(fmt, planes, t_u8, e_pad):
    if fmt == 'packed':
        return tv.edit_stream_packed(planes, t_u8, e_pad=e_pad)
    if fmt == 'wide':
        return tv.edit_stream_wide(*planes, t_u8, e_pad=e_pad)
    return tv.edit_stream(*planes, t_u8, e_pad=e_pad)


@pytest.mark.parametrize('fmt', ['packed', 'cols', 'wide'])
def test_dispatch_on_cpu_uses_the_plain_version(fmt):
    rng = np.random.default_rng(5)
    pv, nv, pi, ni, tb, packed = random_planes(rng, 6, 48)
    host = _host_planes(fmt, pv, nv, pi, ni, packed)
    before = sum(tv.launches.values())
    got = tv.dispatch_edit_stream(fmt, _torch_planes(fmt, host), tb, 16)
    assert sum(tv.launches.values()) == before
    assert all(t.device.type == 'cpu' for t in got)
    _same(jv.dispatch_edit_stream(fmt, host, tb, 16), got)


def test_warp_bound():
    assert tv.M_WARP_ES >= 32
    assert tv.variant(1, tv.M_WARP_ES) == 'warp'
    assert tv.variant(1, 4096, force='warp') == 'warp'
    with pytest.raises(ValueError):
        tv.variant(1, 64, force='bogus')


@pytest.mark.parametrize('K,m,want', [
    (12288, 64, 'warp'),            # config 5's ticks
    (1, 65536, 'grid'),             # config 4's bulk line (wide)
    (1, 49152, 'grid'),             # the long text's rebuild arm (wide)
    (1, 32768, 'grid'),             # the long text's first apply (packed)
    (528, 4096, 'block'),           # rows that fill the card
    (33, 65536, 'block'),
    (1, 2048, 'block'),             # one short row: the block wins
    (1, 4096, 'grid'),
    (528, 300000, 'grid'),          # past the block's shared memory
    (529, 300000, 'block-global'),  # past the rows measured
    (8193, 300000, 'block-global'),
    (984, 273057, 'block-global'),  # past one grid launch's slots
    (528, 600000, 'block-global'),
])
def test_variant_at_the_main_paths_shapes(K, m, want):
    """The pure dispatch at the shapes the main paths hand the edit
    stream: a few long rows take the grid variant, a batch that fills
    the card one block per row."""
    assert tv.variant(K, m) == want
    assert tv.variant(K, m, force='grid') == 'grid'
    assert tv.variant(K, m, force='block') == \
        ('block' if tv.block_fits_smem(m) else 'block-global')


def test_variant_smem_fit_and_grid_bands():
    assert tv.block_fits_smem(273056)
    assert not tv.block_fits_smem(273057)
    for bound, rows in tv.GRID_BANDS:
        m = bound or 300000
        if rows:
            assert tv.variant(rows, m) == 'grid'
        assert tv.variant(rows + 1, m) == \
            ('block' if tv.block_fits_smem(m) else 'block-global')


@pytest.mark.parametrize('K,slots,ok', [
    (1, 1, True),
    (cuda_grid.GRID_MAX_ROWS, 1 << 20, True),
    (cuda_grid.GRID_MAX_ROWS + 1, 1 << 20, False),
    (528, cuda_grid.GRID_MAX_SLOTS, True),
    (984, 984 * 273057, False),     # the first shape past the slots
])
def test_grid_launch_limits(K, slots, ok):
    """One grid launch's limits, as csrc/grid.cuh sets them: a shape
    past them never takes the grid variant, and a forced one raises."""
    assert cuda_grid.fits(K, slots) == ok
    if ok:
        cuda_grid.check(K, slots)
    else:
        with pytest.raises(ValueError):
            cuda_grid.check(K, slots)
    assert cuda_grid.GRID_MAX_SLOTS == (2**31 - 1) // 8


def test_cuda_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(6)
    _, _, _, _, tb, packed = random_planes(rng, 2, 16)
    with pytest.raises(ValueError):
        tv.edit_stream_cuda('packed', torch.as_tensor(packed),
                            torch.as_tensor(tb), 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_edit_stream.py -m cuda)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('K,m,e_pad', CASES + [(10240, 64, 64),
                                               (64, 4096, 512)])
@pytest.mark.parametrize('fmt', ['packed', 'cols', 'wide'])
def test_cuda_kernel_matches_plain(cuda_device, fmt, K, m, e_pad):
    rng = np.random.default_rng(K + m + e_pad)
    pv, nv, pi, ni, tb, packed = random_planes(rng, K, m)
    t_u8 = torch.as_tensor(tb).to(cuda_device)
    planes = _torch_planes(fmt, _host_planes(fmt, pv, nv, pi, ni, packed),
                           cuda_device)
    want = _plain(fmt, planes, t_u8, e_pad)
    before = sum(tv.launches.values())
    got = tv.dispatch_edit_stream(fmt, planes, tb, e_pad)
    torch.cuda.synchronize()
    assert sum(tv.launches.values()) == before + 1
    assert tv.last_variant == tv.variant(K, m)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _card_case(dev, fmt, K, m, e_pad, seed):
    pv, nv, pi, ni, tb, packed = random_planes(np.random.default_rng(seed),
                                               K, m)
    t_u8 = torch.as_tensor(tb).to(dev)
    planes = _torch_planes(fmt, _host_planes(fmt, pv, nv, pi, ni, packed),
                           dev)
    return planes, t_u8, _plain(fmt, planes, t_u8, e_pad)


def _widths():
    w = tv.M_WARP_ES
    return [8, 32, 33, 64, 200, w, w + 1, 4096, 32767]


@pytest.mark.cuda
@pytest.mark.parametrize('e_pad', ['drop', 'one', 'm'])
@pytest.mark.parametrize('i', range(9))
@pytest.mark.parametrize('fmt', ['packed', 'cols', 'wide'])
def test_cuda_variants_match_plain(cuda_device, fmt, i, e_pad):
    m = _widths()[i]
    K = max(2, min(256, 300_000 // m))
    e = {'drop': max(1, m // 8), 'one': 1, 'm': m}[e_pad]
    planes, t_u8, want = _card_case(cuda_device, fmt, K, m, e, K + m + e)
    if e_pad == 'drop':
        assert bool((want[5] > e).any())      # the drop path is hit
    before = sum(tv.launches.values())
    got = tv.edit_stream_cuda(fmt, planes, t_u8, e)
    assert tv.last_variant == tv.variant(K, m) == \
        ('warp' if m <= tv.M_WARP_ES else
         'grid' if K <= cuda_grid.band_rows(tv.GRID_BANDS, m) else
         'block')
    forced = [tv.edit_stream_cuda(fmt, planes, t_u8, e, force=v)
              for v in ('warp', 'block', 'grid')]
    torch.cuda.synchronize()
    assert sum(tv.launches.values()) == before + 4
    assert tv.last_variant == 'grid'
    for out in (got, *forced):
        for a, b in zip(want, out):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_block_global_matches_plain(cuda_device):
    m = 300_000                     # past the block's shared-memory cap
    planes, t_u8, want = _card_case(cuda_device, 'cols', 2, m, 4096, 3)
    assert tv.variant(2, m, force='block') == 'block-global'
    got = tv.edit_stream_cuda('cols', planes, t_u8, 4096, force='block')
    torch.cuda.synchronize()
    assert tv.last_variant == 'block-global'
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('m', [512, 40000, 65536])
def test_cuda_wide_long_text_matches_plain(cuda_device, m):
    """A long text's one row on the wide format (m past 32,768: the grid
    variant, and the block variant forced, whose bitmasks at 65,536 are
    exactly 48 KB, which with the scan's static storage needs the
    shared-memory opt-in) and a warp-width row, against the plain
    version."""
    planes, t_u8, want = _card_case(cuda_device, 'wide', 1, m, 64, m)
    got = tv.edit_stream_cuda('wide', planes, t_u8, 64)
    torch.cuda.synchronize()
    assert tv.last_variant == ('warp' if m <= tv.M_WARP_ES else 'grid')
    outs = [got]
    if m > tv.M_WARP_ES:
        outs.append(tv.edit_stream_cuda('wide', planes, t_u8, 64,
                                        force='block'))
        torch.cuda.synchronize()
        assert tv.last_variant == 'block'
    for out in outs:
        for a, b in zip(want, out):
            assert a.dtype == b.dtype and torch.equal(a, b)


# the grid variant's shapes: one or three long rows, the packed format
# up to its 15-bit indexes, e_pad 1, 8 and m
GRID_CASES = [(fmt, K, m) for K in (1, 3)
              for m in (513, 32768, 65536, 300000)
              for fmt in ('packed', 'wide', 'cols')
              if fmt != 'packed' or m <= 32768]


@pytest.mark.cuda
@pytest.mark.parametrize('e_pad', ['one', 'eight', 'm'])
@pytest.mark.parametrize('fmt,K,m', GRID_CASES)
def test_cuda_grid_matches_plain(cuda_device, fmt, K, m, e_pad):
    e = {'one': 1, 'eight': 8, 'm': m}[e_pad]
    planes, t_u8, want = _card_case(cuda_device, fmt, K, m, e, K * m + e)
    before = tv.launches.get((fmt, 'grid'), 0)
    outs = [tv.edit_stream_cuda(fmt, planes, t_u8, e, force='grid')]
    if tv.variant(K, m) == 'grid':
        outs.append(tv.dispatch_edit_stream(fmt, planes, t_u8.cpu().numpy(),
                                            e))
    torch.cuda.synchronize()
    assert tv.launches[(fmt, 'grid')] == before + len(outs)
    for out in outs:
        for a, b in zip(want, out):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('fmt', ['packed', 'wide'])
def test_cuda_grid_refuses_past_its_rows(cuda_device, fmt):
    """A forced grid launch of more rows than one launch takes raises
    before it reaches the card; the dispatch gives those rows one block
    each."""
    K, m = cuda_grid.GRID_MAX_ROWS + 1, 513
    planes, t_u8, want = _card_case(cuda_device, fmt, K, m, 8, K + m)
    before = dict(tv.launches)
    with pytest.raises(ValueError):
        tv.edit_stream_cuda(fmt, planes, t_u8, 8, force='grid')
    assert tv.launches == before
    got = tv.edit_stream_cuda(fmt, planes, t_u8, 8)
    torch.cuda.synchronize()
    assert tv.last_variant == tv.variant(K, m) == 'block'
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
