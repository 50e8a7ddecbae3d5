"""The roofline's byte counts on ticks counted by hand, and the kernel
name map."""

import pytest

from benchmark import roofline
from benchmark.harness.record import Record


def test_rga_bytes_hand_counted():
    # rows: (nodes after, nodes added, sequence ops)
    # row 1: 3 nodes added -> 3 * (12 + 4 + 4) + 4 = 64
    # row 2: none added -> 0; row 3: 1 added -> 24
    assert roofline.rga_bytes([(10, 3, 7), (50, 0, 4), (1, 1, 2)]) == 88


def test_edit_stream_bytes_hand_counted():
    # row 1: 10 nodes -> 2 bits each = 20 bits = 3 B; 7 ops * 9 B = 63
    # row 2: 50 nodes -> 100 bits = 13 B; 4 ops = 36
    # row 3: no op -> 0
    assert roofline.edit_stream_bytes([(10, 3, 7), (50, 0, 4),
                                       (8, 0, 0)]) == 3 + 63 + 13 + 36


def test_bytes_do_not_depend_on_padding_or_variant():
    rows = [(64, 4, 97)] * 3
    assert roofline.rga_bytes(rows) == 3 * (20 * 4 + 4)
    assert roofline.edit_stream_bytes(rows) == 3 * (16 + 9 * 97)


@pytest.mark.parametrize('name, family', [
    ('rga_narrow_kernel', 'rga'),
    # as the profiler names them on the card
    ('void (anonymous namespace)::rga_narrow_kernel<4>(int const*, int '
     'const*, int const*, int const*, unsigned char const*)', 'rga'),
    ('void (anonymous namespace)::es_grid_kernel<4>(int, int const*, '
     'unsigned char const*)', 'edit_stream'),
    ('void (anonymous namespace)::rga_wide_kernel<true>(int const*)',
     'rga'),
    ('void rga_wide_kernel(int const*, int*)', 'rga'),
    ('rga_subwarp_delta_kernel', 'rga'),
    ('rga_grid_kernel', 'rga'),
    ('es_warp_kernel', 'edit_stream'),
    ('es_block_kernel', 'edit_stream'),
    ('es_grid_kernel', 'edit_stream'),
    ('fm_warp_kernel', None),
    ('grid_barrier_kernel', None),
    ('Memcpy DtoH (Device -> Pageable)', None),
    ('void at::native::vectorized_elementwise_kernel<4>', None),
])
def test_kernel_families(name, family):
    assert roofline.family_of(name) == family


def _record(device, rows):
    rec = Record()
    rec.ticks = [{'t0': 0.0, 't_apply': 0.5, 't1': 1.0, 'ops': 1,
                  'changes': 1, 'rows': rows}]
    rec.device = device
    return rec


def test_share_hand_counted():
    rows = [(10, 3, 7)]              # rga 64 B, edit stream 66 B
    peak = roofline.PEAKS['hbm_bytes_per_s']
    t_rga = 64 / peak                # exactly at the roofline
    rec = _record([('rga_narrow_kernel', 0.1, 0.1 + 2 * t_rga),
                   ('es_warp_kernel', 0.2, 0.2 + 66 / peak * 4)], rows)
    assert roofline.share(rec, 'rga') == pytest.approx(50.0)
    assert roofline.share(rec, 'edit_stream') == pytest.approx(25.0)


def test_share_silent_without_its_kernels():
    rec = _record([('fm_warp_kernel', 0.1, 0.2)], [(10, 3, 7)])
    assert roofline.share(rec, 'rga') is None
    rec.device = None
    assert roofline.share(rec, 'edit_stream') is None
