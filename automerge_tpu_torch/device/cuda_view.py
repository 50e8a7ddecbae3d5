"""Fused patch-read kernel: winner/visibility diff -> pre-ordered,
delta-sized edit buffers, in ONE device launch (PyTorch + CUDA).

The port of ``automerge_tpu/device/pallas_view.py``. Per dirty sequence
object (one row per job) each node falls into one class — remove
``pv & ~nv``, insert ``nv & ~pv``, set ``nv & pv & touched`` — and each
class is ranked in document order with an exclusive prefix sum over a
presence grid keyed by the dense vis index (no sort: vis indexes are
already dense ranks), then compacted into -1-padded ``[K, e_pad]``
buffers plus the per-class counts. ``GeneralPatch._ensure`` reads those
delta-sized buffers instead of the full O(doc) vis planes.

Two implementations, bit-identical by construction:

* :func:`edit_stream` / :func:`edit_stream_packed` /
  :func:`edit_stream_wide` — the plain PyTorch version (scatter + cumsum
  + gather) over the cols, packed and wide vis formats. It is the
  specification, the CPU path of :func:`dispatch_edit_stream`, and what
  ``chip_smoke.py`` holds the kernel against on the card.
* :func:`edit_stream_cuda` — the hand-written CUDA kernel
  (``csrc/edit_stream.cu``), built with nvcc for ``sm_90a`` on first use
  into ``_build/`` and bound with ctypes. It replaces the TPU kernel
  ``_make_edit_kernel`` / ``_edit_stream_pallas_core`` /
  ``edit_stream_pallas`` (``automerge_tpu/device/pallas_view.py``
  :145-258), whose one-hot MXU matmuls existed only because the TPU
  lacks a fast gather. Rows up to :data:`M_WARP_ES` nodes take one warp
  each (several rows to a CTA): the warp decodes its row once into
  registers, keeps each class's presence as a bitmask of ceil(m/32)
  words in shared memory and ranks a node with a popcount prefix over
  those words. Wider rows take one thread block each (``'block'``),
  with the same bitmasks (in a global scratch of ``K * 6 * ceil(m/32)``
  words past the shared-memory cap, ``'block-global'``) — or, when so
  few rows would leave most SMs idle (a long text's one row), one
  cooperative launch that spreads them over the whole card with the
  bitmasks in a global scratch and grid barriers between its phases
  (``'grid'``). :func:`variant` says which a shape takes.

:func:`dispatch_edit_stream` launches the kernel for every CUDA tensor
(raising if the build or the launch fails — there is no fallback) and
runs the plain version only for tensors on the CPU. A long text (the
wide format, one row of m > 512 nodes) takes the grid variant.
"""

import ctypes

import numpy as np
import torch

from . import cuda_build, cuda_grid
from ..config import as_tensor

_I32 = torch.int32

_W2_ELEM = 0x7FFF
_W2_VIS_SHIFT = 30
_W2_IDX_SHIFT = 15
_WIDE_IDX_MASK = (1 << 22) - 1
_WIDE_VIS_SHIFT = 22

# rows up to this many nodes take the warp-per-row variant, wider rows
# the block-per-row one (the crossover measured on an H100: PERF.md)
M_WARP_ES = 512
# ... or the grid variant while there are at most this many of them at a
# width up to the band's bound: the crossover table measured on an H100
# (tools/torch_kernel_ab.py --single-row, PERF.md) — up to 2,048 nodes
# the block per row wins at every row count, from 4,096 to the block's
# shared-memory cap the grid wins through 32 rows, past it (the block's
# bitmasks in global memory) at every row count measured, up to 528
GRID_BANDS = ((2048, 0), (273056, 32), (None, 528))

# launches of the CUDA kernel since the last reset by (mode, variant):
# mode the vis format ('packed', 'wide' or 'cols'), variant as
# :func:`variant` names it; counted in edit_stream_cuda where the kernel
# launches and nowhere else — the proof that a run went through it
launches = {}
# the variant of the latest launch ('warp', 'block', 'block-global' or
# 'grid')
last_variant = None

# input formats and variants of the kernel's C entry point
_FMT_PACKED, _FMT_COLS, _FMT_WIDE = 0, 1, 2
_VARIANT_CODES = {'warp': 0, 'block': 1, 'block-global': 1, 'grid': 2}

# variant, fmt, 5 input planes, touched, 5 outputs, cnt, scratch, K, m,
# mb, e_pad, stream
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
             + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def reset_launches():
    global last_variant
    last_variant = None
    launches.clear()


def block_fits_smem(m):
    """Whether the block variant's bitmasks (6 words per 32 nodes) fit
    its shared-memory cap at width ``m`` (the C side's
    ``edit_stream_block_uses_smem``)."""
    return 6 * ((m + 31) >> 5) * 4 <= cuda_build.SMEM_LIMIT


def variant(K, m, force=None):
    """The kernel variant a launch of ``K`` rows at width ``m`` takes:
    ``'warp'`` (one warp per row) up to :data:`M_WARP_ES` nodes, else
    ``'grid'`` (the rows over the whole card) for as many rows as
    :data:`GRID_BANDS` sends there and one grid launch takes, else
    ``'block'`` (one thread block per row), ``'block-global'`` when the
    block's bitmasks exceed the shared-memory cap. ``force`` ('warp',
    'block' or 'grid') overrides the shape's pick. A pure function of
    the shape."""
    if force is None:
        force = 'warp' if m <= M_WARP_ES else \
            'grid' if K <= cuda_grid.band_rows(GRID_BANDS, m) and \
            cuda_grid.fits(K, K * m) else 'block'
    if force not in ('warp', 'block', 'grid'):
        raise ValueError(f'unknown edit-stream variant {force!r}')
    if force == 'block' and not block_fits_smem(m):
        return 'block-global'
    return force


def _unpack_touch(touched_u8, m):
    """MSB-first bit unpack of the host-built touched plane (one bit
    per (job, node) slot; np.packbits layout along the node axis)."""
    i = torch.arange(m, device=touched_u8.device)
    return ((touched_u8[:, i >> 3].to(torch.int32) >> (7 - (i & 7))) & 1) \
        .to(torch.bool)


def _edit_core(pv, nv, pi, ni, touched, e_pad):
    """The plain edit-stream pipeline over [K, m] planes. Returns
    (rm_idx, ins_node, ins_idx, set_node, set_idx, cnts[K, 3]), all
    int32; the [K, e_pad] buffers are -1 padded, each class compacted in
    document order (removes ascending by PRIOR index — the host reads
    them reversed for the descending emit; inserts/sets ascending by
    NEW index). Counts are not clamped; ranks >= e_pad are dropped."""
    K, m = pv.shape
    dev = pv.device
    iota_l = torch.arange(m, dtype=_I32, device=dev)[None, :].expand(K, m)
    removed = pv & ~nv
    inserted = nv & ~pv
    setd = nv & pv & touched

    def compact(mask, key, vals):
        # ranks via presence-grid prefix sum: `key` is a dense per-object
        # rank (a vis index), unique among mask rows — column m is the
        # sink for unmasked rows
        key_c = key.to(torch.int64).clamp(0, m - 1)
        grid = torch.zeros((K, m + 1), dtype=_I32, device=dev)
        grid.scatter_(1, torch.where(mask, key_c, torch.full_like(key_c, m)),
                      torch.ones((K, m), dtype=_I32, device=dev))
        grid = grid[:, :m]
        rank_g = torch.cumsum(grid, dim=1, dtype=_I32) - grid
        rank = torch.gather(rank_g, 1, key_c)
        tgt = torch.where(mask & (rank < e_pad), rank.to(torch.int64),
                          torch.full_like(key_c, e_pad))
        outs = []
        for v in vals:
            o = torch.full((K, e_pad + 1), -1, dtype=_I32, device=dev)
            o.scatter_(1, tgt, v.to(_I32))
            outs.append(o[:, :e_pad])
        return outs, mask.sum(dim=1, dtype=_I32)

    (rm_idx,), rm_cnt = compact(removed, pi, (pi,))
    (ins_node, ins_idx), ins_cnt = compact(inserted, ni, (iota_l, ni))
    (set_node, set_idx), set_cnt = compact(setd, ni, (iota_l, ni))
    cnts = torch.stack([rm_cnt, ins_cnt, set_cnt], dim=1)
    return rm_idx, ins_node, ins_idx, set_node, set_idx, cnts


def edit_stream(pv, nv, pi, ni, touched_u8, *, e_pad):
    """Plain edit stream over unpacked planes (cols vis format). The
    three plain entry points take tensors or any other array
    (:func:`~automerge_tpu_torch.config.as_tensor`), as the reference's
    take any array."""
    pv, nv, pi, ni, touched_u8 = map(as_tensor,
                                     (pv, nv, pi, ni, touched_u8))
    m = pv.shape[1]
    return _edit_core(pv.to(torch.bool), nv.to(torch.bool), pi.to(_I32),
                      ni.to(_I32), _unpack_touch(touched_u8, m), e_pad)


def _decode_packed(v):
    pv = ((v >> 31) & 1).to(torch.bool)
    nv = ((v >> _W2_VIS_SHIFT) & 1).to(torch.bool)
    pi = ((v >> _W2_IDX_SHIFT) & _W2_ELEM) - 1
    ni = (v & _W2_ELEM) - 1
    return pv, nv, pi, ni


def edit_stream_packed(vis_packed, touched_u8, *, e_pad):
    """Plain edit stream over the packed apply's vis word plane
    (prior_vis<<31 | visible<<30 | (prior_idx+1)<<15 | (new_idx+1))."""
    vis_packed, touched_u8 = map(as_tensor, (vis_packed, touched_u8))
    m = vis_packed.shape[1]
    pv, nv, pi, ni = _decode_packed(vis_packed.to(_I32))
    return _edit_core(pv, nv, pi, ni, _unpack_touch(touched_u8, m), e_pad)


def _decode_wide(vis_prior, vis_new):
    pv = ((vis_prior >> _WIDE_VIS_SHIFT) & 1).to(torch.bool)
    nv = ((vis_new >> _WIDE_VIS_SHIFT) & 1).to(torch.bool)
    pi = (vis_prior & _WIDE_IDX_MASK) - 1
    ni = (vis_new & _WIDE_IDX_MASK) - 1
    return pv, nv, pi, ni


def edit_stream_wide(vis_prior, vis_new, touched_u8, *, e_pad):
    """Plain edit stream over the wide apply's two vis word planes
    (``visible << 22 | (idx + 1)`` each)."""
    vis_prior, vis_new, touched_u8 = map(as_tensor,
                                         (vis_prior, vis_new, touched_u8))
    m = vis_prior.shape[1]
    pv, nv, pi, ni = _decode_wide(vis_prior.to(_I32), vis_new.to(_I32))
    return _edit_core(pv, nv, pi, ni, _unpack_touch(touched_u8, m), e_pad)


def edit_stream_cuda(vis_fmt, planes, touched_u8, e_pad, force=None):
    """Launch the CUDA edit-stream kernel on one apply's vis planes:
    ``vis_fmt='packed'`` takes the int32 [K, m] vis word plane,
    ``'wide'`` the (vis_prior, vis_new) int32 [K, m] word planes,
    ``'cols'`` the (prior_vis bool, visible bool, prior_idx int32,
    new_idx int32) [K, m] planes. ``touched_u8`` is the uint8
    [K, ceil(m/8)] packbits plane. Returns the same six int32 tensors as
    :func:`edit_stream_packed` / :func:`edit_stream`, on the card.
    ``force`` picks a variant regardless of the shape (see
    :func:`variant`).

    Bound: per call the kernel must read ``K*m*4 + K*ceil(m/8)`` bytes
    (packed; ``K*m*8 + K*ceil(m/8)`` wide) and write
    ``5*K*e_pad*4 + 12*K`` bytes; it does O(K*m) integer work, so it is
    bound by memory traffic and latency, not arithmetic. A long text's
    one row takes the grid variant: its four phases over every SM, with
    three grid barriers between them, set its time."""
    global last_variant
    if vis_fmt == 'packed':
        v = planes
        K, m = v.shape
        dev = v.device
        cuda_build.check(v, 'vis_packed', _I32, (K, m), dev)
        ptrs = [v.data_ptr(), 0, 0, 0, 0]
        fmt = _FMT_PACKED
    elif vis_fmt == 'wide':
        vp, vn = planes
        K, m = vp.shape
        dev = vp.device
        cuda_build.check(vp, 'vis_prior', _I32, (K, m), dev)
        cuda_build.check(vn, 'vis_new', _I32, (K, m), dev)
        ptrs = [vp.data_ptr(), 0, 0, 0, vn.data_ptr()]
        fmt = _FMT_WIDE
    elif vis_fmt == 'cols':
        pv, nv, pi, ni = planes
        K, m = pv.shape
        dev = pv.device
        cuda_build.check(pv, 'prior_vis', torch.bool, (K, m), dev)
        cuda_build.check(nv, 'visible', torch.bool, (K, m), dev)
        cuda_build.check(pi, 'prior_idx', _I32, (K, m), dev)
        cuda_build.check(ni, 'new_idx', _I32, (K, m), dev)
        ptrs = [0, pv.data_ptr(), nv.data_ptr(), pi.data_ptr(),
                ni.data_ptr()]
        fmt = _FMT_COLS
    else:
        raise ValueError(f'unknown vis format {vis_fmt!r}')
    if dev.type != 'cuda':
        raise ValueError('edit_stream_cuda needs CUDA tensors')
    mb = (m + 7) >> 3
    cuda_build.check(touched_u8, 'touched_u8', torch.uint8, (K, mb), dev)
    if e_pad < 1 or m < 1:
        raise ValueError(f'bad edit-stream shape m={m} e_pad={e_pad}')
    outs = [torch.empty((K, e_pad), dtype=_I32, device=dev)
            for _ in range(5)]
    cnt = torch.empty((K, 3), dtype=_I32, device=dev)
    if K == 0:                  # no job rows: nothing to launch
        return (*outs, cnt)
    var = variant(K, m, force)
    if var == 'grid':
        cuda_grid.check(K, K * m)
    fn = cuda_build.load('edit_stream', 'edit_stream_launch', _ARGTYPES)
    # the block variant's bitmasks past the shared-memory cap, 6 words
    # per 32 nodes and row; the grid variant's, and its chunk table
    scratch = None
    if var == 'block-global':
        scratch = torch.empty((K, 6 * ((m + 31) >> 5)), dtype=_I32,
                              device=dev)
    elif var == 'grid':
        words = cuda_build.load('edit_stream',
                                'edit_stream_grid_scratch_words',
                                [ctypes.c_int] * 2, ctypes.c_longlong)(K, m)
        scratch = torch.empty(words, dtype=_I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            _VARIANT_CODES[var], fmt, *ptrs,
            touched_u8.data_ptr(), *[o.data_ptr() for o in outs],
            cnt.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            K, m, mb, e_pad, stream)
    if err != 0:
        raise RuntimeError(f'edit_stream kernel launch failed ({var} '
                           f'variant): CUDA error {err}')
    last_variant = var
    launches[vis_fmt, var] = launches.get((vis_fmt, var), 0) + 1
    return (*outs, cnt)


def dispatch_edit_stream(vis_fmt, planes, touched_u8, e_pad):
    """Run the edit stream over one apply's vis planes (the fused
    apply's device outputs) — the entry point ``GeneralPatch._ensure``
    calls. CUDA planes always go through the CUDA kernel; CPU planes
    take the plain version. ``touched_u8`` is the host numpy packbits
    plane; it moves to the planes' device."""
    lead = planes if vis_fmt == 'packed' else planes[0]
    dev = lead.device
    t_u8 = torch.as_tensor(np.ascontiguousarray(touched_u8),
                           dtype=torch.uint8).to(dev)
    if dev.type == 'cuda':
        if vis_fmt == 'packed':
            planes = planes.contiguous()
        else:
            planes = tuple(p.contiguous() for p in planes)
        return edit_stream_cuda(vis_fmt, planes, t_u8, e_pad)
    if vis_fmt == 'packed':
        return edit_stream_packed(planes, t_u8, e_pad=e_pad)
    if vis_fmt == 'wide':
        return edit_stream_wide(*planes, t_u8, e_pad=e_pad)
    if vis_fmt == 'cols':
        return edit_stream(*planes, t_u8, e_pad=e_pad)
    raise ValueError(f'unknown vis format {vis_fmt!r}')
