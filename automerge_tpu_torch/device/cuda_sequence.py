"""RGA ordering on the card: the hand-written CUDA kernels
(``csrc/rga_order.cu``) behind ``sequence._rga_order_batched``.

The port of ``automerge_tpu/device/pallas_sequence.py``. The kernels
replace ``_make_kernel`` / ``_rga_pallas_padded`` /
``rga_order_batch_pallas`` (``pallas_sequence.py`` :63-208), whose
one-hot MXU matmuls existed only because the TPU lacks a fast gather,
and unlike the TPU kernel also emit ``tree_pos`` and ``node_at_pos``,
which the general engine's rebuild writes back. They are built with
nvcc for ``sm_90a`` on first use into ``_build/`` and bound with
ctypes; :func:`variant` says which one a shape takes:

* :func:`rga_order_cuda` — the narrow variant, for rows up to
  :data:`M_NARROW` nodes: one warp per job row, several rows to a CTA,
  straight from the raw planes. The child sort (parent ascending, elem
  and actor descending, stable) is a rank count inside the kernel; then
  the threading, the ancestor climb, the list ranking and the
  visibility scan, all in the warp's slice of shared memory. Its plain
  version is ``sequence._rga_order_plain``.
* :func:`rga_wide_cuda` — the wide variant, for rows past
  :data:`M_NARROW` nodes that are not a few long ones: one thread block
  of 1,024 threads per job row, straight from the raw planes, the child
  sort included (a stable LSD radix sort in shared memory), on the row's
  valid extent where every valid node hangs under the head or an
  earlier valid node (:func:`wide_extent`), with the doubling rounds
  stopped once nothing changes. ``'wide'`` keeps the row in shared
  memory (:func:`wide_fits_smem`), ``'wide-global'`` runs the same code
  on a global scratch past it. Its plain version is
  ``sequence._rga_order_plain``; with an anchor plane it is the delta
  mode's wide variant (``sequence._rga_delta_order_plain``).
* :func:`order_from_sorted_cuda` — the grid variant (``'wide-grid'``),
  from the permutation of a PyTorch stable child sort
  (``sequence._child_sort``): one cooperative launch that spreads the
  rows over every SM, its phases separated by grid barriers — for the
  few long rows (a long text, a replayed editing trace) that would leave
  all but a few SMs idle with one block each. Its plain version is
  ``sequence._order_from_sorted_plain``.
* :func:`rga_delta_cuda` — the delta mode, behind the incremental
  index update: one tick's delta forest, with the anchor plane as one
  more sort key word between the parent and the elem, ``tree_pos`` its
  only output. Rows up to :data:`M_SUBWARP` nodes (a warm tick's few
  new nodes a document) take the subwarp variant: 32 / W rows a warp,
  one group of W lanes a row (W the next power of two at or above the
  width), every gather a shuffle within the group; wider rows the
  narrow kernel, one warp a row. Its plain version is
  ``sequence._rga_delta_order_plain``; wider delta planes take
  :func:`rga_wide_cuda` with the anchor plane (or, a few long rows, the
  PyTorch sort with the anchor key and the grid variant).

``sequence._rga_order_batched`` and ``sequence._rga_delta_order_batched``
launch one of them for every CUDA tensor (raising if the build or the
launch fails — there is no fallback) and run the plain version only for
tensors on the CPU.
"""

import ctypes

import torch

from . import cuda_build, cuda_grid

_I32 = torch.int32

# rows up to this many nodes take the narrow variant: on an H100 its step
# beats the PyTorch sort + wide kernel at every width it takes, up to its
# own limit of 512 nodes (a lane's 16 register slots; PERF.md)
M_NARROW = 512

# delta rows up to this many nodes take the subwarp variant, its own
# limit (a warp): on an H100 it beats the narrow kernel's delta mode at
# every width up to it, at 1,024 and at 12,288 rows (1.03-5.7x;
# tools/torch_kernel_ab.py --delta, PERF.md)
M_SUBWARP = 32

# wider rows take the grid variant while there are at most this many of
# them at a width up to the band's bound, else one block per row: the
# crossover table measured on an H100 (tools/torch_kernel_ab.py --wide,
# whole steps from a graph, K in 1, 2, 4, 8, 32, 132; PERF.md) — the
# wide kernel (its sort inside) beats the PyTorch sort + grid step at
# every row count up to 14,336 nodes; the grid step wins through 4 rows
# at 16,384, 8 at 24,576 and 32 from 32,768, and loses at 132 everywhere
GRID_BANDS = ((14336, 0), (16384, 4), (24576, 8), (None, 32))
# the same for the delta mode's wide rows (the delta orderer's forests,
# the anchor key in the sort): the grid step wins through 1 row at
# 16,384, 8 at 24,576 and 32,768, 32 at 49,152
DELTA_GRID_BANDS = ((14336, 0), (16384, 1), (32768, 8), (None, 32))

# launches of the CUDA kernels since the last reset by (mode, variant):
# mode 'order' (rga_order_cuda, rga_wide_cuda, order_from_sorted_cuda)
# or 'delta' (rga_delta_cuda, rga_wide_cuda with an anchor plane),
# variant as :func:`variant` or :func:`delta_variant` names it; counted
# where a kernel launches and nowhere else — the proof that a run went
# through them
launches = {}
# the variant of the latest launch ('narrow', 'subwarp', 'wide',
# 'wide-global' or 'wide-grid')
last_variant = None

# order, parent_adj, parent, visible, valid, tree_pos, vis_index,
# node_at_pos, length, scratch, K, m, rounds, stream (the grid variant)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# parent, elem, actor, visible, valid, tree_pos, vis_index, node_at_pos,
# length, K, m, rounds, stream
_NARROW_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p]
# global, parent, elem, actor, anchor, visible, valid, tree_pos,
# vis_index, node_at_pos, length, scratch, K, m, rounds, stream
_WIDE_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 11 + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
# variant, parent, anchor, elem, actor, valid, tree_pos, K, m, rounds,
# stream
_DELTA_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
# variant codes of rga_delta_run
_DELTA_VARIANTS = {'narrow': 0, 'subwarp': 1}


def reset_launches():
    global last_variant
    last_variant = None
    launches.clear()


def _count(mode, v):
    global last_variant
    last_variant = v
    launches[mode, v] = launches.get((mode, v), 0) + 1


# the wide variant's dynamic shared memory (csrc/rga_order.cu
# kWideDynLimit): the H100's 232,448 bytes a block less the 17 KB its
# static storage may take (the count table of the sort, 16 KB)
WIDE_SMEM_LIMIT = 232448 - 17 * 1024


def wide_smem_bytes(m, delta=False):
    """Dynamic shared memory of the wide variant at width ``m`` (the C
    side's ``wide_smem_bytes``): five int32 planes of m + 1 words rounded
    up to four (six with the delta mode's anchor) and the valid and
    visible bytes rounded up to 16 (valid only in the delta mode)."""
    words = (m + 4) & ~3
    r16 = (m + 15) & ~15
    return (6 if delta else 5) * 4 * words + (1 if delta else 2) * r16


def wide_fits_smem(m, delta=False):
    """Whether the wide variant keeps a row of width ``m`` in shared
    memory (the C side's ``rga_wide_uses_smem``): m <= 9,771, the delta
    mode m <= 8,599."""
    return wide_smem_bytes(m, delta) <= WIDE_SMEM_LIMIT


def uses_global_scratch(m, delta=False):
    """The C side's answer to :func:`wide_fits_smem`, negated: whether a
    wide launch at width ``m`` works on a global-memory scratch."""
    fn = cuda_build.load('rga_order', 'rga_wide_uses_smem',
                         [ctypes.c_int] * 2)
    return not fn(m, int(delta))


def wide_extent(parent, valid):
    """The slots per row the wide variant works on (int64 [K]): the valid
    extent E (one past the last valid node, at least 1) where every valid
    node but node 0 has as parent the head (0) or an earlier valid node,
    else the whole width — the kernel's block vote, as a pure function of
    the planes. The rest of such a row is padding, whose outputs are
    fixed. No launch path calls it (the kernel votes on the card); it
    serves the tests, ``chip_smoke.py`` and the bytes of the kernel's
    bound."""
    n = parent.shape[1]
    valid = valid.to(torch.bool)
    idx = torch.arange(n, device=parent.device)
    last = torch.where(valid, idx, torch.full_like(idx, -1)).amax(dim=1)
    ext = (last + 1).clamp(min=1)
    p = parent.to(torch.int64)
    under = torch.gather(valid, 1, p.clamp(0, n - 1))
    ok = (p == 0) | ((p > 0) & (p < idx) & under)
    bad = (valid & (idx > 0) & ~ok).any(dim=1)
    return torch.where(bad, torch.full_like(ext, n), ext)


def sorted_variant(K, m, delta=False):
    """The variant a row past :data:`M_NARROW` takes at ``K`` rows of
    width ``m``: ``'wide-grid'`` for a few rows (:data:`GRID_BANDS`, with
    ``delta`` :data:`DELTA_GRID_BANDS`, within one grid launch's limits),
    else ``'wide'``, or ``'wide-global'`` past the wide variant's
    shared-memory cap (``delta``: the delta mode's). A pure function of
    the shape."""
    bands = DELTA_GRID_BANDS if delta else GRID_BANDS
    if M_NARROW < m and K <= cuda_grid.band_rows(bands, m) and \
            cuda_grid.fits(K, K * (m + 1)):
        return 'wide-grid'
    return 'wide' if wide_fits_smem(m, delta) else 'wide-global'


def variant(K, m):
    """The kernel variant ``sequence._rga_order_batched`` takes on the
    card at ``K`` rows of width ``m``: ``'narrow'`` up to
    :data:`M_NARROW` nodes, else :func:`sorted_variant`'s."""
    return 'narrow' if m <= M_NARROW else sorted_variant(K, m)


def delta_variant(K, m):
    """The kernel variant ``sequence._rga_delta_order_batched`` takes on
    the card at ``K`` rows of width ``m``: ``'subwarp'`` up to
    :data:`M_SUBWARP` nodes, ``'narrow'`` up to :data:`M_NARROW`, past it
    :func:`sorted_variant`'s for the delta mode (the wide variant with
    the anchor plane, or the sort with the anchor key and the grid)."""
    if m <= M_SUBWARP:
        return 'subwarp'
    return 'narrow' if m <= M_NARROW else sorted_variant(K, m, delta=True)


def _outputs(K, m, dev):
    return {'tree_pos': torch.empty((K, m), dtype=_I32, device=dev),
            'vis_index': torch.empty((K, m), dtype=_I32, device=dev),
            'node_at_pos': torch.empty((K, m), dtype=_I32, device=dev),
            'length': torch.empty((K,), dtype=_I32, device=dev)}


def rga_order_cuda(parent, elem, actor, visible, valid, rounds):
    """Launch the narrow RGA kernel on contiguous CUDA [K, m] raw planes
    (m <= :data:`M_NARROW`): int32 ``parent``, ``elem``, ``actor``
    and bool ``visible``/``valid``. ``rounds`` is the doubling round
    count. Returns the dict of ``sequence._rga_order_plain``: int32
    ``tree_pos``, ``vis_index``, ``node_at_pos`` [K, m] and ``length``
    [K].

    Bound: per call the kernel must read ``K*m*14`` bytes and write
    ``K*m*12 + K*4`` bytes; each row's chain of O(m log m) dependent
    shared-memory steps (and its m^2/32 compares a lane for the sort)
    sets the time at the main path's width."""
    K, m = parent.shape
    dev = parent.device
    if dev.type != 'cuda':
        raise ValueError('rga_order_cuda needs CUDA tensors')
    if not 1 <= m <= M_NARROW or rounds < 1:
        raise ValueError(f'bad narrow RGA shape m={m} rounds={rounds}')
    for t, name in ((parent, 'parent'), (elem, 'elem'), (actor, 'actor')):
        cuda_build.check(t, name, _I32, (K, m), dev)
    cuda_build.check(visible, 'visible', torch.bool, (K, m), dev)
    cuda_build.check(valid, 'valid', torch.bool, (K, m), dev)
    out = _outputs(K, m, dev)
    if K == 0:                  # no job rows: nothing to launch
        return out
    fn = cuda_build.load('rga_order', 'rga_narrow_launch', _NARROW_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(parent.data_ptr(), elem.data_ptr(), actor.data_ptr(),
                 visible.data_ptr(), valid.data_ptr(),
                 out['tree_pos'].data_ptr(), out['vis_index'].data_ptr(),
                 out['node_at_pos'].data_ptr(), out['length'].data_ptr(),
                 K, m, rounds, stream)
    if err != 0:
        raise RuntimeError(f'rga_order narrow kernel launch failed: CUDA '
                           f'error {err}')
    _count('order', 'narrow')
    return out


def rga_delta_cuda(parent, anchor, elem, actor, valid, rounds,
                   force=None):
    """Launch the RGA kernel's delta mode on contiguous CUDA [K, m] delta
    planes (m <= :data:`M_NARROW`): int32 ``parent``, ``anchor``,
    ``elem``, ``actor`` and bool ``valid``. Returns int32 ``tree_pos``
    [K, m], equal to ``sequence._rga_delta_order_plain`` on the valid
    rows (the rest is padding, which no caller reads). The variant is
    :func:`delta_variant`'s, or ``force`` (``'narrow'``, or
    ``'subwarp'`` up to :data:`M_SUBWARP` nodes).

    Bound: per call the kernel must read ``K*m*17`` bytes and write
    ``K*m*4`` (the tree positions, its only output); a delta plane is a
    few nodes wide, so each row's chain of dependent steps sets the
    time, and the subwarp variant runs several rows' chains in one warp
    at once."""
    K, m = parent.shape
    dev = parent.device
    if dev.type != 'cuda':
        raise ValueError('rga_delta_cuda needs CUDA tensors')
    if not 1 <= m <= M_NARROW or rounds < 1:
        raise ValueError(f'bad delta RGA shape m={m} rounds={rounds}')
    v = force or delta_variant(K, m)
    if v not in _DELTA_VARIANTS or (v == 'subwarp' and m > M_SUBWARP):
        raise ValueError(f'the delta mode has no variant {v!r} at m={m}')
    for t, name in ((parent, 'parent'), (anchor, 'anchor'), (elem, 'elem'),
                    (actor, 'actor')):
        cuda_build.check(t, name, _I32, (K, m), dev)
    cuda_build.check(valid, 'valid', torch.bool, (K, m), dev)
    tree_pos = torch.empty((K, m), dtype=_I32, device=dev)
    if K == 0:                  # no job rows: nothing to launch
        return tree_pos
    fn = cuda_build.load('rga_order', 'rga_delta_run', _DELTA_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_DELTA_VARIANTS[v], parent.data_ptr(), anchor.data_ptr(),
                 elem.data_ptr(), actor.data_ptr(), valid.data_ptr(),
                 tree_pos.data_ptr(), K, m, rounds, stream)
    if err != 0:
        raise RuntimeError(f'rga_order delta kernel launch failed ({v} '
                           f'variant): CUDA error {err}')
    _count('delta', v)
    return tree_pos


def rga_wide_cuda(parent, elem, actor, visible, valid, rounds, anchor=None,
                  force=None):
    """Launch the wide RGA kernel on contiguous CUDA [K, m] raw planes:
    int32 ``parent``, ``elem``, ``actor``, bool ``visible``/``valid``;
    ``rounds`` bounds the doubling rounds. Returns the dict of
    ``sequence._rga_order_plain``: int32 ``tree_pos``, ``vis_index``,
    ``node_at_pos`` [K, m] and ``length`` [K]. With ``anchor`` (int32
    [K, m]) it is the delta mode: ``visible`` is not read and the result
    is int32 ``tree_pos`` [K, m], equal to
    ``sequence._rga_delta_order_plain`` on the valid rows. The variant is
    ``'wide'`` (the row in shared memory) where :func:`wide_fits_smem`,
    else ``'wide-global'``, or ``force`` (``'wide-global'`` at any
    width).

    Bound: per call the kernel must read ``K*m*14`` bytes (the delta
    mode ``K*m*17``) and write ``K*m*12 + K*4`` (``K*m*4``); where the
    rows are padding past a valid extent it needs only their valid bytes
    and fixed outputs. Each row's chain of dependent sweeps (the sort's
    passes, then the doubling rounds until nothing changes) sets the
    time."""
    K, m = parent.shape
    dev = parent.device
    delta = anchor is not None
    if dev.type != 'cuda':
        raise ValueError('rga_wide_cuda needs CUDA tensors')
    if m < 1 or rounds < 1:
        raise ValueError(f'bad wide RGA shape m={m} rounds={rounds}')
    v = force or ('wide' if wide_fits_smem(m, delta) else 'wide-global')
    if v not in ('wide', 'wide-global') or \
            (v == 'wide' and not wide_fits_smem(m, delta)):
        raise ValueError(f'the wide RGA kernel has no variant {v!r} at '
                         f'm={m}')
    planes = ((parent, 'parent'), (elem, 'elem'), (actor, 'actor')) + \
        (((anchor, 'anchor'),) if delta else ())
    for t, name in planes:
        cuda_build.check(t, name, _I32, (K, m), dev)
    if not delta:
        cuda_build.check(visible, 'visible', torch.bool, (K, m), dev)
    cuda_build.check(valid, 'valid', torch.bool, (K, m), dev)
    out = {'tree_pos': torch.empty((K, m), dtype=_I32, device=dev)} \
        if delta else _outputs(K, m, dev)
    if K == 0:                  # no job rows: nothing to launch
        return out['tree_pos'] if delta else out
    scratch = None
    if v == 'wide-global':
        words = cuda_build.load('rga_order', 'rga_wide_scratch_words',
                                [ctypes.c_int], ctypes.c_longlong)(m)
        scratch = torch.empty((K, words), dtype=_I32, device=dev)
    fn = cuda_build.load('rga_order', 'rga_wide_launch', _WIDE_ARGTYPES)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(int(v == 'wide-global'), parent.data_ptr(),
                 elem.data_ptr(), actor.data_ptr(), ptr(anchor),
                 0 if delta else visible.data_ptr(), valid.data_ptr(),
                 *(ptr(out.get(k)) for k in ('tree_pos', 'vis_index',
                                             'node_at_pos', 'length')),
                 ptr(scratch), K, m, rounds, stream)
    if err != 0:
        raise RuntimeError(f'rga_order wide kernel launch failed ({v} '
                           f'variant): CUDA error {err}')
    _count('delta' if delta else 'order', v)
    return out['tree_pos'] if delta else out


def order_from_sorted_cuda(order, parent_adj, parent, visible, valid,
                           rounds):
    """Launch the grid variant of the RGA kernel on the output of a
    PyTorch child sort, contiguous CUDA [K, m] planes: int32 ``order``
    (the stable child sort), ``parent_adj`` (head and padding at m) and
    ``parent``, bool ``visible``/``valid``. ``rounds`` is the doubling
    round count. Returns the plain version's dict of int32 ``tree_pos``,
    ``vis_index``, ``node_at_pos`` [K, m] and ``length`` [K]. The main
    paths launch it for ``'wide-grid'`` rows only (a delta orderer's
    sort carried the anchor key; only ``tree_pos`` is read); at any other
    shape it runs as well, if one grid launch takes the rows
    (:func:`cuda_grid.check`).

    Bound: per call the kernel must read ``K*m*14`` bytes and write
    ``K*m*12 + K*4`` bytes. Its O(K*m*log m) pointer-doubling loads are
    ``2*rounds`` dependent steps, run over the whole card with a grid
    barrier between steps — at the few long rows it takes, the barriers
    and each step's dependent L2 load set its time, not bytes."""
    K, m = order.shape
    dev = order.device
    if dev.type != 'cuda':
        raise ValueError('order_from_sorted_cuda needs CUDA tensors')
    if m < 1 or rounds < 1:
        raise ValueError(f'bad RGA shape m={m} rounds={rounds}')
    for t, name in ((order, 'order'), (parent_adj, 'parent_adj'),
                    (parent, 'parent')):
        cuda_build.check(t, name, _I32, (K, m), dev)
    cuda_build.check(visible, 'visible', torch.bool, (K, m), dev)
    cuda_build.check(valid, 'valid', torch.bool, (K, m), dev)
    cuda_grid.check(K, K * (m + 1))
    out = _outputs(K, m, dev)
    if K == 0:                  # no job rows: nothing to launch
        return out
    fn = cuda_build.load('rga_order', 'rga_grid_launch', _ARGTYPES)
    words = cuda_build.load('rga_order', 'rga_grid_scratch_words',
                            [ctypes.c_int] * 2, ctypes.c_longlong)(K, m)
    scratch = torch.empty(words, dtype=_I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(order.data_ptr(), parent_adj.data_ptr(), parent.data_ptr(),
                 visible.data_ptr(), valid.data_ptr(),
                 out['tree_pos'].data_ptr(), out['vis_index'].data_ptr(),
                 out['node_at_pos'].data_ptr(), out['length'].data_ptr(),
                 scratch.data_ptr(), K, m, rounds, stream)
    if err != 0:
        raise RuntimeError(f'rga_order grid kernel launch failed: CUDA '
                           f'error {err}')
    _count('order', 'wide-grid')
    return out
