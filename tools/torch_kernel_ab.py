"""Time the PyTorch port's CUDA kernels against another checkout's, in
turns, on one CUDA card; then the crossovers of this tree's variants.

    mkdir -p _archive/base && git archive <commit> | tar -x -C _archive/base
    python3 tools/torch_kernel_ab.py --base _archive/base \\
        [--kernels flatmap_resolve rga_order edit_stream]

The base checkout's kernels must have the C interfaces of this tree's
(``flatmap_resolve_run``, ``rga_narrow_launch`` and an
``edit_stream_launch`` that take their variant first), or, for the
flat-map kernel, its first one (``flatmap_resolve_launch``, which picks
the variant itself). The script builds
the base's ``csrc/<kernel>.cu`` with nvcc (``sm_90a``) into
``automerge_tpu_torch/_build/base/`` beside this tree's kernels,
captures the inputs the main paths hand the kernels, and times at those
inputs in turns — base, this tree, this tree, base — with 5 timings of
50 launches a turn:

- ``flatmap_resolve``: the inputs of a ``--docs``-document map-only
  ``DeviceDocSet`` batch (``chip_smoke.py`` phase 5). The kernel alone,
  on buffers allocated once, 50 launches captured in a CUDA graph
  (device time), and again launch by launch with the L2 cache flushed
  before each (the inputs read from HBM); the call as the path pays it,
  eagerly (the base's output allocations and launch against this tree's
  ``dispatch_resolve``). Then the warp and block variants at the
  shapes the callers' padding buckets (``config.Options._pad``) give:
  N in ``CROSS_N``, A in ``CROSS_A``, S = N / 4 and S = N (a batch never
  has more fields than rows), where the warp's slice fits a CTA, each
  at D*N = 1,310,720 ops, the map batch's size.
- ``rga_order`` and ``edit_stream``: the inputs of a ``--docs``-document
  config-5 fleet, two ticks (``chip_smoke.py`` phase 4); each kernel
  alone, as above. Then the RGA order's narrow and wide kernels (both
  sort inside) at m in {64, 128, 256, 512} (from a graph and eagerly,
  random trees) and the edit
  stream's warp and block variants at m in {64, 256, 512, 1024, 4096}
  (packed, e_pad 64), each at K*m = 786,432 nodes.
- ``--single-row`` (that lane alone): the grid variants of the RGA order
  and the edit stream against the base's one-block-per-row kernels.
  First the floor under a grid round: an empty cooperative launch and
  one empty grid barrier (``FLOOR_SYNCS`` in one launch), against an
  empty plain launch from a graph and eagerly, at ``FLOOR_CTAS``. Then
  the single-row inputs of the main paths (config 4's replay of
  ``traces.gen_editing_trace(180000, seed=0)`` and its 60,001-change
  bulk line, the long text's rebuild arm), each checked equal on both
  sides and timed from a graph. Then the crossover tables, grid against
  one block per row on random trees (8 rows tiled to K): the RGA order
  at K in ``RGA_CROSS_K`` x m in ``RGA_CROSS_M``, the edit stream at K
  in ``ES_CROSS_K`` x m in ``ES_CROSS_M``, packed (m <= 32,768) and
  wide, e_pad 8 and m (10 launches a graph past 8M nodes). Run:
  ``python3 tools/torch_kernel_ab.py --base _archive/base --single-row
  --out chiprun_out/kernel_ab_single_row.json``.
- ``--split``: the flat-map kernel's split variant. At replica sync's
  union of one long document (``chip_smoke.peer_ops``, D = 1, N =
  65,536, S = 4,096, A = 16), checked equal first: the base's
  block-global variant against the split variant, from a graph and
  eagerly. Then the crossover table behind ``cuda_merge.SPLIT_BANDS``:
  the split variant against the variant the shape takes without it
  (``cuda_merge.variant(N, S, A)``) at D in ``SPLIT_CROSS_D``, N in
  ``SPLIT_CROSS_N``, S in {32, 4,096} and A in {8, 16}, on random
  device-made ops (``SPLIT_ITERS`` launches a graph); printed as the
  ratio of the two medians (the smallest of the four (S, A); above 1
  the split variant wins) with, for each N, the most documents at which
  the split variant won at all four, and the documents
  ``cuda_merge.SPLIT_BANDS`` sends to it.
- ``--delta``: the RGA kernel's delta mode. At config 5's tick-2 input
  (``--docs`` documents, K = 12,288, m = 9), checked equal first: the
  base's delta launch (one warp a row, four outputs) against the subwarp
  variant, and this tree's narrow variant (tree_pos only) against it.
  Then the crossover table behind ``cuda_sequence.M_SUBWARP``: subwarp
  against narrow at every m up to 32, K in ``DELTA_CROSS_K``, on seeded
  delta forests.

- ``--wide``: the wide RGA kernel (one block a row, its child sort
  inside) against the base's whole step for those rows: the PyTorch
  child sort (``sequence._child_sort``) and the base's one-block kernel
  (``rga_order_launch``, which the base must have). At phase 4h's K =
  1, m = 3,072 (a full random row), at ``chip_smoke.py`` phase 4i's tick
  1 (its captured planes: 2,048 rows at m = 6,144, 128 texts and 1,920
  padded lists), at 132 full random rows of m = 8,192 and at 132 full
  prepend rows of m = 8,192 (one sort bucket of 8,191 siblings), each
  checked equal first: the two steps in turns from a graph and eagerly,
  then the step's parts (the sort alone, the base kernel alone on a
  sort made once), each with its byte bound at 3.35 TB/s. Then the
  crossover tables behind ``cuda_sequence.GRID_BANDS`` and
  ``DELTA_GRID_BANDS``, rerun with the
  wide kernel as the one-block-a-row side: the wide kernel against the
  PyTorch sort + grid variant, whole steps from a graph, at K in
  ``WIDE_CROSS_K`` x m in ``WIDE_CROSS_M``, in both modes (the order on
  random trees; the delta mode on delta forests, the anchor plane to
  the wide kernel and as a sort key; 8 rows tiled to K), printed as the
  ratio of the medians (above 1 the grid step wins) with, for each m,
  the most rows at which the grid step won and the rows the bands send
  to it.

Prints one line per comparison (median, min and max of the 10 timings of
each side) and writes them all, with the card's name and power limit, to
``--out``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

NODES = 12288 * 64          # K*m of the main path's RGA and edit stream
OPS = 10240 * 128           # D*N of the main path's flat-map resolve
KERNELS = ('flatmap_resolve', 'rga_order', 'edit_stream')
# the flat-map variants' crossover grid: ops per document and actors,
# each a padding bucket of config.Options._pad
CROSS_N = (16, 64, 128, 512, 1024, 2048, 4096)
CROSS_A = (1, 2, 4, 8, 16, 24)
# bytes read between two launches of a cold timing: more than the
# H100's 50 MB L2 cache
FLUSH_BYTES = 256 << 20

# the flat-map kernel's first C interface (seg_id, actor, seq, clock,
# is_del, valid, surviving, winner, seg_max_actor, scratch, D, N, S, A,
# stream): cuda_merge._ARGTYPES without the leading variant
_FM_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]


def _stats(t):
    return {'median_ms': float(np.median(t)), 'min_ms': float(min(t)),
            'max_ms': float(max(t)), 'samples_ms': [float(x) for x in t]}


def cold_samples(fn, launches=25):
    """Device times, in ms, of ``launches`` single calls of ``fn``,
    each timed with its own CUDA events after a read of
    ``FLUSH_BYTES``, which evicts the call's inputs from the L2 cache
    (a read leaves no dirty lines to write back during the call). The
    read is queued ahead of the call, so the events time the device,
    not the host's launch."""
    import torch
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device='cuda').fill_(1.0)
    fn()
    ev = []
    for _ in range(launches):
        flush.sum()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        ev.append((t0, t1))
    torch.cuda.synchronize()
    return [t0.elapsed_time(t1) for t0, t1 in ev]


_TIMINGS = {'graph': 'device (CUDA graph)', 'eager': 'eager',
            'cold': 'device, one launch after an L2 flush'}


def in_turns(label, a_name, a_fn, b_name, b_fn, timing, results,
             iters=50):
    """Time ``a_fn`` and ``b_fn`` in the order a, b, b, a; record and
    print each side's median and spread. ``timing`` 'graph': 5 replays
    a turn of a CUDA graph of ``iters`` calls; 'eager': 5 timings of
    ``iters`` eager calls; 'cold': :func:`cold_samples`."""
    samples = {a_name: [], b_name: []}
    for name, fn in ((a_name, a_fn), (b_name, b_fn), (b_name, b_fn),
                     (a_name, a_fn)):
        samples[name] += cold_samples(fn) if timing == 'cold' else \
            chip_smoke._time_samples(fn, iters=iters,
                                     graph=timing == 'graph')
    entry = {name: _stats(t) for name, t in samples.items()}
    entry['timing'] = _TIMINGS[timing]
    results[label] = entry
    print(f'{label} [{entry["timing"]}]: ' + '; '.join(
        f'{n} {e["median_ms"]:.5f} ms (min {e["min_ms"]:.5f}, max '
        f'{e["max_ms"]:.5f})' for n, e in entry.items() if n != 'timing'),
        flush=True)


# the split variant's crossover table (cuda_merge.SPLIT_BANDS): documents
# and ops a document; S in {32, 4,096}, A in {8, 16}
SPLIT_CROSS_D = (1, 2, 4, 8, 16, 32, 64, 132, 264, 528)
SPLIT_CROSS_N = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
SPLIT_ITERS = 20
# the subwarp variant's crossover table (cuda_sequence.M_SUBWARP): rows
DELTA_CROSS_K = (1024, 12288)
# the base's delta-mode entry point before the subwarp variant: parent,
# anchor, elem, actor, valid, tree_pos, vis_index, node_at_pos, length,
# K, m, rounds, stream
_DELTA_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p]


def build_base(base, names):
    """nvcc the base checkout's kernels into _build/base/, in parallel;
    returns {name: ctypes.CDLL}."""
    from automerge_tpu_torch.device import cuda_build
    out_dir = os.path.join(cuda_build.BUILD_DIR, 'base')
    os.makedirs(out_dir, exist_ok=True)
    errs, libs = {}, {}

    def one(name):
        src = os.path.join(base, 'automerge_tpu_torch', 'csrc', f'{name}.cu')
        so = os.path.join(out_dir, f'lib{name}.so')
        res = subprocess.run([cuda_build._nvcc(), *cuda_build._NVCC_FLAGS,
                              '-o', so, src], capture_output=True, text=True)
        if res.returncode:
            errs[name] = res.stdout + res.stderr
        else:
            libs[name] = so
    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f'base build failed: {errs}')
    return {n: ctypes.CDLL(p) for n, p in libs.items()}


def _bind(lib, entry, argtypes):
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stream():
    # read at each call: a graph capture launches on its own stream
    import torch
    return torch.cuda.current_stream().cuda_stream


def _check(err):
    if err:
        raise RuntimeError(f'launch failed: CUDA error {err}')


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def capture_map_batch(n_docs):
    """The flat-map kernel's inputs from an ``n_docs``-document map-only
    ``DeviceDocSet`` batch."""
    from automerge_tpu_torch.device import cuda_merge
    from automerge_tpu_torch.sync import DeviceDocSet
    per_doc = chip_smoke.gen_map_fleet(n_docs)
    cap = []
    real = cuda_merge.resolve_cuda

    def cap_fm(*a, **kw):
        cap.append((a, kw))
        return real(*a, **kw)
    cuda_merge.resolve_cuda = cap_fm
    try:
        DeviceDocSet(device='cuda').apply_changes_batch(
            {f'm{d}': per_doc[d] for d in range(n_docs)})
    finally:
        cuda_merge.resolve_cuda = real
    return cap[-1]


def ab_flatmap(args, base, results):
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_merge
    from automerge_tpu_torch.device.workloads import gen_docset_workload
    dev = torch.device('cuda')
    a, kw = capture_map_batch(args.docs)
    D, N = a[0].shape
    A, S = a[3].shape[2], kw['num_segments']
    shape = f'D={D} N={N} A={A} S={S}'
    code = cuda_merge._VARIANTS[cuda_merge.variant(N, S, A)]
    n_fm = cuda_build.load('flatmap_resolve', 'flatmap_resolve_run',
                           cuda_merge._ARGTYPES)
    if hasattr(base, 'flatmap_resolve_launch'):
        b_fm = _bind(base, 'flatmap_resolve_launch', _FM_LAUNCH_ARGTYPES)
    else:
        b_run = _bind(base, 'flatmap_resolve_run', cuda_merge._ARGTYPES)

        def b_fm(*ptrs):
            return b_run(code, *ptrs)

    def outs(d, n, s):
        return [torch.empty((d, n), dtype=torch.bool, device=dev),
                torch.empty((d, s), dtype=torch.int32, device=dev),
                torch.empty((d, s), dtype=torch.int32, device=dev)]
    o = outs(D, N, S)

    def base_k():
        _check(b_fm(*_ptrs(a), *_ptrs(o), 0, D, N, S, A, _stream()))

    def new_k():
        _check(n_fm(code, *_ptrs(a), *_ptrs(o), 0, D, N, S, A, _stream()))
    for timing, note in (('graph', ''), ('cold', ', L2 flushed')):
        in_turns(f'flatmap_resolve kernel, main path {shape}{note}',
                 'base', base_k, 'this tree', new_k, timing, results)

    def base_call():
        out = outs(D, N, S)
        _check(b_fm(*_ptrs(a), *_ptrs(out), 0, D, N, S, A, _stream()))
        return out
    in_turns(f'flatmap_resolve call, main path {shape}',
             'base (allocations + kernel)', base_call,
             'this tree (dispatch_resolve)',
             lambda: cuda_merge.dispatch_resolve(*a, **kw), 'eager',
             results)

    for n in CROSS_N:
        for na in CROSS_A:
            for s in sorted({max(n // 4, 1), n}):
                if cuda_merge.warp_slice_bytes(n, s, na) > \
                        cuda_build.SMEM_LIMIT:
                    continue
                d = OPS // n
                t = [torch.as_tensor(x).to(dev) for x in gen_docset_workload(
                    n_docs=d, n_ops=n, n_actors=na, n_keys=s, seed=n + s,
                    del_p=0.1, invalid_p=0.1, cross_clock=True)]
                in_turns(f'flatmap_resolve variants, D={d} N={n} A={na} '
                         f'S={s} (dispatch picks '
                         f'{cuda_merge.variant(n, s, na)})',
                         'warp', lambda: cuda_merge.resolve_cuda(
                             *t, num_segments=s, force='warp'),
                         'block', lambda: cuda_merge.resolve_cuda(
                             *t, num_segments=s, force='block'), 'graph',
                         results)
                del t


def capture_main_path(n_docs, list_ops=48):
    """The edit-stream and RGA inputs of a two-tick general fleet."""
    import torch
    from automerge_tpu_torch.device import cuda_view, sequence
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    ticks = [chip_smoke.gen_mixed_docs(n_docs, list_ops),
             chip_smoke.gen_tick2(n_docs, list_ops)]
    ids = [f'doc{d}' for d in range(n_docs)]
    es, rga = [], []
    real_es, real_rga = cuda_view.dispatch_edit_stream, \
        sequence._rga_order_batched

    def cap_es(vis_fmt, planes, touched_u8, e_pad):
        es.append((vis_fmt, planes, np.array(touched_u8), e_pad))
        return real_es(vis_fmt, planes, touched_u8, e_pad)

    def cap_rga(*a):
        rga.append(a)
        return real_rga(*a)

    cuda_view.dispatch_edit_stream = cap_es
    sequence._rga_order_batched = cap_rga
    try:
        gds = GeneralDocSet(n_docs, device='cuda')
        for batch in ticks:
            gds.apply_changes_batch({ids[d]: batch[d]
                                     for d in range(n_docs)})
            gds.last_patch.diffs(0)
        torch.cuda.synchronize()
    finally:
        cuda_view.dispatch_edit_stream = real_es
        sequence._rga_order_batched = real_rga
    return es[-1], rga[-1]


def ab_sequence(args, base, results):
    """The RGA order and edit stream, base against this tree, then the
    crossovers of this tree's variants."""
    import torch
    from automerge_tpu_torch.device import (cuda_build, cuda_sequence,
                                            cuda_view, sequence)
    dev = torch.device('cuda')
    I32 = torch.int32
    (vis_fmt, planes, tb, e_pad), rga_in = capture_main_path(args.docs)
    if 'edit_stream' in base:
        b_es = _bind(base['edit_stream'], 'edit_stream_launch',
                     cuda_view._ARGTYPES)
        n_es = cuda_build.load('edit_stream', 'edit_stream_launch',
                               cuda_view._ARGTYPES)
        K, m = planes.shape
        t_u8 = torch.as_tensor(tb).to(dev)
        outs = [torch.empty((K, e_pad), dtype=I32, device=dev)
                for _ in range(5)] + [torch.empty((K, 3), dtype=I32,
                                                  device=dev)]
        mb = t_u8.shape[1]

        def es(fn):
            return lambda: _check(fn(
                0, 0, planes.data_ptr(), 0, 0, 0, 0, t_u8.data_ptr(),
                *_ptrs(outs), 0, K, m, mb, e_pad, _stream()))
        in_turns(f'edit_stream kernel, main path K={K} m={m} e_pad={e_pad}',
                 'base', es(b_es), 'this tree', es(n_es), 'graph', results)

    def rga_out(K, m):
        return [torch.empty((K, m), dtype=I32, device=dev)
                for _ in range(3)] + [torch.empty(K, dtype=I32, device=dev)]

    n_rga = cuda_build.load('rga_order', 'rga_narrow_launch',
                            cuda_sequence._NARROW_ARGTYPES)
    if 'rga_order' in base:
        b_rga = _bind(base['rga_order'], 'rga_narrow_launch',
                      cuda_sequence._NARROW_ARGTYPES)
        raw = [t.to(I32).contiguous() for t in rga_in[:3]] + \
            [t.to(torch.bool).contiguous() for t in rga_in[3:]]
        Kr, mr = raw[0].shape
        rounds = sequence._ceil_log2(mr) + 1
        o = rga_out(Kr, mr)

        def rga(fn):
            return lambda: _check(fn(*_ptrs(raw), *_ptrs(o), Kr, mr, rounds,
                                     _stream()))
        in_turns(f'rga_order kernel, main path K={Kr} m={mr}',
                 'base', rga(b_rga), 'this tree', rga(n_rga), 'graph',
                 results)

    rng = np.random.default_rng(5)
    if 'rga_order' in base:
        for mw in (64, 128, 256, 512):
            Kw = NODES // mw
            raw = [torch.as_tensor(p).to(dev)
                   for p in chip_smoke.random_trees(rng, Kw, mw)]
            raw = [t.to(I32) for t in raw[:3]] + raw[3:]
            rounds = sequence._ceil_log2(mw) + 1
            for timing in ('graph', 'eager'):
                # both sort inside, so a kernel alone is the whole step
                in_turns(f'rga_order variants, K={Kw} m={mw}, {timing}',
                         'narrow',
                         lambda: cuda_sequence.rga_order_cuda(
                             *raw, rounds=rounds),
                         'wide', lambda: cuda_sequence.rga_wide_cuda(
                             *raw, rounds=rounds, force='wide'), timing,
                         results)
    if 'edit_stream' in base:
        for mw in (64, 256, 512, 1024, 4096):
            Kw = NODES // mw
            _, _, _, _, tbw, packed = chip_smoke.random_planes(rng, Kw, mw)
            v = torch.as_tensor(packed).to(dev)
            tu = torch.as_tensor(tbw).to(dev)
            in_turns(f'edit_stream variants, K={Kw} m={mw} e_pad=64',
                     'warp', lambda: cuda_view.edit_stream_cuda(
                         'packed', v, tu, 64, force='warp'),
                     'block', lambda: cuda_view.edit_stream_cuda(
                         'packed', v, tu, 64, force='block'), 'graph',
                     results)


# the grid variants' crossover tables: rows and widths (the RGA order's
# wide widths on both sides of its shared-memory cap; the edit stream's
# past its warp bound, the packed format up to its 15-bit indexes)
RGA_CROSS_K = (1, 2, 8, 32, 132, 528)
RGA_CROSS_M = (513, 4096, 8192, 10240, 12799, 12800, 49152, 196608)
ES_CROSS_K = (1, 4, 32, 132, 528)
ES_CROSS_M = (1024, 2048, 4096, 8192, 32768, 65536, 300000)
# CTA counts of the barrier floor: one and two a SM, the config-4 RGA
# grid's, and all resident (0)
FLOOR_CTAS = (132, 264, 385, 0)
FLOOR_SYNCS = 40


def capture_single_rows(ticks=8):
    """The single-row kernel inputs of the main paths, by launch key
    (``chip_smoke._capturing``): config 4's replay
    (``traces.gen_editing_trace(180000, seed=0)``) and its bulk line (the
    first 60,001 changes through ``DeviceBackend.apply_changes``), and
    the long text's rebuild arm (``_INDEX_MODE='rebuild'``,
    ``_WINDOW_MODE='off'``: its first apply and ``ticks`` ticks)."""
    import torch
    from automerge_tpu_torch import traces
    from automerge_tpu_torch.device import backend as DB
    from automerge_tpu_torch.device import general as G
    from automerge_tpu_torch.device.text_block import (TextBlock,
                                                       replay_text_block)
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    trace = traces.gen_editing_trace(180000, seed=0)
    applies, _ = chip_smoke.long_text_applies()
    inputs = {}
    saved = G._INDEX_MODE, G._WINDOW_MODE
    with chip_smoke._capturing(inputs):
        replay_text_block(TextBlock.from_changes(trace), device='cuda')
        DB.apply_changes(DB.init(device='cuda'), trace[:60001])
        try:
            G._INDEX_MODE, G._WINDOW_MODE = 'rebuild', 'off'
            ds = GeneralDocSet(1, device='cuda')
            for ch in applies[:ticks + 1]:
                ds.apply_changes('t', ch)
                ds.last_patch.diffs(0)
        finally:
            G._INDEX_MODE, G._WINDOW_MODE = saved
    torch.cuda.synchronize()
    return inputs


def _base_scratch(K, m, dev):
    """The global scratch of the base's one-block RGA kernel
    (``rga_order_launch``): four planes of m + 1 words a row, which it
    reads only where a row passes its own shared-memory cap."""
    import torch
    return torch.empty((K, 4 * (m + 1)), dtype=torch.int32, device=dev)


def _rga_sides(base, srt, flags, K, m):
    """(the base's one-block-per-row kernel, this tree's grid variant) on
    sorted planes ``srt`` and ``flags``, each on its own outputs and
    scratch allocated once."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_sequence
    from automerge_tpu_torch.device import sequence
    dev = srt[0].device
    rounds = sequence._ceil_log2(m) + 1
    b_fn = _bind(base, 'rga_order_launch', cuda_sequence._ARGTYPES)
    n_fn = cuda_build.load('rga_order', 'rga_grid_launch',
                           cuda_sequence._ARGTYPES)
    words = cuda_build.load('rga_order', 'rga_grid_scratch_words',
                            [ctypes.c_int] * 2, ctypes.c_longlong)(K, m)

    def outs():
        return [torch.empty((K, m), dtype=torch.int32, device=dev)
                for _ in range(3)] + [torch.empty(K, dtype=torch.int32,
                                                  device=dev)]
    o_b, o_n = outs(), outs()
    s_b = _base_scratch(K, m, dev)
    s_n = torch.empty(words, dtype=torch.int32, device=dev)
    ins = _ptrs(srt) + _ptrs(flags)

    def b():
        _check(b_fn(*ins, *_ptrs(o_b), s_b.data_ptr(), K, m, rounds,
                    _stream()))

    def n():
        _check(n_fn(*ins, *_ptrs(o_n), s_n.data_ptr(), K, m, rounds,
                    _stream()))
    return b, n, o_b, o_n


def _es_sides(base, fmt, planes, t_u8, e_pad):
    """(the base's block variant, this tree's grid variant) of the edit
    stream on one input, each on its own outputs and scratch."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_view
    lead = planes if fmt == 'packed' else planes[0]
    K, m = lead.shape
    dev = lead.device
    code = {'packed': cuda_view._FMT_PACKED, 'wide': cuda_view._FMT_WIDE}[fmt]
    ptrs = [lead.data_ptr(), 0, 0, 0,
            0 if fmt == 'packed' else planes[1].data_ptr()]
    b_fn = _bind(base, 'edit_stream_launch', cuda_view._ARGTYPES)
    n_fn = cuda_build.load('edit_stream', 'edit_stream_launch',
                           cuda_view._ARGTYPES)
    words = cuda_build.load('edit_stream', 'edit_stream_grid_scratch_words',
                            [ctypes.c_int] * 2, ctypes.c_longlong)(K, m)

    def outs():
        return [torch.empty((K, e_pad), dtype=torch.int32, device=dev)
                for _ in range(5)] + [torch.empty((K, 3), dtype=torch.int32,
                                                  device=dev)]
    o_b, o_n = outs(), outs()
    s_b = torch.empty((K, 6 * ((m + 31) >> 5)), dtype=torch.int32,
                      device=dev) if not cuda_view.block_fits_smem(m) \
        else None
    s_n = torch.empty(words, dtype=torch.int32, device=dev)
    mb = t_u8.shape[1]

    def b():
        _check(b_fn(1, code, *ptrs, t_u8.data_ptr(), *_ptrs(o_b),
                    0 if s_b is None else s_b.data_ptr(), K, m, mb, e_pad,
                    _stream()))

    def n():
        _check(n_fn(2, code, *ptrs, t_u8.data_ptr(), *_ptrs(o_n),
                    s_n.data_ptr(), K, m, mb, e_pad, _stream()))
    return b, n, o_b, o_n


def _same(o_b, o_n, what):
    import torch
    torch.cuda.synchronize()
    for x, y in zip(o_b, o_n):
        if not torch.equal(x, y):
            raise AssertionError(f'{what}: the base and this tree differ')


def _tile(t, K):
    """Rows of ``t`` repeated to ``K`` rows."""
    r = t.shape[0]
    return t.repeat(((K + r - 1) // r,) + (1,) * (t.dim() - 1))[:K] \
        .contiguous()


def ab_single_row(args, base, results):
    """The grid variants against the base's one-block-per-row kernels:
    the floor under a round, the main paths' single-row inputs in turns,
    then the crossover tables."""
    import torch
    from automerge_tpu_torch.device import cuda_build, sequence
    dev = torch.device('cuda')
    I32 = torch.int32

    # the floor: an empty grid barrier, an empty graph-captured launch
    probe = cuda_build.load('rga_order', 'grid_barrier_probe',
                            [ctypes.c_int] * 3 + [ctypes.c_void_p])
    floor = {}
    for ctas in FLOOR_CTAS:
        t0 = chip_smoke._time_samples(
            lambda: _check(probe(0, 1, ctas, _stream())), graph=True)
        t1 = chip_smoke._time_samples(
            lambda: _check(probe(FLOOR_SYNCS, 1, ctas, _stream())),
            graph=True)
        tp = chip_smoke._time_samples(
            lambda: _check(probe(0, 0, ctas, _stream())), graph=True)
        te = chip_smoke._time_samples(
            lambda: [_check(probe(0, 0, ctas, _stream()))
                     for _ in range(FLOOR_SYNCS)], iters=5)
        row = {'coop_launch_ms': float(np.median(t0)),
               'barrier_ms': float(np.median(t1) - np.median(t0))
               / FLOOR_SYNCS,
               'plain_launch_graph_ms': float(np.median(tp)),
               'plain_launch_eager_ms': float(np.median(te)) / FLOOR_SYNCS}
        floor[ctas or 'resident'] = row
        print(f'floor, {ctas or "all resident"} CTAs of 512: an empty '
              f'cooperative launch {row["coop_launch_ms"] * 1e3:.3f} us, '
              f'one grid barrier {row["barrier_ms"] * 1e3:.3f} us (of '
              f'{FLOOR_SYNCS} in one launch); an empty plain launch '
              f'{row["plain_launch_graph_ms"] * 1e3:.3f} us from a graph, '
              f'{row["plain_launch_eager_ms"] * 1e3:.3f} us eagerly (of '
              f'{FLOOR_SYNCS} back to back)', flush=True)
    results['grid floor'] = floor

    # the main paths' single-row inputs, base against this tree
    inputs = capture_single_rows()
    seen = {}
    for key, entries in sorted(inputs.items()):
        for kind, a in entries:
            if kind == 'rga' and a[0].shape[1] > 512:
                K, m = a[0].shape
                seen[('rga', K, m)] = a
            elif kind == 'es' and a[0] in ('packed', 'wide'):
                lead = a[1] if a[0] == 'packed' else a[1][0]
                if lead.shape[1] > 512:
                    seen[('es', a[0], *lead.shape, a[3])] = a
    for what, a in sorted(seen.items(), key=lambda x: str(x[0])):
        if what[0] == 'rga':
            _, K, m = what
            srt = [t.to(I32).contiguous() for t in sequence._child_sort(
                a[0], a[1], a[2], a[4])]
            flags = [t.to(torch.bool).contiguous() for t in a[3:]]
            b, n, o_b, o_n = _rga_sides(base['rga_order'], srt, flags, K, m)
            b(), n()
            _same(o_b, o_n, f'rga K={K} m={m}')
            in_turns(f'rga_order main-path input K={K} m={m}', 'base wide',
                     b, 'this tree wide-grid', n, 'graph', results)
        else:
            fmt, planes, tb, e_pad = a
            planes = planes.contiguous() if fmt == 'packed' else \
                tuple(p.contiguous() for p in planes)
            t_u8 = torch.as_tensor(tb).to(dev)
            b, n, o_b, o_n = _es_sides(base['edit_stream'], fmt, planes,
                                       t_u8, e_pad)
            b(), n()
            _same(o_b, o_n, f'edit_stream {what}')
            _, _, K, m, _ = what
            in_turns(f'edit_stream main-path input {fmt} K={K} m={m} '
                     f'e_pad={e_pad}', 'base block', b, 'this tree grid',
                     n, 'graph', results)
    del inputs, seen

    # the crossover tables: grid against one block per row
    rng = np.random.default_rng(7)
    for m in RGA_CROSS_M:
        rows = [torch.as_tensor(p).to(dev)
                for p in chip_smoke.random_trees(rng, 8, m)]
        srt8 = [t.to(I32) for t in sequence._child_sort(
            rows[0], rows[1], rows[2], rows[4])]
        for K in RGA_CROSS_K:
            srt = [_tile(t, K) for t in srt8]
            flags = [_tile(t, K) for t in rows[3:]]
            b, n, o_b, o_n = _rga_sides(base['rga_order'], srt, flags, K, m)
            b(), n()
            _same(o_b, o_n, f'rga K={K} m={m}')
            in_turns(f'rga_order crossover K={K} m={m}', 'wide', b,
                     'wide-grid', n, 'graph', results,
                     iters=10 if K * m > 8_000_000 else 50)
            del srt, flags, b, n, o_b, o_n
        torch.cuda.empty_cache()
    for m in ES_CROSS_M:
        pv, nv, pi, ni, tb, packed = chip_smoke.random_planes(rng, 4, m)
        t4 = torch.as_tensor(tb).to(dev)
        fmts = {'wide': [torch.as_tensor(x).to(dev)
                         for x in chip_smoke.wide_planes(pv, nv, pi, ni)]}
        if m <= 32768:
            fmts['packed'] = [torch.as_tensor(packed).to(dev)]
        for fmt, p4 in fmts.items():
            for K in ES_CROSS_K:
                planes = [_tile(t, K) for t in p4]
                planes = planes[0] if fmt == 'packed' else tuple(planes)
                t_u8 = _tile(t4, K)
                for e_pad in (8, m):
                    b, n, o_b, o_n = _es_sides(base['edit_stream'], fmt,
                                               planes, t_u8, e_pad)
                    b(), n()
                    _same(o_b, o_n, f'edit_stream {fmt} K={K} m={m}')
                    in_turns(f'edit_stream crossover {fmt} K={K} m={m} '
                             f'e_pad={e_pad}', 'block', b, 'grid', n,
                             'graph', results,
                             iters=10 if K * m > 8_000_000 else 50)
                    del b, n, o_b, o_n
                del planes, t_u8
            torch.cuda.empty_cache()


def _union_of_one_document():
    """Replica sync's union resolve input (``chip_smoke._mesh_peers``):
    the four peers' ops of ``chip_smoke.peer_ops()`` as one [1, 65,536]
    document on the card, and its segment count."""
    import torch
    cols = chip_smoke.peer_ops()
    return [torch.as_tensor(a.reshape((1, -1) + a.shape[2:])).to('cuda')
            for a in cols[:6]], 4096


def _device_ops(D, N, A, seed):
    """Random flat-map inputs made on the card (the crossover table's
    shapes reach 34.6M ops): raw segment ids (reduced mod S by the
    caller), actors, seqs, clocks, 10% deletes, 90% valid."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=g, device='cuda',
                             dtype=torch.int32)
    return (ints((D, N), 1 << 30), ints((D, N), A), ints((D, N), 64) + 1,
            ints((D, N, A), 64),
            torch.rand((D, N), generator=g, device='cuda') < 0.1,
            torch.rand((D, N), generator=g, device='cuda') >= 0.1)


def ab_split(args, base, results):
    """The split variant against the base's block-global variant at the
    union of one long document, then its crossover table."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_grid, cuda_merge
    ins, S = _union_of_one_document()
    D, N = ins[0].shape
    A = ins[3].shape[2]
    shape = f'D={D} N={N} A={A} S={S}'
    run = cuda_build.load('flatmap_resolve', 'flatmap_resolve_run',
                          cuda_merge._ARGTYPES)
    b_run = _bind(base, 'flatmap_resolve_run', cuda_merge._ARGTYPES)

    def side(fn, var, words):
        o = [torch.empty((D, N), dtype=torch.bool, device='cuda'),
             torch.empty((D, S), dtype=torch.int32, device='cuda'),
             torch.empty((D, S), dtype=torch.int32, device='cuda')]
        sc = torch.empty(words, dtype=torch.int32, device='cuda')

        def call():
            _check(fn(cuda_merge._VARIANTS[var], *_ptrs(ins), *_ptrs(o),
                      sc.data_ptr(), D, N, S, A, _stream()))
        return call, o
    b, o_b = side(b_run, 'block-global', D * (S + 1) * (A + 2))
    n, o_n = side(run, 'split', cuda_merge.split_scratch_words(D, S, A))
    b(), n()
    _same(o_b, o_n, f'flatmap split {shape}')
    for timing in ('graph', 'eager'):
        in_turns(f'flatmap_resolve union of one document {shape} '
                 f'({timing})', 'base block-global', b, 'this tree split',
                 n, timing, results)

    table = {}
    for A in (8, 16):
        for N in SPLIT_CROSS_N:
            for D in SPLIT_CROSS_D:
                raw = _device_ops(D, N, A, seed=D * N + A)
                for S in (32, 4096):
                    t = (raw[0] % S, *raw[1:])
                    other = cuda_merge.variant(N, S, A)

                    def call(v):
                        return lambda: cuda_merge.resolve_cuda(
                            *t, num_segments=S, force=v)
                    o_s, o_o = call('split')(), call(
                        'warp' if other == 'warp' else 'block')()
                    _same([o_s[k] for k in sorted(o_s)],
                          [o_o[k] for k in sorted(o_o)],
                          f'flatmap split vs {other} D={D} N={N} S={S}')
                    label = (f'flatmap_resolve crossover D={D} N={N} A={A} '
                             f'S={S}')
                    in_turns(label, other,
                             call('warp' if other == 'warp' else 'block'),
                             'split', call('split'), 'graph', results,
                             iters=SPLIT_ITERS)
                    e = results[label]
                    table[f'{D},{N},{A},{S}'] = {
                        'other': other,
                        'ratio': e[other]['median_ms']
                        / e['split']['median_ms']}
                    del t, o_s, o_o
                del raw
                torch.cuda.empty_cache()
    results['split crossover'] = table
    print('flatmap_resolve split crossover: the variant a shape takes '
          'without it over the split one, graph medians in turns, the '
          'smallest of the four (S, A); above 1 the split variant wins')
    print('N \\ D ' + ' '.join(f'{D:>6}' for D in SPLIT_CROSS_D)
          + '  won to  bands')
    for N in SPLIT_CROSS_N:
        worst = [min(table[f'{D},{N},{A},{S}']['ratio'] for A in (8, 16)
                     for S in (32, 4096)) for D in SPLIT_CROSS_D]
        won = max([D for D, r in zip(SPLIT_CROSS_D, worst) if r > 1],
                  default=0)
        band = cuda_grid.band_rows(cuda_merge.SPLIT_BANDS, N)
        print(f'{N:>6} ' + ' '.join(f'{r:6.2f}' for r in worst)
              + f'  {won:>6}  {band:>5}', flush=True)


def capture_delta(n_docs, list_ops=48):
    """The delta orderer's input on config 5's tick 2 (a fleet of
    ``n_docs`` documents, two ticks)."""
    import torch
    from automerge_tpu_torch.device import sequence
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    ticks = [chip_smoke.gen_mixed_docs(n_docs, list_ops),
             chip_smoke.gen_tick2(n_docs, list_ops)]
    ids = [f'doc{d}' for d in range(n_docs)]
    cap = []
    real = sequence._rga_delta_order_batched

    def cap_delta(*a):
        cap.append(a)
        return real(*a)
    sequence._rga_delta_order_batched = cap_delta
    try:
        gds = GeneralDocSet(n_docs, device='cuda')
        for batch in ticks:
            gds.apply_changes_batch({ids[d]: batch[d]
                                     for d in range(n_docs)})
        torch.cuda.synchronize()
    finally:
        sequence._rga_delta_order_batched = real
    return cap[-1]


def ab_delta(args, base, results):
    """The subwarp variant against the base's delta launch at config 5's
    tick 2, against this tree's narrow variant there, then its crossover
    table."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_sequence
    from automerge_tpu_torch.device import sequence
    I32 = torch.int32
    a = capture_delta(args.docs)
    planes = [t.to(I32).contiguous() for t in a[:4]] + \
        [a[4].to(torch.bool).contiguous()]
    K, m = planes[0].shape
    rounds = sequence._ceil_log2(m) + 1
    run = cuda_build.load('rga_order', 'rga_delta_run',
                          cuda_sequence._DELTA_ARGTYPES)
    b_fn = _bind(base, 'rga_delta_launch', _DELTA_LAUNCH_ARGTYPES)
    o_b = [torch.empty((K, m), dtype=I32, device='cuda') for _ in range(3)] \
        + [torch.empty(K, dtype=I32, device='cuda')]
    tp = {v: torch.empty((K, m), dtype=I32, device='cuda')
          for v in ('narrow', 'subwarp')}

    def b():
        _check(b_fn(*_ptrs(planes), *_ptrs(o_b), K, m, rounds, _stream()))

    def n(v):
        code = cuda_sequence._DELTA_VARIANTS[v]
        return lambda: _check(run(code, *_ptrs(planes), tp[v].data_ptr(), K,
                                  m, rounds, _stream()))
    b(), n('narrow')(), n('subwarp')()
    valid = planes[4]
    _same([o_b[0][valid], tp['narrow'][valid]],
          [tp['subwarp'][valid]] * 2, f'delta K={K} m={m}')
    for timing in ('graph', 'eager'):
        in_turns(f'rga_order delta, tick 2 K={K} m={m} ({timing})',
                 'base narrow', b, 'this tree subwarp', n('subwarp'),
                 timing, results)
    in_turns(f'rga_order delta variants, tick 2 K={K} m={m}',
             'narrow', n('narrow'), 'subwarp', n('subwarp'), 'graph',
             results)

    table = {}
    rng = np.random.default_rng(9)
    for K in DELTA_CROSS_K:
        for m in range(1, 33):
            p = [torch.as_tensor(x).to('cuda')
                 for x in chip_smoke.delta_forests(rng, K, m)]
            rounds = sequence._ceil_log2(m) + 1

            def call(v):
                return lambda: cuda_sequence.rga_delta_cuda(
                    *p[:4], p[4], rounds=rounds, force=v)
            _same([call('narrow')()[p[4]]], [call('subwarp')()[p[4]]],
                  f'delta K={K} m={m}')
            label = f'rga_order delta crossover K={K} m={m}'
            in_turns(label, 'narrow', call('narrow'), 'subwarp',
                     call('subwarp'), 'graph', results)
            e = results[label]
            table[f'{K},{m}'] = e['subwarp']['median_ms'] / \
                e['narrow']['median_ms']
    results['delta crossover (subwarp / narrow)'] = table


# the wide kernel's crossover table against the grid step (GRID_BANDS)
WIDE_CROSS_K = (1, 2, 4, 8, 32, 132)
WIDE_CROSS_M = (4096, 8192, 10240, 12799, 14336, 16384, 24576, 32768,
                49152)


def _full_rows(gen, rng, K, m, distinct=8):
    """``K`` rows of ``m`` valid nodes: the first (full) row of
    ``distinct`` draws of ``gen``, tiled."""
    import torch
    rows = [gen(rng, 1, m) for _ in range(distinct)]
    planes = [np.concatenate([r[i] for r in rows]) for i in range(5)]
    return [_tile(torch.as_tensor(p).to('cuda'), K) for p in planes]


def capture_mixed_tick():
    """The wide RGA kernel's input on ``chip_smoke.py`` phase 4i's tick 1
    (its 1,920 lists and 128 texts through ``GeneralDocSet``)."""
    import torch
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    n_small, n_text = chip_smoke.MIXED_SMALL, chip_smoke.MIXED_TEXTS
    docs = chip_smoke.gen_mixed_docs(n_small, chip_smoke.MIXED_LIST_OPS)
    docs += chip_smoke.gen_text_docs(n_text, doc0=n_small)[0]
    ids = [f'mixed{d}' for d in range(n_small + n_text)]
    cap = {}
    with chip_smoke._capturing(cap):
        gds = GeneralDocSet(len(ids), device='cuda')
        gds.apply_changes_batch(dict(zip(ids, docs)))
        torch.cuda.synchronize()
    return cap[('rga_order', 'order', 'wide')][0][1]


def _wide_bytes(raw):
    """(the bytes one call must move over every slot, and over the valid
    extents only: the wide kernel reads a padded row's valid bytes and
    writes its fixed outputs past its extent)."""
    from automerge_tpu_torch.device import cuda_sequence
    K, m = raw[0].shape
    out = K * m * 12 + K * 4
    ext = int(cuda_sequence.wide_extent(raw[0], raw[4]).sum())
    return K * m * 14 + out, K * m + ext * 13 + out


def _wide_sides(base, raw):
    """The base's step (the PyTorch child sort, then its one-block
    kernel), the sort alone, the base kernel alone on a sort made once,
    and this tree's wide kernel, on raw planes ``raw``; each on its own
    outputs. Returns (step, sort, kernel, wide, the step's outputs, the
    wide kernel's)."""
    import torch
    from automerge_tpu_torch.device import cuda_sequence, sequence
    I32 = torch.int32
    K, m = raw[0].shape
    rounds = sequence._ceil_log2(m) + 1
    b_fn = _bind(base, 'rga_order_launch', cuda_sequence._ARGTYPES)

    def outs():
        return [torch.empty((K, m), dtype=I32, device='cuda')
                for _ in range(3)] + [torch.empty(K, dtype=I32,
                                                  device='cuda')]
    o_b, o_k = outs(), outs()
    s_b = _base_scratch(K, m, 'cuda')

    def sort():
        return [t.to(I32).contiguous() for t in sequence._child_sort(
            raw[0], raw[1], raw[2], raw[4])]
    once = sort()

    def launch(srt, o):
        _check(b_fn(*_ptrs(srt), *_ptrs(raw[3:]), *_ptrs(o),
                    s_b.data_ptr(), K, m, rounds, _stream()))
    out = {}

    def wide():
        out['wide'] = cuda_sequence.rga_wide_cuda(*raw, rounds=rounds)
    wide()
    return (lambda: launch(sort(), o_b), sort, lambda: launch(once, o_k),
            wide, o_b, out)


def ab_wide(args, base, results):
    """The wide kernel against the base's sort + one-block step at four
    inputs, then the crossover table behind ``GRID_BANDS``."""
    import torch
    I32 = torch.int32
    rng = np.random.default_rng(14)
    shapes = [
        ('phase 4h K=1 m=3072', _full_rows(chip_smoke.random_trees, rng, 1,
                                           3072)),
        ('phase 4i tick 1', capture_mixed_tick()),
        ('132 full rows m=8192', _full_rows(chip_smoke.random_trees, rng,
                                            132, 8192)),
        ('prepend, 132 full rows m=8192',
         _full_rows(chip_smoke.prepend_trees, rng, 132, 8192))]
    for label, planes in shapes:
        raw = [t.to(I32).contiguous() for t in planes[:3]] + \
            [t.to(torch.bool).contiguous() for t in planes[3:]]
        K, m = raw[0].shape
        step, sort, kernel, wide, o_b, out = _wide_sides(base, raw)
        step()
        torch.cuda.synchronize()
        valid = raw[4]
        w = out['wide']
        _same([o_b[0][valid], *o_b[1:]],
              [w['tree_pos'][valid], w['vis_index'], w['node_at_pos'],
               w['length']], f'wide {label}')
        full, ext = _wide_bytes(raw)
        label = f'rga_order wide, {label} (K={K} m={m})'
        for timing in ('graph', 'eager'):
            in_turns(f'{label}, {timing}', 'base sort + one-block kernel',
                     step, 'this tree wide', wide, timing, results)
            in_turns(f'{label}, the base step\'s parts, {timing}',
                     'base sort', sort, 'base kernel alone', kernel,
                     timing, results)
        results[f'{label}, bound'] = {
            'bytes_every_slot': full, 'bytes_valid_extent': ext,
            'bound_ms_every_slot': full / chip_smoke._HBM_BYTES_PER_S * 1e3,
            'bound_ms_valid_extent': ext / chip_smoke._HBM_BYTES_PER_S * 1e3}
        print(f'{label}: bound {full / chip_smoke._HBM_BYTES_PER_S * 1e3:.5f}'
              f' ms over every slot ({full} B), '
              f'{ext / chip_smoke._HBM_BYTES_PER_S * 1e3:.5f} ms over the '
              f'valid extents ({ext} B), at 3.35 TB/s', flush=True)
        del step, sort, kernel, wide, o_b, out, raw, planes
        torch.cuda.empty_cache()

    for mode in ('order', 'delta'):
        _wide_crossover(mode, rng, results)


def _wide_crossover(mode, rng, results):
    """The crossover table behind ``cuda_sequence.GRID_BANDS`` (the
    delta mode: ``DELTA_GRID_BANDS``) in one mode: the wide kernel against the PyTorch sort + grid step, whole
    steps from a graph, on 8 seeded rows tiled to K (``'order'``: random
    trees, every output compared; ``'delta'``: delta forests, the anchor
    plane to the wide kernel and as a sort key, tree_pos compared)."""
    import torch
    from automerge_tpu_torch.device import cuda_grid, cuda_sequence
    from automerge_tpu_torch.device import sequence
    I32 = torch.int32
    delta = mode == 'delta'
    table = {}
    for m in WIDE_CROSS_M:
        gen = chip_smoke.delta_forests if delta else chip_smoke.random_trees
        rows = [torch.as_tensor(p).to('cuda') for p in gen(rng, 8, m)]
        rounds = sequence._ceil_log2(m) + 1
        for K in WIDE_CROSS_K:
            if not cuda_grid.fits(K, K * (m + 1)):
                continue
            planes = [_tile(t, K) for t in rows]
            valid = planes[4]
            if delta:
                parent, anchor, elem, actor = (t.to(I32)
                                               for t in planes[:4])
                flags = (valid, valid)
            else:
                parent, elem, actor = (t.to(I32) for t in planes[:3])
                anchor, flags = None, (planes[3], valid)

            def grid_step():
                srt = [t.to(I32).contiguous() for t in sequence._child_sort(
                    parent, elem, actor, valid, anchor)]
                return cuda_sequence.order_from_sorted_cuda(
                    *srt, *flags, rounds=rounds)

            def wide():
                return cuda_sequence.rga_wide_cuda(
                    parent, elem, actor, None if delta else flags[0], valid,
                    rounds=rounds, anchor=anchor)
            a, b = wide(), grid_step()
            if delta:
                _same([a[valid]], [b['tree_pos'][valid]],
                      f'wide delta crossover K={K} m={m}')
            else:
                _same([a['tree_pos'][valid], a['vis_index'],
                       a['node_at_pos']],
                      [b['tree_pos'][valid], b['vis_index'],
                       b['node_at_pos']], f'wide crossover K={K} m={m}')
            label = f'rga_order wide {mode} crossover K={K} m={m}'
            in_turns(label, 'wide', wide, 'sort+wide-grid', grid_step,
                     'graph', results, iters=10 if K * m > 2_000_000 else 50)
            e = results[label]
            table[f'{K},{m}'] = e['wide']['median_ms'] / \
                e['sort+wide-grid']['median_ms']
            del planes, valid, parent, elem, actor, anchor, flags, a, b
        torch.cuda.empty_cache()
    results[f'wide {mode} crossover (wide / sort+wide-grid)'] = table
    print(f'wide {mode} crossover, the wide kernel\'s median over the sort '
          f'+ grid step\'s (above 1 the grid step wins):', flush=True)
    print(f'{"m":>6} ' + ' '.join(f'K={K:<4}' for K in WIDE_CROSS_K)
          + '  grid won through  bands', flush=True)
    for m in WIDE_CROSS_M:
        r = [table.get(f'{K},{m}') for K in WIDE_CROSS_K]
        won = max([K for K, x in zip(WIDE_CROSS_K, r)
                   if x is not None and x > 1] or [0])
        band = cuda_grid.band_rows(cuda_sequence.DELTA_GRID_BANDS if delta
                                   else cuda_sequence.GRID_BANDS, m)
        print(f'{m:>6} ' + ' '.join('   -  ' if x is None else f'{x:6.2f}'
                                    for x in r)
              + f'  {won:>17}  {band:>5}', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--base', default=os.path.join(ROOT, '_archive', 'base'))
    ap.add_argument('--docs', type=int, default=10240)
    ap.add_argument('--kernels', nargs='+', choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument('--single-row', action='store_true',
                    help='only the single-row lane: the grid variants '
                         'against the base\'s one-block-per-row kernels')
    ap.add_argument('--split', action='store_true',
                    help='the flat-map split variant against the base\'s '
                         'block-global one, then its crossover table')
    ap.add_argument('--delta', action='store_true',
                    help='the delta mode\'s subwarp variant against the '
                         'base\'s delta launch, then its crossover table')
    ap.add_argument('--wide', action='store_true',
                    help='the wide RGA kernel against the base\'s sort + '
                         'one-block step, then the crossover table behind '
                         'GRID_BANDS')
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'automerge_tpu_torch', '_build', 'kernel_ab.json'))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_kernel_ab: CUDA is not available', file=sys.stderr)
        return 2
    from automerge_tpu_torch.device import cuda_build
    card = chip_smoke._card_line()
    print(card, flush=True)
    lanes = args.single_row or args.split or args.delta or args.wide
    names = ['rga_order', 'edit_stream'] if args.single_row else []
    names += ['flatmap_resolve'] if args.split else []
    names += ['rga_order'] if (args.delta or args.wide) and \
        not args.single_row else []
    names = names if lanes else args.kernels
    cuda_build.build_all(names, force=True)
    base = build_base(args.base, names)
    results = {'card': card, 'torch': torch.__version__,
               'cuda': torch.version.cuda}
    if args.single_row:
        ab_single_row(args, base, results)
    if args.split:
        ab_split(args, base['flatmap_resolve'], results)
    if args.delta:
        ab_delta(args, base['rga_order'], results)
    if args.wide:
        ab_wide(args, base['rga_order'], results)
    if not lanes and 'flatmap_resolve' in base:
        ab_flatmap(args, base['flatmap_resolve'], results)
    if not lanes and ('rga_order' in base or 'edit_stream' in base):
        ab_sequence(args, base, results)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(results, fh, indent=1)
    print(f'wrote {args.out} ({card})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
