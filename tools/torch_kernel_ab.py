"""Time the PyTorch port's RGA-order and edit-stream CUDA kernels against
another checkout's, in turns, on one CUDA card; then the crossovers of
this tree's variants.

    mkdir -p _archive/base && git archive <commit> | tar -x -C _archive/base
    python3 tools/torch_kernel_ab.py --base _archive/base

The base checkout's kernels must have the C interface of the versions
these replaced (``rga_order_launch``, and an ``edit_stream_launch``
that takes a ``[K, m]`` grid scratch). The script builds the base's
``csrc/rga_order.cu`` and ``csrc/edit_stream.cu`` with nvcc (``sm_90a``)
into ``automerge_tpu_torch/_build/base/`` beside this tree's kernels,
captures the inputs the general engine's main path hands the two kernels
(a ``--docs``-document config-5 fleet, two ticks, as ``chip_smoke.py``
phase 4), and times at those inputs in turns — base, this tree, this
tree, base — with 5 timings of 50 launches a turn:

- each kernel alone, on buffers allocated once, 50 launches captured in
  a CUDA graph (device time);
- the RGA step as the main path pays it, called eagerly: the base's
  PyTorch child sort, casts and kernel against this tree's
  ``sequence._rga_order_batched``.

Then, in turns again, the RGA order's narrow and wide variants at m in
{64, 128, 256, 512} (kernel alone and step, random trees) and the edit
stream's warp and block variants at m in {64, 256, 512, 1024, 4096}
(packed, e_pad 64), each at K*m = 786,432 nodes, the main path's size.
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


def _stats(t):
    return {'median_ms': float(np.median(t)), 'min_ms': float(min(t)),
            'max_ms': float(max(t)), 'samples_ms': [float(x) for x in t]}


def in_turns(label, a_name, a_fn, b_name, b_fn, graph, results):
    """Time ``a_fn`` and ``b_fn`` in the order a, b, b, a (5 timings of
    50 calls a turn); record and print each side's median and spread."""
    samples = {a_name: [], b_name: []}
    for name, fn in ((a_name, a_fn), (b_name, b_fn), (b_name, b_fn),
                     (a_name, a_fn)):
        samples[name] += chip_smoke._time_samples(fn, graph=graph)
    entry = {name: _stats(t) for name, t in samples.items()}
    entry['timing'] = 'device (CUDA graph)' if graph else 'eager'
    results[label] = entry
    print(f'{label} [{entry["timing"]}]: ' + '; '.join(
        f'{n} {e["median_ms"]:.5f} ms (min {e["min_ms"]:.5f}, max '
        f'{e["max_ms"]:.5f})' for n, e in entry.items() if n != 'timing'),
        flush=True)


def build_base(base):
    """nvcc the base checkout's two kernels into _build/base/, in
    parallel; returns {name: ctypes.CDLL}."""
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

    threads = [threading.Thread(target=one, args=(n,))
               for n in ('rga_order', 'edit_stream')]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f'base build failed: {errs}')
    return {n: ctypes.CDLL(p) for n, p in libs.items()}


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--base', default=os.path.join(ROOT, '_archive', 'base'))
    ap.add_argument('--docs', type=int, default=10240)
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'automerge_tpu_torch', '_build', 'kernel_ab.json'))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_kernel_ab: CUDA is not available', file=sys.stderr)
        return 2
    from automerge_tpu_torch.device import (cuda_build, cuda_sequence,
                                            cuda_view, sequence)
    card = chip_smoke._card_line()
    print(card, flush=True)
    dev = torch.device('cuda')
    I32 = torch.int32
    cuda_build.build_all(('rga_order', 'edit_stream'), force=True)
    base = build_base(args.base)
    b_rga = base['rga_order'].rga_order_launch
    b_rga.argtypes = cuda_sequence._ARGTYPES
    b_rga.restype = ctypes.c_int
    b_es = base['edit_stream'].edit_stream_launch
    b_es.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                     + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    b_es.restype = ctypes.c_int
    n_rga = cuda_build.load('rga_order', 'rga_narrow_launch',
                            cuda_sequence._NARROW_ARGTYPES)
    n_es = cuda_build.load('edit_stream', 'edit_stream_launch',
                           cuda_view._ARGTYPES)

    def stream():
        # read at each call: a graph capture launches on its own stream
        return torch.cuda.current_stream(dev).cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f'launch failed: CUDA error {err}')

    def rga_out(K, m):
        return [torch.empty((K, m), dtype=I32, device=dev)
                for _ in range(3)] + [torch.empty(K, dtype=I32, device=dev)]

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    def rga_fns(raw):
        """The narrow kernel's launch on [K, m] raw planes and the wide
        kernel's on their child sort (given its ctypes entry), each on
        outputs allocated once; the sorted planes and the round count."""
        K, m = raw[0].shape
        rounds = sequence._ceil_log2(m) + 1
        srt = [t.to(I32).contiguous()
               for t in sequence._child_sort(raw[0], raw[1], raw[2], raw[4])]
        o_n, o_w = rga_out(K, m), rga_out(K, m)
        return {
            'narrow_kernel': lambda: check(n_rga(
                *ptrs(raw), *ptrs(o_n), K, m, rounds, stream())),
            'wide_kernel': lambda fn=b_rga: check(fn(
                *ptrs(srt), *ptrs(raw[3:]), *ptrs(o_w), 0, K, m, rounds,
                stream())),
            'srt': srt, 'rounds': rounds}

    results = {'card': card, 'torch': torch.__version__,
               'cuda': torch.version.cuda}

    # ---- A/B at the main path's inputs ----
    (vis_fmt, planes, tb, e_pad), rga_in = capture_main_path(args.docs)
    K, m = planes.shape
    t_u8 = torch.as_tensor(tb).to(dev)
    outs = [torch.empty((K, e_pad), dtype=I32, device=dev)
            for _ in range(5)] + [torch.empty((K, 3), dtype=I32, device=dev)]
    grid = torch.empty((K, m), dtype=I32, device=dev)
    mb = t_u8.shape[1]
    in_turns(f'edit_stream kernel, main path K={K} m={m} e_pad={e_pad}',
             'base', lambda: check(b_es(
                 0, planes.data_ptr(), 0, 0, 0, 0, t_u8.data_ptr(),
                 *ptrs(outs), grid.data_ptr(), K, m, mb, e_pad, stream())),
             'this tree', lambda: check(n_es(
                 0, 0, planes.data_ptr(), 0, 0, 0, 0, t_u8.data_ptr(),
                 *ptrs(outs), 0, K, m, mb, e_pad, stream())),
             True, results)

    raw = [t.to(I32).contiguous() for t in rga_in[:3]] + \
        [t.to(torch.bool).contiguous() for t in rga_in[3:]]
    Kr, mr = raw[0].shape
    f = rga_fns(raw)
    o_b = rga_out(Kr, mr)
    in_turns(f'rga_order kernel, main path K={Kr} m={mr}',
             'base', lambda: check(b_rga(
                 *ptrs(f['srt']), *ptrs(raw[3:]), *ptrs(o_b), 0, Kr, mr,
                 f['rounds'], stream())),
             'this tree', f['narrow_kernel'], True, results)

    def base_step():
        o, p, q = sequence._child_sort(rga_in[0], rga_in[1], rga_in[2],
                                       rga_in[4])
        o, p, q = (t.to(I32).contiguous() for t in (o, p, q))
        out = rga_out(Kr, mr)
        check(b_rga(o.data_ptr(), p.data_ptr(), q.data_ptr(),
                    *ptrs(raw[3:]), *ptrs(out), 0, Kr, mr, f['rounds'],
                    stream()))
        return out
    in_turns(f'rga_order step, main path K={Kr} m={mr}',
             'base (sort + casts + kernel)', base_step,
             'this tree (_rga_order_batched)',
             lambda: sequence._rga_order_batched(*rga_in), False, results)

    # ---- crossovers of this tree's variants ----
    rng = np.random.default_rng(5)
    for mw in (64, 128, 256, 512):
        Kw = NODES // mw
        raw = [torch.as_tensor(p).to(dev)
               for p in chip_smoke.random_trees(rng, Kw, mw)]
        f = rga_fns(raw)
        w_launch = cuda_build.load('rga_order', 'rga_order_launch',
                                   cuda_sequence._ARGTYPES)
        in_turns(f'rga_order variants, kernel alone, K={Kw} m={mw}',
                 'narrow', f['narrow_kernel'],
                 'wide', lambda: f['wide_kernel'](w_launch), True, results)

        def wide_step():
            o, p, q = sequence._child_sort(raw[0], raw[1], raw[2], raw[4])
            return cuda_sequence.order_from_sorted_cuda(
                o.to(I32), p.to(I32), q.to(I32), raw[3], raw[4],
                rounds=f['rounds'])
        in_turns(f'rga_order variants, step, K={Kw} m={mw}',
                 'narrow', lambda: cuda_sequence.rga_order_cuda(
                     *raw, rounds=f['rounds']),
                 'sort + wide', wide_step, False, results)
    for mw in (64, 256, 512, 1024, 4096):
        Kw = NODES // mw
        _, _, _, _, tb, packed = chip_smoke.random_planes(rng, Kw, mw)
        v = torch.as_tensor(packed).to(dev)
        tu = torch.as_tensor(tb).to(dev)
        in_turns(f'edit_stream variants, K={Kw} m={mw} e_pad=64',
                 'warp', lambda: cuda_view.edit_stream_cuda(
                     'packed', v, tu, 64, force='warp'),
                 'block', lambda: cuda_view.edit_stream_cuda(
                     'packed', v, tu, 64, force='block'), True, results)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(results, fh, indent=1)
    print(f'wrote {args.out} ({card})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
