"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and the script
exits non-zero without a result line):

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the edit-stream CUDA kernel (nvcc, sm_90a) and the native
   host libraries (g++), each timed;
3. kernel vs plain version: the CUDA edit-stream kernel against the
   plain PyTorch version on seeded planes, both input formats, several
   (K, m, e_pad) shapes including the e_pad drop path — bit-equal;
4. main path: a 10,240-document collab-server fleet (about 99 ops per
   document, about 1.01M ops in one fused apply) through
   ``GeneralDocSet(device='cuda').apply_changes_batch`` twice (tick 2
   adds removes, inserts, sets and a conflict on every document) and
   ``materialize_all``; the same two ticks on the CPU (a seeded subset
   of documents in a fleet of their own) must give equal views, and the
   kernel's launch counter must rise on every tick of the main path;
5. one more tick under ``torch.profiler``: device busy time against
   the tick's wall time (the idle share) and the kernels that take it;
6. timings of the kernel at the main path's tick-2 shape beside its
   bound, the plain version and the card name/power limit; the JSON
   kernel line; then the result line.

The workload generators (``gen_mixed_docs``, ``gen_tick2``) are shared
with the tests.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT_ID = '00000000-0000-0000-0000-000000000000'

# H100 SXM peak memory rate (NVIDIA data sheet), bytes/s
_HBM_BYTES_PER_S = 3.35e12


def gen_mixed_docs(n_docs, list_ops, doc0=0):
    """Mixed-op per-doc changes: a list object per doc, two actors with
    a causal chain, interleaved ins/set plus root map sets (the shape of
    the JAX package's config-5 bench fleet). ``list_ops=48`` gives 99
    ops per document."""
    per_doc = []
    for d in range(doc0, doc0 + n_docs):
        obj = f'00000000-0000-4000-8000-{d:012x}'
        ops1 = [{'action': 'makeList', 'obj': obj},
                {'action': 'link', 'obj': ROOT_ID, 'key': 'items',
                 'value': obj}]
        prev = '_head'
        for i in range(list_ops // 2):
            ops1.append({'action': 'ins', 'obj': obj, 'key': prev,
                         'elem': i + 1})
            prev = f'w0-{d}:{i + 1}'
            ops1.append({'action': 'set', 'obj': obj, 'key': prev,
                         'value': i})
        ops2 = []
        for i in range(list_ops // 2, list_ops):
            ops2.append({'action': 'ins', 'obj': obj, 'key': prev,
                         'elem': i + 1})
            prev = f'w1-{d}:{i + 1}'
            ops2.append({'action': 'set', 'obj': obj, 'key': prev,
                         'value': i})
        ops2.append({'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                     'value': d})
        per_doc.append([
            {'actor': f'w0-{d}', 'seq': 1, 'deps': {}, 'ops': ops1},
            {'actor': f'w1-{d}', 'seq': 1, 'deps': {f'w0-{d}': 1},
             'ops': ops2}])
    return per_doc


def gen_tick2(n_docs, list_ops, doc0=0, seed=0, actor='w2'):
    """Tick 2 of every document of :func:`gen_mixed_docs`: a new actor
    ``<actor>-<d>`` (``w2`` by default), concurrent with ``w1-<d>``,
    inserts at the head and after a seeded element of the first half,
    deletes another, re-sets a third, and sets ``meta`` (a conflict
    with ``w1``'s set) — so the edit stream sees removes, inserts and
    sets on every document."""
    rng = np.random.default_rng(seed)
    half = list_ops // 2
    per_doc = []
    for d in range(doc0, doc0 + n_docs):
        obj = f'00000000-0000-4000-8000-{d:012x}'
        a_mid, a_del, a_set = (rng.permutation(half)[:3] + 1).tolist()
        e = list_ops + 1
        ops = [{'action': 'ins', 'obj': obj, 'key': '_head', 'elem': e},
               {'action': 'set', 'obj': obj, 'key': f'{actor}-{d}:{e}',
                'value': f'head-{d}'},
               {'action': 'ins', 'obj': obj, 'key': f'w0-{d}:{a_mid}',
                'elem': e + 1},
               {'action': 'set', 'obj': obj, 'key': f'{actor}-{d}:{e + 1}',
                'value': f'mid-{d}'},
               {'action': 'del', 'obj': obj, 'key': f'w0-{d}:{a_del}'},
               {'action': 'set', 'obj': obj, 'key': f'w0-{d}:{a_set}',
                'value': f'reset-{d}'},
               {'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                'value': -d}]
        per_doc.append([{'actor': f'{actor}-{d}', 'seq': 1,
                         'deps': {f'w0-{d}': 1}, 'ops': ops}])
    return per_doc


def random_planes(rng, K, m):
    """Seeded edit-stream planes: prior/new visibility bits, dense
    unique prior/new ranks among the visible nodes of each row, and a
    touched bitmask covering every class change (the layout the fused
    apply produces)."""
    pv = rng.random((K, m)) < 0.5
    nv = rng.random((K, m)) < 0.5
    touched = (rng.random((K, m)) < 0.4) | (nv & ~pv) | (pv & ~nv)
    pi = np.full((K, m), -1, np.int32)
    ni = np.full((K, m), -1, np.int32)
    cp = pv.sum(axis=1)
    cn = nv.sum(axis=1)
    # per-row random permutations of 0..count-1 at the visible slots
    kp = np.argsort(rng.random((K, m)) + ~pv, axis=1, kind='stable')
    kn = np.argsort(rng.random((K, m)) + ~nv, axis=1, kind='stable')
    rows = np.arange(K)[:, None]
    cols = np.arange(m)[None, :]
    pi[rows, kp] = np.where(cols < cp[:, None], cols, -1)
    ni[rows, kn] = np.where(cols < cn[:, None], cols, -1)
    pi = np.where(pv, pi, -1).astype(np.int32)
    ni = np.where(nv, ni, -1).astype(np.int32)
    tb = np.packbits(touched, axis=1)
    packed = ((pv.astype(np.uint32) << 31) | (nv.astype(np.uint32) << 30)
              | ((pi + 1).astype(np.uint32) << 15)
              | (ni + 1).astype(np.uint32)).view(np.int32)
    return pv, nv, pi, ni, tb, packed


def _card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _max_abs_err(got, want, where):
    """Largest |got - want| over the edit stream's six outputs; raises
    when a dtype or shape differs."""
    import torch
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f'{where}: {a.dtype}{tuple(a.shape)} != '
                                 f'{b.dtype}{tuple(b.shape)}')
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return err


def _span_sum(spans, name):
    return sum(d for n, d in spans if n == name)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from automerge_tpu_torch import native as amnative
    from automerge_tpu_torch.device import cuda_view
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    from automerge_tpu_torch.utils.metrics import metrics

    # ---- 1. card ----
    card = _card_line()
    print(card, flush=True)
    print(f'card: {card} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | devices {torch.cuda.device_count()}',
          flush=True)
    dev = torch.device('cuda')

    # ---- 2. build ----
    t0 = time.perf_counter()
    cuda_view.build(force=True)
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = amnative.build_all()
    t_gpp = time.perf_counter() - t0
    if not all(nat):
        raise RuntimeError(f'native host libraries failed to build: {nat}')
    print(f'build (host of {card}): edit_stream.cu (nvcc sm_90a) '
          f'{t_nvcc:.2f} s, native host libraries (g++) {t_gpp:.2f} s',
          flush=True)

    # ---- 3. kernel vs plain version (tolerance: bit-equal, the
    # kernel computes integer ranks and copies, so any difference is a
    # fault) ----
    rng = np.random.default_rng(1234)
    for K, m, e_pad in ((1, 8, 8), (5, 64, 8), (37, 200, 24),
                        (10240, 64, 64), (64, 4096, 512)):
        pv, nv, pi, ni, tb, packed = random_planes(rng, K, m)
        t_u8 = torch.as_tensor(tb).to(dev)
        v = torch.as_tensor(packed).to(dev)
        cols = (torch.as_tensor(pv).to(dev), torch.as_tensor(nv).to(dev),
                torch.as_tensor(pi).to(dev), torch.as_tensor(ni).to(dev))
        want = cuda_view.edit_stream_packed(v, t_u8, e_pad=e_pad)
        got = cuda_view.edit_stream_cuda('packed', v, t_u8, e_pad)
        torch.cuda.synchronize()
        if _max_abs_err(got, want, 'packed'):
            raise AssertionError(f'packed kernel != plain at {(K, m, e_pad)}')
        want_c = cuda_view.edit_stream(*cols, t_u8, e_pad=e_pad)
        got_c = cuda_view.edit_stream_cuda('cols', cols, t_u8, e_pad)
        torch.cuda.synchronize()
        if _max_abs_err(got_c, want_c, 'cols'):
            raise AssertionError(f'cols kernel != plain at {(K, m, e_pad)}')
        if _max_abs_err(want, want_c, 'plain'):
            raise AssertionError(f'packed plain != cols plain at '
                                 f'{(K, m, e_pad)}')
        drops = bool((want[5] > e_pad).any())
        print(f'kernel: (K={K}, m={m}, e_pad={e_pad}) packed+cols '
              f'bit-equal to the plain version (drop path hit: {drops})',
              flush=True)

    # ---- 4. main path at config-5 size ----
    n_docs, list_ops = 10240, 48
    t0 = time.perf_counter()
    ticks = [gen_mixed_docs(n_docs, list_ops), gen_tick2(n_docs, list_ops)]
    n_ops = [sum(len(c['ops']) for doc in t for c in doc) for t in ticks]
    ids = [f'doc{d}' for d in range(n_docs)]
    t_gen = time.perf_counter() - t0
    print(f'workload: {n_docs} docs, tick 1 {n_ops[0]} ops, tick 2 '
          f'{n_ops[1]} ops (generated in {t_gen:.1f} s)', flush=True)

    # the edit-stream inputs the main path hands the kernel, kept for
    # the kernel-vs-plain check and the timing at those shapes
    es_inputs = []
    real_dispatch = cuda_view.dispatch_edit_stream

    def capture(vis_fmt, planes, touched_u8, e_pad):
        es_inputs.append((vis_fmt, planes, np.array(touched_u8), e_pad))
        return real_dispatch(vis_fmt, planes, touched_u8, e_pad)

    # seeded documents whose diffs and views are checked against the CPU
    sub = np.sort(np.random.default_rng(7).choice(n_docs, 768,
                                                  replace=False)).tolist()

    def run_tick(ds, batch, docs, read, sync):
        """One tick through ``apply_changes_batch``, then the diffs of
        the ``read`` docs from the tick's patch (the first read runs the
        patch read — its edit stream — for the whole tick). Returns
        (diffs, apply ms, patch-read ms, spans)."""
        spans = []

        def on_event(ev):
            if ev.get('event') == 'span':
                spans.append((ev['name'], ev['dur_ms']))

        metrics.subscribe(on_event)
        try:
            t0 = time.perf_counter()
            ds.apply_changes_batch({ids[d]: batch[d] for d in docs})
            sync()
            t1 = time.perf_counter()
            patch = ds.last_patch
            diffs = {ids[d]: patch.diffs(ds.id_of[ids[d]]) for d in read}
            sync()
            t2 = time.perf_counter()
        finally:
            metrics.unsubscribe(on_event)
        return diffs, (t1 - t0) * 1e3, (t2 - t1) * 1e3, spans

    metrics.reset()
    gds = GeneralDocSet(n_docs, device='cuda')
    diffs_gpu = []
    cuda_view.dispatch_edit_stream = capture
    cuda_view.reset_launches()
    try:
        for k, batch in enumerate(ticks):
            before = cuda_view.launches
            diffs, t_apply, t_read, spans = run_tick(
                gds, batch, range(n_docs), sub, torch.cuda.synchronize)
            if cuda_view.launches <= before:
                raise AssertionError(f'tick {k + 1} did not launch the '
                                     f'edit-stream kernel')
            diffs_gpu.append(diffs)
            enc = _span_sum(spans, 'admit.encode')
            fused = _span_sum(spans, 'device.fused_apply')
            print(f'tick {k + 1} ({card}): apply {t_apply:.1f} ms = dict '
                  f'encode {enc:.1f} + admit '
                  f'{_span_sum(spans, "device.admit"):.1f} + stage '
                  f'{_span_sum(spans, "device.stage"):.1f} + dispatch '
                  f'{_span_sum(spans, "device.dispatch"):.1f} + rest '
                  f'{t_apply - enc - fused:.1f} (handlers, device '
                  f'drain); patch read {t_read:.1f} ms (of which the '
                  f'read itself {_span_sum(spans, "device.patch_read"):.1f}'
                  f' ms, the rest {len(sub)} diffs() calls)', flush=True)
        t0 = time.perf_counter()
        views_gpu = gds.materialize_all()
        t_mat = (time.perf_counter() - t0) * 1e3
    finally:
        cuda_view.dispatch_edit_stream = real_dispatch
    launches_main = cuda_view.launches
    native_batches = metrics.counters.get('general_stage_native_batches', 0)
    variants = {k: v for k, v in metrics.counters.items()
                if k.startswith('general_variant_')}
    if launches_main < len(ticks):
        raise AssertionError(f'edit-stream kernel launched {launches_main} '
                             f'times on the {len(ticks)}-tick main path')
    mir = gds.store.pool.mirror
    if mir['fmt'] != 'packed' or mir['w2'].device.type != 'cuda':
        raise AssertionError(f'mirror not packed on the card: {mir["fmt"]}')
    print(f'main path (cuda, {card}): materialize_all {t_mat:.1f} ms, '
          f'edit-stream launches {launches_main}, native staging batches '
          f'{native_batches}, variants {variants}, peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB',
          flush=True)

    # the same two ticks on the CPU, for the seeded subset of documents
    # in a fleet of their own (the whole fleet on the CPU takes minutes)
    cds = GeneralDocSet(len(sub), device='cpu')
    t0 = time.perf_counter()
    diffs_cpu = [run_tick(cds, batch, sub, sub, lambda: None)[0]
                 for batch in ticks]
    views_cpu = cds.materialize_all()
    t_cpu = time.perf_counter() - t0
    for d in sub:
        if views_cpu[ids[d]] != views_gpu[ids[d]]:
            raise AssertionError(f'{ids[d]}: cuda view != cpu view')
        for k in range(len(ticks)):
            if diffs_cpu[k][ids[d]] != diffs_gpu[k][ids[d]]:
                raise AssertionError(f'{ids[d]}: tick-{k + 1} cuda diffs '
                                     f'!= cpu diffs')
    bad = [i for i in ids if len(views_gpu[i]['items']) != list_ops + 1
           or views_gpu[i]['meta'] != -int(i[3:])]
    if bad:
        raise AssertionError(f'unexpected views: {bad[:3]}')
    print(f'check: cuda views and both ticks\' diffs == cpu on a seeded '
          f'subset of {len(sub)} docs (own fleet, {t_cpu:.1f} s on the '
          f'cpu); all {n_docs} cuda views have {list_ops + 1} items and '
          f'w2\'s meta as the conflict winner', flush=True)

    # ---- 5. device busy vs wall ----
    _profile_tick(gds, ids, n_docs, list_ops, card)

    # ---- 6. the kernel at the main path's shapes (each tick's own
    # inputs; the timing at the last, tick 2) ----
    max_abs = 0
    for vis_fmt, planes, tb, e_pad in es_inputs:
        t_u8 = torch.as_tensor(tb).to(dev)
        got = cuda_view.edit_stream_cuda(vis_fmt, planes, t_u8, e_pad)
        want = cuda_view.edit_stream_packed(planes, t_u8, e_pad=e_pad)
        torch.cuda.synchronize()
        max_abs = max(max_abs, _max_abs_err(got, want, 'main path'))
    if max_abs:
        raise AssertionError(f'kernel != plain at a main-path shape '
                             f'(max |diff| {max_abs})')
    K2, m2 = planes.shape
    ms = _time_ms(lambda: cuda_view.edit_stream_cuda(
        vis_fmt, planes, t_u8, e_pad))
    plain_ms = _time_ms(lambda: cuda_view.edit_stream_packed(
        planes, t_u8, e_pad=e_pad), iters=20)
    bytes_moved = K2 * m2 * 4 + K2 * tb.shape[1] + 5 * K2 * e_pad * 4 + \
        12 * K2
    bound_ms = bytes_moved / _HBM_BYTES_PER_S * 1e3
    print(f'edit-stream kernel ({card}): tick-2 shape K={K2} m={m2} '
          f'e_pad={e_pad}: {ms:.4f} ms/launch, plain PyTorch '
          f'{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bytes_moved} '
          f'bytes at 3.35 TB/s), max |kernel - plain| {max_abs}',
          flush=True)
    print(json.dumps({'kernels': [{
        'name': 'edit_stream', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/edit_stream.cu',
        'replaces': 'automerge_tpu/device/pallas_view.py:233',
        'launches': launches_main, 'max_abs_err': max_abs,
        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': 'bytes', 'library_ms': None}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def _profile_tick(gds, ids, n_docs, list_ops, card):
    """One more tick (a fourth actor per document) under
    ``torch.profiler``: device busy time against the tick's wall time,
    and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tick3 = gen_tick2(n_docs, list_ops, seed=1, actor='w3')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gds.apply_changes_batch({ids[d]: tick3[d] for d in range(n_docs)})
        gds.last_patch.diffs(0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels and copies): the aten op rows
    # carry the same device time again as their own "self" time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    if not rows:
        raise AssertionError('torch.profiler recorded no device events '
                             'for tick 3; the idle share was not measured')
    print(f'profile (tick 3 under torch.profiler, {card}): wall '
          f'{wall:.1f} ms, device busy {busy:.2f} ms, idle share '
          f'{1 - busy / wall:.4f}', flush=True)
    for key, ms, n in rows[:8]:
        print(f'profile:   {ms:9.3f} ms  x{n:<5d} {key[:90]}', flush=True)


if __name__ == '__main__':
    sys.exit(main())
