"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and the script
exits non-zero without a result line):

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the three CUDA kernels (one nvcc per source, sm_90a, all
   started together) and the native host libraries (g++), each timed;
3. kernels vs plain versions, bit-equal: the edit stream on seeded
   planes (both input formats, its warp and block variants, (K, m,
   e_pad) shapes from m = 8 to 32,767 on both sides of ``M_WARP_ES``,
   e_pad = 1, e_pad = m and the e_pad drop path); the RGA order on
   seeded random, prepend, chain and wide-key trees at (K, m) up to
   (12288, 64),
   both sides of ``M_NARROW``, (64, 4096) and (2, 40000) — through the
   dispatch (narrow kernel, or sort + wide kernel, the last shape on
   its global-memory variant) and, up to m = 512, both kernels
   directly; the flat-map resolve's dispatch and both its variants
   (warp and block, forced) on ``gen_docset_workload(cross_clock=True)``
   batches up to the flagship 10,240 docs x 128 ops x 8 actors and
   10,241 docs, and a 6,000-segment shape on the block variant's global
   memory;
4. the general engine's tick: a 10,240-document collab-server fleet
   (about 99 ops per document, about 1.01M ops in one fused apply)
   through ``GeneralDocSet(device='cuda').apply_changes_batch`` twice
   (tick 2 adds removes, inserts, sets and a conflict on every
   document) and ``materialize_all``; the same two ticks on the CPU (a
   seeded subset of documents in a fleet of their own) must give equal
   views, and the edit-stream and RGA kernels' launch counters must rise
   on every tick;
5. the per-doc device backend: ``DeviceDocSet(device='cuda')
   .apply_changes_batch`` on a 10,240-document map-only fleet (8
   concurrent actors x 16 set/del ops over 32 keys per document,
   1,310,720 ops: the flat-map kernel) and a 10,240-document list fleet
   (the tick-1 documents above: the fused step and its RGA kernel); the
   documents must equal ``DeviceDocSet(device='cpu')`` on a seeded
   768-document subset and the host oracle ``DocSet`` on 64;
6. one more general tick under ``torch.profiler``: device busy time
   against the tick's wall time (the idle share) and the kernels that
   take it;
7. every main-path input (raw planes as the paths hand them over)
   through each kernel against its plain version, and the variant each
   path ran; timings at the main path's shapes: each kernel's device
   time (50 launches captured in a CUDA graph, median, min and max of 5
   replays), the edit-stream call and the whole RGA step as a caller
   pays them (eager, 5 x 50 calls), beside the bound, the plain version
   and the card's name and power limit; the JSON kernel line (with each
   kernel's variant); then the result line.

Every launch counter is set to 0 just before a path is driven and read
just after it. The workload generators (``gen_mixed_docs``,
``gen_tick2``, ``random_planes``, ``random_trees``, ``prepend_trees``,
``chain_trees``, ``wide_key_trees``) are shared with the tests.
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


def random_trees(rng, K, m):
    """Seeded [K, m] RGA job planes (int32 parent/elem/actor, bool
    visible/valid): row k holds an insertion tree of n_k valid nodes
    (node 0 the head, every parent an earlier node: mostly typing
    chains with random branches), Lamport counters with ties among
    siblings, actor ranks and tombstones; the rest of the row is
    padding. The first row is full and, when K > 2, the last is all
    padding."""
    parent = np.zeros((K, m), np.int32)
    elem = np.zeros((K, m), np.int32)
    actor = np.zeros((K, m), np.int32)
    visible = np.zeros((K, m), bool)
    valid = np.zeros((K, m), bool)
    n = rng.integers(1, m + 1, K)
    n[0] = m
    if K > 2:
        n[-1] = 0
    for k in range(K):
        nk = int(n[k])
        valid[k, :nk] = True
        if nk < 2:
            continue
        chain = np.arange(nk - 1)
        jump = (rng.random(nk - 1) * np.arange(1, nk)).astype(np.int32)
        parent[k, 1:nk] = np.where(rng.random(nk - 1) < 0.6, chain, jump)
        elem[k, 1:nk] = rng.integers(1, max(nk // 2, 2), nk - 1)
        actor[k, 1:nk] = rng.integers(0, 4, nk - 1)
        visible[k, 1:nk] = rng.random(nk - 1) < 0.7
    return parent, elem, actor, visible, valid


def _tree_rows(rng, K, m, parent_of):
    """[K, m] RGA job planes of :func:`random_trees`' row layout (row 0
    full, the last row all padding when K > 2, the rest ragged) whose
    valid nodes take their parents from ``parent_of(nk)`` and their
    Lamport counters and actors in pairs, so that (elem, actor) ties
    fall to the node index."""
    parent = np.zeros((K, m), np.int32)
    elem = np.zeros((K, m), np.int32)
    actor = np.zeros((K, m), np.int32)
    visible = np.zeros((K, m), bool)
    valid = np.zeros((K, m), bool)
    n = rng.integers(1, m + 1, K)
    n[0] = m
    if K > 2:
        n[-1] = 0
    for k in range(K):
        nk = int(n[k])
        valid[k, :nk] = True
        if nk < 2:
            continue
        parent[k, 1:nk] = parent_of(nk)
        elem[k, 1:nk] = np.arange(2, nk + 1) // 2
        actor[k, 1:nk] = rng.integers(0, 2, nk - 1)
        visible[k, 1:nk] = rng.random(nk - 1) < 0.7
    return parent, elem, actor, visible, valid


def prepend_trees(rng, K, m):
    """Seeded job planes in which every node is a child of the head, as
    a list built by prepending: the narrow RGA kernel's worst case (one
    sort bucket of m-1 siblings)."""
    return _tree_rows(rng, K, m, lambda nk: np.zeros(nk - 1, np.int32))


def chain_trees(rng, K, m):
    """Seeded job planes holding pure typing chains (node i's parent is
    node i-1), with (elem, actor) ties and padding rows."""
    return _tree_rows(rng, K, m, lambda nk: np.arange(nk - 1, dtype=np.int32))


def wide_key_trees(rng, K, m):
    """:func:`random_trees` with Lamport counters drawn over the whole
    int32 range (its ends included), and actor ranks too on even rows:
    child-sort keys that need more than 32 bits (odd rows: the narrow RGA
    kernel's 64-bit key) or more than 64 (even rows: its 128-bit
    compare)."""
    parent, elem, actor, visible, valid = random_trees(rng, K, m)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    elem = rng.integers(lo, hi, (K, m), endpoint=True).astype(np.int32)
    elem[:, -1] = lo
    actor[::2] = rng.integers(lo, hi, actor[::2].shape, endpoint=True)
    actor[::2, -1] = hi
    return parent, elem, actor, visible, valid


TREES = {'random': random_trees, 'prepend': prepend_trees,
         'chain': chain_trees}


def _card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_samples(fn, iters=50, reps=5, warmup=5, graph=False):
    """``reps`` CUDA-event timings of ``iters`` back-to-back calls of
    ``fn`` (after ``warmup`` calls), in ms per call. With ``graph`` the
    ``iters`` calls are captured once into a CUDA graph and each timing
    replays it: the device's time alone, without the host's launch
    overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode='relaxed'):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        if g is not None:
            g.replay()
        else:
            for _ in range(iters):
                fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / iters)
    return out


def _time_ms(fn, iters=50, reps=5, graph=False):
    """(median, min, max) ms per call over ``reps`` timings of ``iters``
    calls (see :func:`_time_samples`)."""
    t = _time_samples(fn, iters, reps, graph=graph)
    return float(np.median(t)), min(t), max(t)


def _fmt_t(t):
    return f'{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})'


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


def doc_view(doc):
    """A frontend document as plain Python: (value, conflicts), maps as
    dicts, lists as lists, text as a string — what two backends must
    agree on."""
    def conv(obj):
        name = type(obj).__name__
        if name == 'Text':
            return ''.join(str(c) for c in obj)
        if name == 'AmList':
            return [conv(v) for v in obj]
        if hasattr(obj, '_conflicts'):
            return {k: conv(v) for k, v in obj.items()}
        return obj

    def confl(obj):
        name = type(obj).__name__
        out = {}
        if hasattr(obj, '_conflicts'):
            out['.'] = obj._conflicts
            items = obj.items() if name not in ('AmList', 'Text') else \
                enumerate(obj)
            for k, v in items:
                sub = confl(v)
                if sub:
                    out[k] = sub
        return out
    return conv(doc), confl(doc)


def gen_map_fleet(n_docs, seed=11):
    """The per-doc backend's map-only batch: in each document, 8
    concurrent actors each send one change of 16 set/del ops over 32
    root keys (128 ops per document; ``workloads.gen_block_workload``
    with a tenth of the ops deletes)."""
    from automerge_tpu_torch.device.workloads import gen_block_workload
    return gen_block_workload(n_docs=n_docs, n_actors=8, ops_per_change=16,
                              n_keys=32, seed=seed, del_p=0.1).to_changes()


def _reset_counts(*mods):
    for mod in mods:
        mod.reset_launches()


def _bits_err(got, want, where, mask=None):
    """Largest |got - want| over a dict of integer outputs (``mask``
    restricts ``tree_pos`` to valid rows); raises when a dtype or shape
    differs."""
    import torch
    err = 0
    for k in want:
        a, b = got[k], want[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f'{where} {k}: {a.dtype}{tuple(a.shape)} '
                                 f'!= {b.dtype}{tuple(b.shape)}')
        if k == 'tree_pos' and mask is not None:
            a, b = a[mask], b[mask]
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return err


def _check_rga_kernel(dev):
    """Phase 3b: the RGA kernels against their plain versions on seeded
    random, prepend, chain and wide-key trees (the last on the narrow
    kernel's 64-bit and 128-bit key paths), through the dispatch (narrow
    up to ``M_NARROW``, wide above, the last shape on the wide variant's
    global memory) and, up to ``M_NARROW``, both variants directly."""
    import torch
    from automerge_tpu_torch.device import cuda_sequence, sequence
    n = cuda_sequence.M_NARROW
    for tree, gen in (*TREES.items(), ('wide-key', wide_key_trees)):
        rng = np.random.default_rng(4321)
        for K, m in ((1, 2), (6, 16), (37, 200), (12288, 64), (300, n),
                     (300, n + 1), (64, 4096), (2, 40000)):
            planes = [torch.as_tensor(p).to(dev) for p in gen(rng, K, m)]
            want = sequence._rga_order_plain(*planes)
            got = {'dispatch': sequence._rga_order_batched(*planes)}
            ran = cuda_sequence.last_variant
            if ran != cuda_sequence.variant(m) or \
                    (ran == 'wide-global') != (m == 40000):
                raise AssertionError(f'rga {tree} at m={m}: ran {ran}')
            rounds = sequence._ceil_log2(m) + 1
            if m <= cuda_sequence.M_NARROW:
                got['narrow'] = cuda_sequence.rga_order_cuda(
                    *(t.to(torch.int32) for t in planes[:3]), planes[3],
                    planes[4], rounds=rounds)
                order, padj, parent = sequence._child_sort(
                    planes[0], planes[1], planes[2], planes[4])
                got['wide'] = cuda_sequence.order_from_sorted_cuda(
                    order.to(torch.int32), padj.to(torch.int32),
                    parent.to(torch.int32), planes[3], planes[4],
                    rounds=rounds)
            torch.cuda.synchronize()
            for how, out in got.items():
                if _bits_err(out, want, f'rga {(K, m)}', mask=planes[4]):
                    raise AssertionError(f'rga {how} kernel != plain on '
                                         f'{tree} trees at {(K, m)}')
            print(f'kernel: rga_order {tree} trees (K={K}, m={m}) '
                  f'bit-equal to the plain version: {", ".join(got)} '
                  f'(dispatch ran {ran})', flush=True)


def _check_flatmap_kernel(dev):
    """Phase 3c: the flat-map kernel's variants (the dispatch's pick, and
    the warp and block variants forced) against the plain version on
    ``gen_docset_workload(cross_clock=True)`` at the Pallas tests'
    shapes, the flagship shape (and one document more: a partial CTA)
    and a slot-heavy shape on the block variant's global memory; the
    first document's first ops carry out-of-range segment ids."""
    import torch
    from automerge_tpu_torch.device import cuda_merge, merge
    from automerge_tpu_torch.device.workloads import gen_docset_workload
    for D, N, A, keys, S in ((1, 8, 2, 3, 8), (3, 130, 4, 7, 130),
                             (8, 128, 8, 32, 128), (9, 257, 3, 40, 257),
                             (10240, 128, 8, 32, 32),
                             (10241, 128, 8, 32, 32),
                             (4, 64, 8, 6000, 6000)):
        args = [torch.as_tensor(a).to(dev) for a in gen_docset_workload(
            n_docs=D, n_ops=N, n_actors=A, n_keys=keys, seed=D + N,
            del_p=0.1, invalid_p=0.1, cross_clock=True)]
        args[0][0, :3] = torch.tensor([-1, S, -S - 2], dtype=torch.int32)
        want = merge.resolve_assignments_batch(*args, num_segments=S)
        picked = cuda_merge.variant(N, S, A)
        ran = []
        for force in (None, 'warp', 'block'):
            if force == 'warp' and cuda_merge.warp_slice_bytes(N, S, A) > \
                    cuda_merge._SMEM_LIMIT:
                continue
            got = cuda_merge.resolve_cuda(*args, num_segments=S,
                                          force=force)
            torch.cuda.synchronize()
            ran.append(cuda_merge.last_variant)
            if force is None and ran[-1] != picked:
                raise AssertionError(f'flatmap at {(D, N, A, S)} ran '
                                     f'{ran[-1]}, not {picked}')
            if _bits_err(got, want, f'flatmap {(D, N, A, S)}'):
                raise AssertionError(f'flatmap {ran[-1]} kernel != plain '
                                     f'at {(D, N, A, S)}')
        print(f'kernel: flatmap_resolve (D={D}, N={N}, A={A}, S={S}) '
              f'bit-equal to the plain version: {", ".join(ran[1:])} '
              f'(dispatch picks {picked})', flush=True)


def _device_doc_set_path(card, n_docs, list_ops):
    """Phase 5: the per-doc device backend behind ``DeviceDocSet(device=
    'cuda')`` at config-5 size, two batches — a map-only fleet (the
    flat-map kernel) and a list fleet (the fused step's RGA kernel) —
    each checked against ``DeviceDocSet(device='cpu')`` on a seeded
    768-document subset and the host-oracle ``DocSet`` on 64 of them.
    Returns (launch counts, captured kernel inputs)."""
    import torch
    from automerge_tpu_torch.device import backend as DB
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    from automerge_tpu_torch.sync import DeviceDocSet, DocSet

    t0 = time.perf_counter()
    batches = [('map', 'm', gen_map_fleet(n_docs)),
               ('list', 'l', gen_mixed_docs(n_docs, list_ops))]
    print(f'device doc set: generated {n_docs} map docs '
          f'({sum(len(c["ops"]) for d in batches[0][2] for c in d)} ops) '
          f'and {n_docs} list docs '
          f'({sum(len(c["ops"]) for d in batches[1][2] for c in d)} ops) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # host staging vs device step, by wrapping the backend's phases
    phase_s = {}
    host = ('_admit_changes', '_stage_changes', '_collect_seq_jobs',
            '_pack_docs', '_pack_seq_jobs')
    dev_fns = ('_resolve_batch', '_fused_step')
    originals = {n: getattr(DB, n) for n in host + dev_fns}

    def timed(name, fn, sync):
        key = 'host' if name in host else 'device'

        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            phase_s[key] = phase_s.get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    # the kernel inputs the path hands the kernels, for the timings (the
    # RGA order's raw planes, as the backend hands them to
    # _rga_order_batched)
    captured = {}
    real_rga = DB._rga_order_batched
    real_fm = cuda_merge.resolve_cuda

    def cap_rga(*a):
        captured['rga'] = a
        return real_rga(*a)

    def cap_fm(*a, **kw):
        captured['flatmap'] = (a, kw)
        return real_fm(*a, **kw)

    dds = DeviceDocSet(device='cuda')
    counts = {}
    for name, fn in originals.items():
        setattr(DB, name, timed(name, fn, name in dev_fns))
    DB._rga_order_batched = cap_rga
    cuda_merge.resolve_cuda = cap_fm
    try:
        _reset_counts(cuda_view, cuda_sequence, cuda_merge)
        for name, prefix, per_doc in batches:
            before = (cuda_merge.launches, cuda_sequence.launches)
            phase_s.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dds.apply_changes_batch({f'{prefix}{d}': per_doc[d]
                                     for d in range(n_docs)})
            torch.cuda.synchronize()
            t_apply = (time.perf_counter() - t0) * 1e3
            fm = cuda_merge.launches - before[0]
            rga = cuda_sequence.launches - before[1]
            if name == 'map' and fm < 1:
                raise AssertionError('the map-only batch did not launch the '
                                     'flat-map kernel')
            if name == 'list' and rga < 1:
                raise AssertionError('the list batch did not launch the RGA '
                                     'kernel')
            print(f'device doc set {name} batch ({card}): apply {t_apply:.1f}'
                  f' ms = host staging {phase_s.get("host", 0) * 1e3:.1f} + '
                  f'device step {phase_s.get("device", 0) * 1e3:.1f} + rest '
                  f'(unpack, diffs, frontend patches) '
                  f'{t_apply - sum(phase_s.values()) * 1e3:.1f}; launches '
                  f'flat-map {fm} rga {rga}; peak device memory '
                  f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB',
                  flush=True)
        counts = {'flatmap_resolve': cuda_merge.launches,
                  'rga_order': cuda_sequence.launches,
                  'edit_stream': cuda_view.launches,
                  'rga_variant': cuda_sequence.last_variant,
                  'flatmap_variant': cuda_merge.last_variant}
    finally:
        for name, fn in originals.items():
            setattr(DB, name, fn)
        DB._rga_order_batched = real_rga
        cuda_merge.resolve_cuda = real_fm

    # the same batches on the CPU (seeded subset, a doc set of its own)
    # and on the host oracle (64 of those documents)
    sub = np.sort(np.random.default_rng(9).choice(n_docs, 768,
                                                  replace=False)).tolist()
    cds, ods = DeviceDocSet(device='cpu'), DocSet()
    t0 = time.perf_counter()
    for _, prefix, per_doc in batches:
        cds.apply_changes_batch({f'{prefix}{d}': per_doc[d] for d in sub})
        for d in sub[:64]:
            ods.apply_changes(f'{prefix}{d}', per_doc[d])
    t_cpu = time.perf_counter() - t0
    for _, prefix, _b in batches:
        for k, d in enumerate(sub):
            doc_id = f'{prefix}{d}'
            got = doc_view(dds.get_doc(doc_id))
            if got != doc_view(cds.get_doc(doc_id)):
                raise AssertionError(f'{doc_id}: cuda doc != cpu doc')
            if k < 64 and got != doc_view(ods.get_doc(doc_id)):
                raise AssertionError(f'{doc_id}: cuda doc != oracle doc')
    bad = [d for d in range(n_docs)
           if len(doc_view(dds.get_doc(f'l{d}'))[0]['items']) != list_ops]
    if bad:
        raise AssertionError(f'list docs of the wrong length: {bad[:3]}')
    print(f'check: device doc set cuda docs (values and conflicts) == cpu '
          f'on a seeded subset of {len(sub)} docs per batch and == the '
          f'host oracle on 64 ({t_cpu:.1f} s on the cpu); all {n_docs} '
          f'lists have {list_ops} items', flush=True)
    return counts, captured


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from automerge_tpu_torch import native as amnative
    from automerge_tpu_torch.device import (cuda_build, cuda_merge,
                                            cuda_sequence, cuda_view, merge,
                                            sequence)
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    from automerge_tpu_torch.utils.metrics import metrics

    # ---- 1. card ----
    card = _card_line()
    print(card, flush=True)
    print(f'card: {card} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | devices {torch.cuda.device_count()}',
          flush=True)
    dev = torch.device('cuda')

    # ---- 2. build (one nvcc per kernel source, all at once) ----
    t0 = time.perf_counter()
    nvcc_s = cuda_build.build_all(force=True)
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = amnative.build_all()
    t_gpp = time.perf_counter() - t0
    if not all(nat):
        raise RuntimeError(f'native host libraries failed to build: {nat}')
    print(f'build (host of {card}): ' + ', '.join(
        f'{n}.cu {s:.2f} s' for n, s in nvcc_s.items())
        + f' (nvcc sm_90a, in parallel: {t_nvcc:.2f} s), native host '
        f'libraries (g++) {t_gpp:.2f} s', flush=True)

    # ---- 3. kernels vs plain versions (tolerance: bit-equal, the
    # kernels compute integer ranks, maxima and copies, so any
    # difference is a fault) ----
    rng = np.random.default_rng(1234)
    w = cuda_view.M_WARP_ES
    for K, m, e_pad in ((1, 8, 8), (5, 64, 8), (4, 33, 1), (4, 33, 33),
                        (37, 200, 24), (10240, 64, 64), (64, w, 128),
                        (64, w + 1, 128), (64, 4096, 512), (9, 32767, 64)):
        pv, nv, pi, ni, tb, packed = random_planes(rng, K, m)
        t_u8 = torch.as_tensor(tb).to(dev)
        v = torch.as_tensor(packed).to(dev)
        cols = (torch.as_tensor(pv).to(dev), torch.as_tensor(nv).to(dev),
                torch.as_tensor(pi).to(dev), torch.as_tensor(ni).to(dev))
        want = cuda_view.edit_stream_packed(v, t_u8, e_pad=e_pad)
        want_c = cuda_view.edit_stream(*cols, t_u8, e_pad=e_pad)
        if _max_abs_err(want, want_c, 'plain'):
            raise AssertionError(f'packed plain != cols plain at '
                                 f'{(K, m, e_pad)}')
        picked = cuda_view.variant(m)
        for force in (None, 'warp', 'block'):
            for fmt, planes in (('packed', v), ('cols', cols)):
                got = cuda_view.edit_stream_cuda(fmt, planes, t_u8, e_pad,
                                                 force=force)
                torch.cuda.synchronize()
                if force is None and cuda_view.last_variant != picked:
                    raise AssertionError(f'edit stream at m={m} ran '
                                         f'{cuda_view.last_variant}')
                if _max_abs_err(got, want, fmt):
                    raise AssertionError(
                        f'{fmt} kernel ({cuda_view.last_variant}) != plain '
                        f'at {(K, m, e_pad)}')
        drops = bool((want[5] > e_pad).any())
        print(f'kernel: edit_stream (K={K}, m={m}, e_pad={e_pad}) packed+'
              f'cols, warp and block variants, bit-equal to the plain '
              f'version (dispatch picks {picked}; drop path hit: {drops})',
              flush=True)
    _check_rga_kernel(dev)
    _check_flatmap_kernel(dev)

    # ---- 4. main path at config-5 size ----
    n_docs, list_ops = 10240, 48
    t0 = time.perf_counter()
    ticks = [gen_mixed_docs(n_docs, list_ops), gen_tick2(n_docs, list_ops)]
    n_ops = [sum(len(c['ops']) for doc in t for c in doc) for t in ticks]
    ids = [f'doc{d}' for d in range(n_docs)]
    t_gen = time.perf_counter() - t0
    print(f'workload: {n_docs} docs, tick 1 {n_ops[0]} ops, tick 2 '
          f'{n_ops[1]} ops (generated in {t_gen:.1f} s)', flush=True)

    # the edit-stream and RGA inputs the main path hands the kernels,
    # kept for the kernel-vs-plain check and the timing at those shapes
    # (the RGA order's raw planes, as the engine hands them to
    # sequence._rga_order_batched)
    es_inputs, rga_inputs = [], []
    real_dispatch = cuda_view.dispatch_edit_stream
    real_rga = sequence._rga_order_batched

    def capture(vis_fmt, planes, touched_u8, e_pad):
        es_inputs.append((vis_fmt, planes, np.array(touched_u8), e_pad))
        return real_dispatch(vis_fmt, planes, touched_u8, e_pad)

    def capture_rga(*a):
        rga_inputs.append(a)
        return real_rga(*a)

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
    sequence._rga_order_batched = capture_rga
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    try:
        for k, batch in enumerate(ticks):
            before = (cuda_view.launches, cuda_sequence.launches)
            diffs, t_apply, t_read, spans = run_tick(
                gds, batch, range(n_docs), sub, torch.cuda.synchronize)
            if cuda_view.launches <= before[0]:
                raise AssertionError(f'tick {k + 1} did not launch the '
                                     f'edit-stream kernel')
            if cuda_sequence.launches <= before[1]:
                raise AssertionError(f'tick {k + 1} did not launch the RGA '
                                     f'kernel')
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
        sequence._rga_order_batched = real_rga
    launches_main = cuda_view.launches
    rga_main = cuda_sequence.launches
    ran = {'edit_stream': cuda_view.last_variant,
           'rga_order': cuda_sequence.last_variant}
    native_batches = metrics.counters.get('general_stage_native_batches', 0)
    variants = {k: v for k, v in metrics.counters.items()
                if k.startswith('general_variant_')}
    if launches_main < len(ticks) or rga_main < len(ticks):
        raise AssertionError(f'edit-stream kernel launched {launches_main} '
                             f'and RGA kernel {rga_main} times on the '
                             f'{len(ticks)}-tick main path')
    if cuda_merge.launches:
        raise AssertionError('the general tick launched the flat-map kernel')
    mir = gds.store.pool.mirror
    if mir['fmt'] != 'packed' or mir['w2'].device.type != 'cuda':
        raise AssertionError(f'mirror not packed on the card: {mir["fmt"]}')
    print(f'main path (cuda, {card}): materialize_all {t_mat:.1f} ms, '
          f'edit-stream launches {launches_main}, rga launches {rga_main}, '
          f'native staging batches {native_batches}, variants {variants}, '
          f'peak device memory '
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

    # ---- 5. the per-doc device backend: DeviceDocSet at config-5 size ----
    dds_counts, dds_inputs = _device_doc_set_path(card, n_docs, list_ops)

    # ---- 6. device busy vs wall ----
    _profile_tick(gds, ids, n_docs, list_ops, card)

    # ---- 7. the kernels at the main path's shapes ----
    kernels = []
    # edit stream: each tick's own inputs; the timing at the last, tick 2
    max_abs = 0
    for vis_fmt, planes, tb, e_pad in es_inputs:
        t_u8 = torch.as_tensor(tb).to(dev)
        got = cuda_view.edit_stream_cuda(vis_fmt, planes, t_u8, e_pad)
        want = cuda_view.edit_stream_packed(planes, t_u8, e_pad=e_pad)
        torch.cuda.synchronize()
        max_abs = max(max_abs, _max_abs_err(got, want, 'main path'))
        if cuda_view.last_variant != cuda_view.variant(planes.shape[1]):
            raise AssertionError(f'edit stream ran {cuda_view.last_variant}'
                                 f' at a main-path shape')
    if max_abs:
        raise AssertionError(f'kernel != plain at a main-path shape '
                             f'(max |diff| {max_abs})')
    if ran['edit_stream'] != cuda_view.variant(planes.shape[1]):
        raise AssertionError(f'the main path ran the {ran["edit_stream"]} '
                             f'edit-stream variant')
    K2, m2 = planes.shape
    es_t = _time_ms(lambda: cuda_view.edit_stream_cuda(
        vis_fmt, planes, t_u8, e_pad), graph=True)
    es_eager = _time_ms(lambda: cuda_view.edit_stream_cuda(
        vis_fmt, planes, t_u8, e_pad))
    plain_t = _time_ms(lambda: cuda_view.edit_stream_packed(
        planes, t_u8, e_pad=e_pad), iters=20)
    bytes_moved = K2 * m2 * 4 + K2 * tb.shape[1] + 5 * K2 * e_pad * 4 + \
        12 * K2
    bound_ms = bytes_moved / _HBM_BYTES_PER_S * 1e3
    print(f'edit-stream kernel ({card}): tick-2 shape K={K2} m={m2} '
          f'e_pad={e_pad}, {ran["edit_stream"]} variant: {_fmt_t(es_t)} per '
          f'launch on the device (a CUDA graph of 50 launches, median of 5 '
          f'replays), {_fmt_t(es_eager)} called eagerly; plain PyTorch '
          f'{_fmt_t(plain_t)}; bound {bound_ms:.5f} ms ({bytes_moved} bytes '
          f'at 3.35 TB/s); max |kernel - plain| {max_abs}', flush=True)
    kernels.append({
        'name': 'edit_stream', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/edit_stream.cu',
        'replaces': 'automerge_tpu/device/pallas_view.py:233',
        'launches': launches_main + dds_counts['edit_stream'],
        'max_abs_err': max_abs, 'ms': es_t[0], 'plain_ms': plain_t[0],
        'bound_ms': bound_ms, 'bound_by': 'bytes', 'library_ms': None,
        'variant': ran['edit_stream']})

    # RGA order: every main-path input (both ticks and the device doc
    # set's list batch, raw planes) through the dispatch against the
    # plain version; timed at the general tick 2 and the list batch —
    # the kernel alone, the whole step as the path pays it, and the
    # PyTorch sort + wide kernel step beside it
    rga_timed = (('general tick 2', rga_inputs[-1]),
                 ('device doc set list batch', dds_inputs['rga']))
    rga_inputs.append(dds_inputs['rga'])
    rga_err = 0
    for a in rga_inputs:
        got = sequence._rga_order_batched(*a)
        want = sequence._rga_order_plain(*a)
        torch.cuda.synchronize()
        rga_err = max(rga_err, _bits_err(got, want, 'rga main path',
                                         mask=a[4].to(torch.bool)))
        if cuda_sequence.last_variant != cuda_sequence.variant(a[0].shape[1]):
            raise AssertionError(f'rga ran {cuda_sequence.last_variant} at '
                                 f'a main-path shape')
    if rga_err:
        raise AssertionError(f'rga kernel != plain at a main-path shape '
                             f'(max |diff| {rga_err})')
    for path in ('rga_order', 'rga_variant'):
        v = ran['rga_order'] if path == 'rga_order' else \
            dds_counts['rga_variant']
        if v != cuda_sequence.variant(rga_inputs[0][0].shape[1]):
            raise AssertionError(f'a main path ran the {v} RGA variant')
    rga_times = []
    for label, a in rga_timed:
        Kr, mr = a[0].shape
        rounds = sequence._ceil_log2(mr) + 1
        raw = [t.to(torch.int32).contiguous() for t in a[:3]] + \
            [t.to(torch.bool).contiguous() for t in a[3:]]
        srt = [t.to(torch.int32).contiguous()
               for t in sequence._child_sort(a[0], a[1], a[2], a[4])]
        r_kernel = _time_ms(lambda: cuda_sequence.rga_order_cuda(
            *raw, rounds=rounds), graph=True)
        r_step = _time_ms(lambda: sequence._rga_order_batched(*a))
        r_wide = _time_ms(lambda: cuda_sequence.order_from_sorted_cuda(
            *srt, *raw[3:], rounds=rounds), graph=True)

        def sort_wide():
            o, p, q = sequence._child_sort(a[0], a[1], a[2], a[4])
            return cuda_sequence.order_from_sorted_cuda(
                o.to(torch.int32), p.to(torch.int32), q.to(torch.int32),
                *raw[3:], rounds=rounds)
        r_sort_wide = _time_ms(sort_wide)
        r_plain = _time_ms(lambda: sequence._rga_order_plain(*a), iters=20)
        # inputs: parent, elem, actor int32 + visible, valid bool;
        # outputs: three int32 planes + int32 length
        r_bytes = Kr * mr * (4 * 3 + 2) + Kr * mr * 12 + Kr * 4
        r_bound = r_bytes / _HBM_BYTES_PER_S * 1e3
        rga_times.append((r_kernel, r_plain, r_bound))
        print(f'rga_order kernel ({card}): {label} shape K={Kr} m={mr}, '
              f'narrow variant: {_fmt_t(r_kernel)} per launch on the device '
              f'(a CUDA graph of 50 launches, median of 5 replays); the '
              f'whole step (_rga_order_batched, called eagerly) '
              f'{_fmt_t(r_step)}; beside it the wide kernel on the sorted '
              f'planes {_fmt_t(r_wide)} (device) and the PyTorch sort + wide '
              f'kernel step {_fmt_t(r_sort_wide)} (eager); plain PyTorch '
              f'{_fmt_t(r_plain)}; bound {r_bound:.5f} ms ({r_bytes} bytes '
              f'at 3.35 TB/s); max |kernel - plain| {rga_err}', flush=True)
    r_kernel, r_plain, r_bound = rga_times[-1]
    kernels.append({
        'name': 'rga_order', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/rga_order.cu',
        'replaces': 'automerge_tpu/device/pallas_sequence.py:165',
        'launches': rga_main + dds_counts['rga_order'],
        'max_abs_err': rga_err, 'ms': r_kernel[0], 'plain_ms': r_plain[0],
        'bound_ms': r_bound, 'bound_by': 'bytes', 'library_ms': None,
        'variant': ran['rga_order']})

    # flat-map resolve: the map batch's own inputs, through the variant
    # the path ran and the block variant beside it
    a, kw = dds_inputs['flatmap']
    D, N = a[0].shape
    A = a[3].shape[2]
    S = kw['num_segments']
    fm_ran = dds_counts['flatmap_variant']
    if fm_ran != cuda_merge.variant(N, S, A):
        raise AssertionError(f'the map batch ran the {fm_ran} flat-map '
                             f'variant')
    want = merge.resolve_assignments_batch(*a, **kw)
    fm_err = 0
    for force in (None, 'block'):
        got = cuda_merge.resolve_cuda(*a, **kw, force=force)
        torch.cuda.synchronize()
        fm_err = max(fm_err, _bits_err(got, want, 'flatmap main path'))
    if fm_err:
        raise AssertionError(f'flatmap kernel != plain at the main-path '
                             f'shape (max |diff| {fm_err})')
    f_t = _time_ms(lambda: cuda_merge.resolve_cuda(*a, **kw), graph=True)
    f_block = _time_ms(lambda: cuda_merge.resolve_cuda(*a, **kw,
                                                       force='block'),
                       graph=True)
    f_eager = _time_ms(lambda: cuda_merge.dispatch_resolve(*a, **kw))
    # the plain version is the torch segment resolve (kernel='xla')
    f_plain = _time_ms(lambda: merge.resolve_assignments_batch(*a, **kw),
                       iters=20)
    # inputs: seg_id, actor, seq int32 + clock int32 [D, N, A] + is_del,
    # valid bool; outputs: surviving bool + winner, seg_max_actor int32
    f_bytes = D * N * (4 * 3 + 2) + D * N * A * 4 + D * N + 2 * D * S * 4
    f_bound = f_bytes / _HBM_BYTES_PER_S * 1e3
    print(f'flatmap_resolve kernel ({card}): device doc set map batch '
          f'shape D={D} N={N} A={A} S={S}, {fm_ran} variant: {_fmt_t(f_t)} '
          f'per launch on the device (a CUDA graph of 50 launches), the '
          f'block variant {_fmt_t(f_block)}; dispatch_resolve called '
          f'eagerly {_fmt_t(f_eager)}; plain PyTorch (the torch segment '
          f'resolve, kernel=\'xla\') {_fmt_t(f_plain)}, bound '
          f'{f_bound:.5f} ms ({f_bytes} bytes at 3.35 TB/s), max |kernel - '
          f'plain| {fm_err}', flush=True)
    kernels.append({
        'name': 'flatmap_resolve', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/flatmap_resolve.cu',
        'replaces': 'automerge_tpu/device/pallas_merge.py:136',
        'launches': dds_counts['flatmap_resolve'],
        'max_abs_err': fm_err, 'ms': f_t[0], 'plain_ms': f_plain[0],
        'bound_ms': f_bound, 'bound_by': 'bytes', 'library_ms': None,
        'variant': fm_ran})

    print(json.dumps({'kernels': kernels}), flush=True)
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
