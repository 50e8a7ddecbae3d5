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
   planes (both input formats, its warp, block and grid variants, (K,
   m, e_pad) shapes from m = 8 to 32,767 on both sides of
   ``M_WARP_ES``, e_pad = 1, e_pad = m and the e_pad drop path); the
   RGA order on seeded random, prepend, chain and wide-key trees at (K,
   m) up to (12288, 64), both sides of ``M_NARROW``, (64, 4096), single
   rows of 513, 3,071, 12,800, 49,152 and 196,608 nodes and 2 and 5
   rows of 40,000 — through the dispatch (the narrow kernel; past it
   the wide kernel, its sort inside, one block per row, or the sort and
   then the grid variant for a few long rows) and each variant directly
   (the wide kernel in shared and in global memory, the narrow kernel
   up to m = 512 and the grid one above, after a PyTorch sort); the RGA kernel's delta mode on seeded delta forests
   (anchors up to 2^22 - 1, elems past 2^15) at every width up to 33
   and at 129, 513, 1,025 and 8,600 (the last three through the wide
   kernel with the anchor plane), its narrow, subwarp and wide variants
   forced; the edit
   stream's wide format at a long text's width (m
   past 32,768) and at m <= 512, each forced onto every variant, and
   its grid variant at 1 and 3 rows of m in {513, 32,768, 65,536,
   300,000}, packed and wide, e_pad 1, 8 and m; the C side's
   shared-memory fits against the Python dispatch's; the flat-map
   resolve's dispatch and its variants (warp, block and split, forced)
   on
   ``gen_docset_workload(cross_clock=True)`` batches up to the flagship
   10,240 docs x 128 ops x 8 actors and 10,241 docs, a 6,000-segment
   shape on the block variant's global memory, and replica sync's one
   long document (65,536 ops, 16 actors, 4,096 segments);
4. the general engine's tick: a 10,240-document collab-server fleet
   (about 99 ops per document, about 1.01M ops in one fused apply)
   through ``GeneralDocSet(device='cuda').apply_changes_batch`` twice
   (tick 2 adds removes, inserts, sets and a conflict on every
   document) and ``materialize_all``; the same two ticks on the CPU (a
   seeded subset of documents in a fleet of their own) must give equal
   views, and the edit-stream and RGA kernels' launch counters must rise
   on every tick; tick 2 (a concurrent front insert) must take the
   incremental index update through the RGA kernel's delta mode, its
   subwarp variant (m = 9);
   4b. a long text (the JAX package's ``bench.py:971`` lane at 32,760
   chars, then 48 ticks of 8 appended chars with a delete every 5th)
   through ``GeneralDocSet(device='cuda')`` in two arms — incremental
   index + suffix window, and ``_INDEX_MODE='rebuild'`` +
   ``_WINDOW_MODE='off'`` — each apply's diffs and text checked against
   a ``device='cpu'`` run and the host-built string; the store must
   cross packed -> wide once, every tick after the 8th must be
   incremental and windowed, and the wide edit stream and the delta
   mode must launch; the p50 and p90 tick time of each arm;
   4c. the async apply: two long-text blocks through
   ``apply_general_block_async`` + ``drain_general`` give the sync
   apply's patches;
   4d. config 5 over the wire: two 10,240-document ``GeneralDocSet``
   fleets, each behind a ``ResilientConnection(wire=True,
   wire_version=3)``, joined by in-process queues; tick 1 applied on
   peer A reaches peer B through ``apply_wire`` as one fused apply, tick
   2 applied on B reaches A the same way as an incremental update (the
   native v3 codec forced, the RGA and edit-stream kernels launched on
   each receiving tick); equal digests and views on both peers and
   against the CPU fleet of phase 4; then 1,024 documents compacted,
   extracted, dropped and brought back through ``apply_states``, and a
   crash of A recovered through ``DurableDocSet.recover``, views and
   digests unchanged; bytes and messages on the wire and the
   ``apply_wire`` time by span;
   4e. config 4: the 180,000-keystroke automerge-perf trace through
   ``replay_text_block`` (one grid RGA launch at m = 196,608),
   equal to a CPU replay; 16 facade changes typing and deleting at a
   cursor on the replayed document, each equal to the CPU document's;
   ``save_snapshot``/``load_snapshot``; the 60,001-change bulk route
   (``DeviceBackend.apply_changes``, the general engine's wide mirror),
   its patch equal to the CPU run's; the kernels' share of the replay's
   and the bulk line's wall time from ``torch.profiler``, and the RGA
   launch's grid, block and occupancy as its trace records them;
   4f. the facade on map-only documents from ``init`` (the card by
   default): 8 actors x 16 set/del ops over 32 keys, merged both ways,
   equal to the host oracle, through the flat-map kernel;
   4g. BASELINE configs 1-3 (the JAX package's ``bench.py:269``,
   ``:295``, ``:362`` and ``:429``) through the public entry points,
   every document on the card by default: (1) the README's card list,
   20 three-way ``merge``s (p50, p90), its ``save`` byte-equal to the
   same run on the CPU (counter uuids) and the merge equal to the host
   oracle's; (2) three writers' 10,000 chars into one ``Text``
   (changes built on the host oracle) through
   ``DeviceBackend.apply_changes`` by its bulk auto-route (median of 3)
   and by the per-doc route (once), and through ``apply_general_block``
   (median of 3), each route's diffs equal to the CPU run's and its text
   to the host oracle's, the RGA kernel and the edit stream launched;
   (3) DocSet + Connection: 100 card documents to an empty ``DocSet``
   (3 eager rounds, the message log equal to the CPU run's), 2,000 flat
   documents over ``BatchingConnection`` into a ``DenseDocSet`` and
   2,000 rich ones into a ``GeneralDocSet`` (its tick's diffs read),
   each equal to the source and to a CPU doc set fed the same way, and
   the eager round at 2,000; the source documents' build time;
   4h. the JAX package's own behavioural suites on the card: the
   ``cuda`` lane of ``tests/test_torch_conformance_{reference,device,
   wire}.py`` through ``pytest.main`` in this process — the reference's
   conformance suite (undo/redo, Text, conflicts, history, diff,
   save/load, proxies, DocSet/Connection, WatchableDoc), the per-doc
   device backend, snapshots, compaction, interop, the wire codecs and
   the general engine, 635 cases re-collected against the port and run
   at its default device with nothing patched; every case must pass,
   the count per JAX module must be :data:`CONFORMANCE_CASES`, and
   neither JAX nor the JAX package may be loaded; the cases passed per
   module, the phase's seconds and its launches per key;
   4i. a mixed tick, many small structured documents beside a few
   page-length texts (a collab server's tick of lists and notes): a
   2,048-document ``GeneralDocSet`` on the card, 1,920 of config 5's
   mixed lists (22 list ops) and 128 texts of 2,000-6,000 characters by
   three writers; tick 1 rebuilds every dirty object in one job table
   padded to m = 6,144, so the wide RGA kernel orders every row; tick 2
   pastes a paragraph of 600-1,000 characters into each text (the delta
   orderer past ``M_NARROW``: the wide kernel's delta mode); no PyTorch
   child sort may run on the card; views, digests and both ticks'
   diffs equal to a CPU fleet's (the texts and a seeded 256 lists); the
   ticks by span, and device busy under ``torch.profiler`` over tick 1;
5. the per-doc device backend: ``DeviceDocSet(device='cuda')
   .apply_changes_batch`` on a 10,240-document map-only fleet (8
   concurrent actors x 16 set/del ops over 32 keys per document,
   1,310,720 ops: the flat-map kernel) and a 10,240-document list fleet
   (the tick-1 documents above: the fused step and its RGA kernel); the
   documents must equal ``DeviceDocSet(device='cpu')`` on a seeded
   768-document subset and the host oracle ``DocSet`` on 64;
   5b. the dense flat-map engine: ``gen_block_workload()`` (10,240
   documents x 10 actors x 10 ops, 1,024,000 ops) into
   ``DenseMapStore(device='cuda')``, p50 and p99 of 50 blocking applies
   (``reset()`` before each), one more under ``torch.profiler`` (the
   device's share), the planes and patch tensors bit-equal to a
   ``device='cpu'`` store after the same block and the diffs on a
   seeded subset; 8 successive blocks through ``apply_block_async`` +
   ``drain`` (synced once) against the same stream applied
   synchronously; a ``DenseDocSet`` of 1,024 documents synced over
   ``BatchingConnection`` from a host-oracle ``DocSet``, its views
   equal to the oracle's;
   5c. serving, control, transport and the fleet simulator, every
   node's store on the card: ``zipf`` at full scale (3 nodes, 1,024
   documents, 10,240 load ops, wire and controller on) green, and the
   flash crowd at full scale green with the controller and red without,
   each with every node's views equal to ``run_oracle(schedule,
   device='cpu')`` and equal state digests across nodes, ops/s and the
   convergence p99; the flash crowd once more under ``torch.profiler``;
   ``replay_schedule_over_sockets`` of the reconnect storm (smoke
   scale) over loopback sockets through the fault-injecting proxies,
   equal to the oracle with nothing quarantined or diverged; the RGA
   kernel must launch;
   5d. the mesh layer over a 4-entry mesh, entry i on ``cuda:(i %
   device_count)`` (``make_mesh()``'s card count printed): (a) the
   collectives against numpy; (b) config 5 sharded —
   ``ShardedGeneralDocSet(10240, n_shards=4)`` takes phase 4's two
   ticks, each shard's patch diffs for the seeded 768 documents equal
   phase 4's, ``materialize_all`` and every per-doc digest equal the
   unsharded fleet's, then 1,024 documents migrate (digest-verified)
   and the views stay; each tick's apply time beside phase 4's; (c)
   ``sharded_step_from_capture`` of a captured tick 1 bit-equal to the
   fused outputs (the JAX package's multichip gate); (d)
   ``ShardedDocSetEngine`` on phase 5's map-only fleet (the flat-map
   kernel at D = 2,560 a shard) equal to ``batch_merge_docs``, its
   kernel outputs and stats equal to a CPU mesh's; (e) replica sync on
   a 4-peer mesh, 16,384 ops a peer over 16 actors and 4,096 keys: the
   all-gather and ring rounds equal a CPU run, delta sync (all-gather
   and ring, windows 64 and 1,024) ending in a round that ships 0 with
   every peer resolving like the union; (f) ``hot_shard`` at full scale
   green with its controller and red without, views equal to the CPU
   oracle; (g) the 1M-op dense block into ``DenseMapStore(mesh=)``,
   planes and patch tensors bit-equal to an unsharded card store, the
   p50 of 10 applies beside 5b's; (h) the JAX package's scaling lane
   (``bench.py:1400``): 4,096 documents, 128 single-doc mid-list
   inserts at 1 and 4 shards, request p50 and p99;
6. one more general tick under ``torch.profiler`` (it re-inserts
   elems the fleet already has, so it must fall back to the rebuild):
   device busy time against the tick's wall time (the idle share) and
   the kernels that take it;
7. the widths (m) of every delta-orderer call the main paths made on the
   card; for every launch key (kernel, mode, variant) the main paths
   launched (phases 4 to 5d, 4h included): every input the paths handed that launch,
   as they handed it over, through the dispatch (which must take exactly
   that launch) against the plain version, bit for bit; then, at the
   largest of those inputs, the kernel and the plain version of what it
   computes, each timed from a CUDA graph (median, min and max of 5
   replays) and eagerly, the dispatch called eagerly, and the parent
   variant beside a redesigned one from a graph (a wide row's grid or
   one block per row, the delta mode's narrow variant beside its subwarp
   one, the flat-map block variant beside the split one), beside the
   byte bound and the card's name and power limit; the JSON kernel line
   (one row per launch key); then the result line.

Every launch counter is set to 0 just before a path is driven and read
just after it. The workload generators (``gen_mixed_docs``,
``gen_tick2``, ``random_planes``, ``random_trees``, ``prepend_trees``,
``chain_trees``, ``wide_key_trees``, ``delta_forests``, ``wide_planes``,
``long_text_applies``) are shared with the tests.
"""

import collections
import contextlib
import ctypes
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT_ID = '00000000-0000-0000-0000-000000000000'

# H100 SXM peak memory rate (NVIDIA data sheet), bytes/s
_HBM_BYTES_PER_S = 3.35e12

# phase 4h: the test files that re-collect the JAX package's own suites
# against the port (their harness: tests/test_torch_conformance_harness.py)
# and their cuda-lane cases by JAX test module (the reference's `slow`
# cases included). The modules of tests/test_torch_conformance_{index,
# host,metrics,mesh}.py import or run jax (test_stage_cache through
# test_sequence_index), so they run on the CPU only.
CONFORMANCE_FILES = ('tests/test_torch_conformance_reference.py',
                     'tests/test_torch_conformance_device.py',
                     'tests/test_torch_conformance_wire.py',
                     'tests/test_torch_conformance_serving.py',
                     'tests/test_torch_conformance_fleet.py',
                     'tests/test_torch_conformance_sync.py',
                     'tests/test_torch_conformance_engine.py')
CONFORMANCE_CASES = {
    'test_integration': 59, 'test_integration_ext': 41, 'test_proxies': 40,
    'test_text': 6, 'test_connection': 18, 'test_frontend': 13,
    'test_frontend_concurrency': 27, 'test_backend': 19,
    'test_watchable_uuid': 8, 'test_device_undo': 13,
    'test_device_sequences': 31, 'test_device_backend': 19,
    'test_backend_worker': 6, 'test_snapshot': 31, 'test_compaction': 23,
    'test_interop': 12, 'test_text_block': 33, 'test_cross_engine': 47,
    'test_wire': 29, 'test_wire_v2': 77, 'test_wire_sync': 42,
    'test_general_backend': 22, 'test_general_materialize': 19,
    'test_serving': 40, 'test_control': 15, 'test_telemetry': 18,
    'test_tracing': 22, 'test_fleetsim': 15, 'test_general_sync': 8,
    'test_batched_sync': 6, 'test_wire_v3': 53, 'test_transport': 37,
    'test_chaos': 42, 'test_socket_chaos': 4, 'test_general': 25,
    'test_blocks': 31, 'test_integration_device': 100, 'test_native': 20,
    'test_traces': 10}


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


def gen_text_docs(n_docs, doc0=0, seed=14, chars=(2000, 6000),
                  del_share=0.07):
    """Page-length texts, three writers each (the pattern of
    :func:`text_writer_changes`, built as raw changes on the host): per
    document a count of inserted characters drawn uniformly from
    ``chars``; writer ``t0-<d>`` makes the ``Text`` and types half of them
    as one paragraph (a jump to an earlier character now and then), then
    ``t1-<d>`` and ``t2-<d>``, concurrent with each other and both after
    ``t0``, type the rest in runs of 20-80 at the same few anchors (so
    that sibling groups of two occur there) and delete ``del_share`` of
    the characters between them. Returns (per-document changes, per
    document (actors, the elem ids still visible, the highest elem, the
    expected text length))."""
    per_doc, meta = [], []
    for d in range(doc0, doc0 + n_docs):
        rng = np.random.default_rng([seed, d])
        obj = f'00000000-0000-4000-9000-{d:012x}'
        a = [f't{w}-{d}' for w in range(3)]
        total = int(rng.integers(chars[0], chars[1] + 1))
        n0 = total // 2
        n1 = (total - n0) // 2
        letters = rng.integers(97, 123, total)
        ops0 = [{'action': 'makeText', 'obj': obj},
                {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
                 'value': obj}]
        prev, ids0 = '_head', []
        for i in range(1, n0 + 1):
            if ids0 and rng.random() < 0.02:
                prev = ids0[int(rng.integers(len(ids0)))]
            ops0.append({'action': 'ins', 'obj': obj, 'key': prev,
                         'elem': i})
            prev = f'{a[0]}:{i}'
            ops0.append({'action': 'set', 'obj': obj, 'key': prev,
                         'value': chr(letters[i - 1])})
            ids0.append(prev)
        anchors = [ids0[int(j)] for j in rng.integers(0, n0, 6)]
        dead = rng.choice(n0, int(del_share * total), replace=False)
        changes = [{'actor': a[0], 'seq': 1, 'deps': {}, 'ops': ops0}]
        ids_w = []
        top = n0
        for w, count in ((1, n1), (2, total - n0 - n1)):
            ops, e, k = [], n0, 0
            while k < count:
                run = min(int(rng.integers(20, 81)), count - k)
                prev = anchors[int(rng.integers(len(anchors)))]
                for _ in range(run):
                    e += 1
                    ops.append({'action': 'ins', 'obj': obj, 'key': prev,
                                'elem': e})
                    prev = f'{a[w]}:{e}'
                    ops.append({'action': 'set', 'obj': obj, 'key': prev,
                                'value': chr(letters[n0 + k])})
                    ids_w.append(prev)
                    k += 1
            for j in dead[w - 1::2]:
                ops.append({'action': 'del', 'obj': obj, 'key': ids0[j]})
            changes.append({'actor': a[w], 'seq': 1, 'deps': {a[0]: 1},
                            'ops': ops})
            top = max(top, e)
        gone = set(int(j) for j in dead)
        alive = [x for j, x in enumerate(ids0) if j not in gone] + ids_w
        per_doc.append(changes)
        meta.append((a, alive, top, total - len(gone)))
    return per_doc, meta


def gen_paste_tick(meta, doc0=0, seed=15, chars=(600, 1000)):
    """One more tick of :func:`gen_text_docs`' documents: a fourth actor
    ``t3-<d>``, after the three writers, pastes a paragraph of a length
    drawn uniformly from ``chars`` after a seeded visible character, its
    elems above every elem so far. Returns (per-document changes, the
    expected text lengths)."""
    per_doc, lengths = [], []
    for j, (a, alive, top, n) in enumerate(meta):
        d = doc0 + j
        rng = np.random.default_rng([seed, d])
        obj = f'00000000-0000-4000-9000-{d:012x}'
        actor = f't3-{d}'
        size = int(rng.integers(chars[0], chars[1] + 1))
        prev = alive[int(rng.integers(len(alive)))]
        ops = []
        for e in range(top + 1, top + size + 1):
            ops.append({'action': 'ins', 'obj': obj, 'key': prev,
                        'elem': e})
            prev = f'{actor}:{e}'
            ops.append({'action': 'set', 'obj': obj, 'key': prev,
                        'value': chr(97 + e % 26)})
        per_doc.append([{'actor': actor, 'seq': 1,
                         'deps': {x: 1 for x in a}, 'ops': ops}])
        lengths.append(n + size)
    return per_doc, lengths


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


def delta_forests(rng, K, m):
    """Seeded [K, m] delta planes of the incremental index update
    (int32 parent/anchor/elem/actor, bool valid): slot 0 is the virtual
    head; row k holds d_k delta nodes, each either a delta root (parent
    0, an anchor up to 2^22 - 1, ties between roots included) or a child
    of an earlier delta node (anchor 0), with Lamport counters past 2^15
    (ties included) and actor ranks; the rest of the row is padding with
    garbage parents and anchors. The first row is full and, when K > 2,
    the last holds the head alone."""
    parent = rng.integers(-3, m + 3, (K, m)).astype(np.int32)
    anchor = rng.integers(0, 1 << 22, (K, m)).astype(np.int32)
    elem = rng.integers(1 << 15, 1 << 20, (K, m)).astype(np.int32)
    actor = rng.integers(0, 5, (K, m)).astype(np.int32)
    valid = np.zeros((K, m), bool)
    d = rng.integers(0, m, K)
    d[0] = m - 1
    if K > 2:
        d[-1] = 0
    parent[:, 0] = anchor[:, 0] = elem[:, 0] = actor[:, 0] = 0
    anchor[:, 1:2] = (1 << 22) - 1
    for k in range(K):
        dk = int(d[k])
        valid[k, :dk + 1] = True
        if dk < 1:
            continue
        j = np.arange(1, dk + 1)
        root = (rng.random(dk) < 0.4) | (j == 1)
        parent[k, 1:dk + 1] = np.where(
            root, 0, (rng.random(dk) * (j - 1)).astype(np.int32) + 1)
        same = rng.random(dk) < 0.3          # tie with the previous anchor
        anchor[k, 2:dk + 1] = np.where(same[1:], anchor[k, 1:dk],
                                       anchor[k, 2:dk + 1])
        anchor[k, 1:dk + 1] = np.where(root, anchor[k, 1:dk + 1], 0)
        tie = rng.random(dk) < 0.3
        elem[k, 2:dk + 1] = np.where(tie[1:], elem[k, 1:dk],
                                     elem[k, 2:dk + 1])
    return parent, anchor, elem, actor, valid


def wide_planes(pv, nv, pi, ni):
    """The wide apply's two vis word planes (``visible << 22 | (idx +
    1)``: prior, new) from :func:`random_planes`' unpacked planes."""
    prior = (pv.astype(np.int32) << 22) | (pi + 1)
    new = (nv.astype(np.int32) << 22) | (ni + 1)
    return prior.astype(np.int32), new.astype(np.int32)



def _require_launch(added, kernel, what):
    """Fail unless ``added`` (launch counts of one run, by key) holds a
    launch of ``kernel``: a kernel's name, or the leading part of a
    launch key (kernel, mode, variant)."""
    lead = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    if not any(key[:len(lead)] == lead for key in added):
        raise AssertionError(f'{what} did not launch the '
                             f'{":".join(lead)} kernel (launches: {added})')


def _env_bytes(env):
    """Bytes one envelope puts on the wire: its bytes fields (the blob
    and the literal table of a wire data message) as they are, every
    other field as JSON."""
    def split(obj, raw):
        if isinstance(obj, (bytes, bytearray)):
            raw.append(len(obj))
            return None
        if isinstance(obj, dict):
            return {k: split(v, raw) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [split(v, raw) for v in obj]
        return obj
    raw = []
    rest = split(env, raw)
    return sum(raw) + len(json.dumps(rest, separators=(',', ':')))


@contextlib.contextmanager
def _native_codec_calls(into):
    """Count the wire v3 codec's native calls in ``into`` ('emit',
    'parse') while the pure-Python arms are switched off
    (``_NATIVE_COLUMNAR = True``: a missing native codec raises)."""
    from automerge_tpu_torch import native as amnative
    from automerge_tpu_torch import wire as amwire
    real = (amnative.emit_columnar_rows_v3, amwire.parse_columnar_block,
            amwire._NATIVE_COLUMNAR)

    def emit(*a, **kw):
        into['emit'] = into.get('emit', 0) + 1
        return real[0](*a, **kw)

    def parse(*a, **kw):
        into['parse'] = into.get('parse', 0) + 1
        return real[1](*a, **kw)

    amnative.emit_columnar_rows_v3 = emit
    amwire.parse_columnar_block = parse
    amwire._NATIVE_COLUMNAR = True
    try:
        yield into
    finally:
        (amnative.emit_columnar_rows_v3, amwire.parse_columnar_block,
         amwire._NATIVE_COLUMNAR) = real


# the receive tick's spans: the parse, then the fused apply's admit ->
# stage -> dispatch
_WIRE_SPANS = ('wire.parse', 'device.admit', 'device.stage',
               'device.dispatch')


def _wire_fleet_path(card, ticks, ids, cpu_ds, sub, inputs, workdir):
    """Phase 4d: config 5 over the wire. Two ``GeneralDocSet`` fleets on
    the card, each behind a ``ResilientConnection(wire=True,
    wire_version=3)``, joined by in-process queues. Peer A (durable:
    checkpointed after tick 1, every later write journaled) applies
    tick 1 locally; flushing and delivering until quiet ships it to B,
    which takes it through ``apply_wire`` as one fused apply and reads
    its patch. B applies tick 2 locally and ships it back: A takes it
    through ``apply_wire`` as an incremental update. Both fleets must end
    with equal per-document digests and views, equal on ``sub`` to
    ``cpu_ds`` (the CPU fleet of phase 4, same ticks). Then 1,024
    seeded documents of A are compacted, extracted, dropped and brought
    back with ``apply_states``, and A crashes and recovers through
    ``DurableDocSet.recover``: views and digests unchanged each time.
    Every kernel launch of the phase counts (its counters are set to 0
    at its start and read at its end) and has its inputs captured.
    Returns the launch counts, by key."""
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view

    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        _wire_fleet_run(card, ticks, ids, cpu_ds, sub, workdir)
    return _launch_counts()


def _wire_fleet_run(card, ticks, ids, cpu_ds, sub, workdir):
    import base64
    import torch
    from automerge_tpu_torch import compaction
    from automerge_tpu_torch.durability import DurableDocSet
    from automerge_tpu_torch.sync import GeneralDocSet, ResilientConnection
    from automerge_tpu_torch.utils.metrics import metrics

    n_docs = len(ids)
    a_dir = os.path.join(workdir, 'peer_a')
    peer_a = GeneralDocSet(n_docs, device='cuda')
    peer_b = GeneralDocSet(n_docs, device='cuda')
    t0 = time.perf_counter()
    peer_a.apply_changes_batch({ids[d]: ticks[0][d] for d in range(n_docs)})
    torch.cuda.synchronize()
    t_local = (time.perf_counter() - t0) * 1e3
    peer_a = DurableDocSet(peer_a, a_dir, fsync=False)
    peer_a.checkpoint()
    to_a, to_b = [], []
    conn_a = ResilientConnection(peer_a, to_b.append, wire=True,
                                 wire_version=3, peer_id='b')
    conn_b = ResilientConnection(peer_b, to_a.append, wire=True,
                                 wire_version=3, peer_id='a')

    def pump():
        """Flush and deliver until quiet: (messages, bytes)."""
        n_msgs = n_bytes = 0
        for _ in range(64):
            conn_a.flush()
            conn_b.flush()
            if not (to_a or to_b):
                return n_msgs, n_bytes
            for queue, conn in ((to_b, conn_b), (to_a, conn_a)):
                batch = queue[:]
                queue.clear()
                for env in batch:
                    n_msgs += 1
                    n_bytes += _env_bytes(env)
                    conn.receive_msg(env)
        raise AssertionError('the wire pair did not go quiet')

    def receive(tick, receiver, sender_name, prime):
        """Drive one tick to ``receiver`` over the wire: returns its
        apply_wire calls (docs, ms each), the spans, the patch read ms,
        messages and bytes, the launches and the native codec calls."""
        calls, spans, native = [], [], {}
        real = receiver.apply_wire

        def apply_wire(data, doc_ids=None):
            t = time.perf_counter()
            out = real(data, doc_ids=doc_ids)
            torch.cuda.synchronize()
            calls.append((len(doc_ids or ()), (time.perf_counter() - t)
                          * 1e3))
            return out

        def on_event(ev):
            if ev.get('event') == 'span':
                spans.append((ev['name'], ev['dur_ms']))

        prime()
        receiver.apply_wire = apply_wire
        before = _launch_counts()
        incr0 = metrics.counters.get('device_idx_incremental_applies', 0)
        metrics.subscribe(on_event)
        try:
            with _native_codec_calls(native):
                n_msgs, n_bytes = pump()
                inner = getattr(receiver, 'doc_set', receiver)
                t = time.perf_counter()
                patch = inner.last_patch
                for d in sub:
                    patch.diffs(inner.id_of[ids[d]])
                torch.cuda.synchronize()
                t_read = (time.perf_counter() - t) * 1e3
        finally:
            metrics.unsubscribe(on_event)
            del receiver.apply_wire
        added = _added(_launch_counts(), before)
        incr = metrics.counters.get('device_idx_incremental_applies',
                                    0) - incr0
        what = f'the wire tick {tick} (from {sender_name})'
        if incr != (tick == 2):
            raise AssertionError(f'{what}: {incr} incremental index '
                                 f'updates (tick 2 must take one, tick 1 '
                                 f'none)')
        if len(calls) != 1 or calls[0][0] != n_docs:
            raise AssertionError(f'{what}: apply_wire calls {calls}, not '
                                 f'one fused apply of {n_docs} docs')
        if not native.get('parse') or not native.get('emit'):
            raise AssertionError(f'{what}: native codec calls {native}')
        _require_launch(added, 'rga_order', what)
        _require_launch(added, 'edit_stream', what)
        n_ops = sum(len(c['ops']) for doc in ticks[tick - 1] for c in doc)
        sp = {n: _span_sum(spans, n) for n in _WIRE_SPANS}
        print(f'wire tick {tick} ({sender_name} -> peer, {card}): '
              f'{n_msgs} messages, {n_bytes} bytes on the wire; apply_wire '
              f'{calls[0][1]:.1f} ms (' + ', '.join(
                  f'{n} {v:.1f}' for n, v in sp.items())
              + f', rest {calls[0][1] - sum(sp.values()):.1f}); patch read '
              f'of {len(sub)} docs {t_read:.1f} ms; {n_ops} ops, '
              f'{n_ops / calls[0][1] * 1e3:.0f} ops merged/s by apply_wire;'
              f' native codec calls {native}; launches {added}',
              flush=True)

    conn_a.open()
    conn_b.open()
    receive(1, peer_b, 'peer A', lambda: None)

    def tick2():
        t = time.perf_counter()
        peer_b.apply_changes_batch({ids[d]: ticks[1][d]
                                    for d in range(n_docs)})
        torch.cuda.synchronize()
        print(f'wire tick 2: peer B applied it locally in '
              f'{(time.perf_counter() - t) * 1e3:.1f} ms', flush=True)
    receive(2, peer_a, 'peer B', tick2)

    def state(ds):
        return [ds.digest_of_id(i) for i in ids], ds.materialize_all()
    t0 = time.perf_counter()
    digests, views = state(peer_a)
    if state(peer_b) != (digests, views):
        raise AssertionError('the wire peers did not converge')
    for d in sub:
        if views[ids[d]] != cpu_ds.materialize(ids[d]) or \
                digests[d] != cpu_ds.digest_of_id(ids[d]):
            raise AssertionError(f'{ids[d]}: wire peer != cpu fleet')
    print(f'check: both wire peers have equal digests and views for all '
          f'{n_docs} docs, equal to the cpu fleet on {len(sub)} '
          f'({(time.perf_counter() - t0):.1f} s); peer A\'s local tick 1 '
          f'took {t_local:.1f} ms', flush=True)

    # evict: compact, extract, drop, bring back through apply_states
    evict = [ids[d] for d in np.sort(np.random.default_rng(3).choice(
        n_docs, 1024, replace=False))]
    t0 = time.perf_counter()
    compaction.compact_docset(peer_a, doc_ids=evict)
    recs = peer_a.extract_doc_state(evict)
    if any('state' not in recs[d] for d in evict):
        raise AssertionError('a compacted doc was extracted without state')
    peer_a.drop_doc_state(evict)
    if peer_a.store.clock_of(peer_a.id_of[evict[0]]):
        raise AssertionError('drop_doc_state kept an evicted doc')
    t_evict = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    peer_a.apply_states({d: base64.b64decode(recs[d]['state'])
                         for d in evict})
    torch.cuda.synchronize()
    t_back = (time.perf_counter() - t0) * 1e3
    if state(peer_a) != (digests, views):
        raise AssertionError('evicted docs came back changed')
    # crash and recover from the checkpoint + journal
    peer_a.close()
    t0 = time.perf_counter()
    back = DurableDocSet.recover(
        a_dir, lambda: GeneralDocSet(n_docs, device='cuda'), fsync=False,
        load_snapshot=lambda b: GeneralDocSet.load_snapshot(b,
                                                            device='cuda'))
    torch.cuda.synchronize()
    t_recover = (time.perf_counter() - t0) * 1e3
    if state(back) != (digests, views):
        raise AssertionError('the recovered peer differs')
    back.close()
    print(f'evict ({card}): {len(evict)} docs compacted, extracted and '
          f'dropped in {t_evict:.1f} ms, back through apply_states in '
          f'{t_back:.1f} ms; crash + DurableDocSet.recover (checkpoint + '
          f'journal: the wire tick and the state bootstrap) '
          f'{t_recover:.1f} ms; views and digests unchanged after each',
          flush=True)


def _kernel_share(prof, what, names):
    """(device busy ms, ms of the kernels whose name holds one of
    ``names``) of a ``torch.profiler`` capture."""
    busy, rows = _device_rows(prof, what)
    return busy, sum(ms for key, ms, _ in rows
                     if any(n in key for n in names))


# the hand kernels' function names, as the profiler lists them
_RGA_KERNELS = ('rga_order_kernel', 'rga_narrow_kernel', 'rga_grid_kernel',
                'rga_wide_kernel', 'rga_subwarp_delta_kernel')
_ES_KERNELS = ('es_warp_kernel', 'es_block_kernel', 'es_grid_kernel')


# the launch fields of a kernel event in torch.profiler's exported trace
_LAUNCH_FIELDS = ('grid', 'block', 'blocks per SM', 'warps per SM',
                  'est. achieved occupancy %', 'registers per thread',
                  'shared memory')


def _launch_geometry(prof, names):
    """The launch fields (grid, block, and CUPTI's blocks per SM and
    estimated achieved occupancy, where the trace holds them) of each
    launch of the kernels whose name holds one of ``names``, read from
    ``prof``'s exported trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return [{k: e['args'][k] for k in _LAUNCH_FIELDS if k in e['args']}
            for e in events if e.get('cat') == 'kernel'
            and any(n in e.get('name', '') for n in names)]


def _profiled(fn):
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _text_edit(pos, k):
    """Facade edit ``k`` at cursor ``pos`` of a replayed text: type three
    chars, or delete the two before the cursor (every third edit).
    Returns (the change callback, the cursor after it)."""
    if k % 3 == 2 and pos >= 2:
        def cb(d):
            d['text'].delete_at(pos - 2)
            d['text'].delete_at(pos - 2)
        return cb, pos - 2
    s = 'xyz' if k % 2 else 'ab\n'

    def cb(d):
        d['text'].insert_at(pos, *s)
    return cb, pos + len(s)


def _text_trace_path(card, inputs):
    """Phase 4e: config 4, the automerge-perf trace (BASELINE.md config
    4; the JAX package's ``bench.py:2446 bench_trace_replay``): the
    180,000-keystroke trace of ``traces.gen_editing_trace`` through
    ``TextBlock.from_changes`` and ``replay_text_block`` on the card (one
    RGA call over the whole insertion tree), checked against a CPU
    replay; ``to_doc`` and 16 facade changes typing and deleting at a
    cursor, each equal to the same edits on the CPU document;
    ``save_snapshot`` / ``load_snapshot``; and the bulk wire-to-patch
    line: ``DeviceBackend.apply_changes`` of the first 60,001 changes
    into a fresh document (the general engine, wide
    mirror), its patch equal to the CPU run's. The counters are set to 0
    at the start and read before the profiled reruns that give the
    kernels' share of the wall times. Returns the launch counts, by
    key."""
    import torch
    import automerge_tpu_torch as am
    from automerge_tpu_torch import traces
    from automerge_tpu_torch.device import backend as DB
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    from automerge_tpu_torch.device.text_block import (TextBlock,
                                                       replay_text_block)

    n_edits, n_bulk = 16, 60001
    t0 = time.perf_counter()
    trace = traces.gen_editing_trace(180000, seed=0)
    block = TextBlock.from_changes(trace)
    t_gen = time.perf_counter() - t0

    def bulk(device):
        return DB.apply_changes(DB.init(device=device), trace[:n_bulk])

    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        t0 = time.perf_counter()
        rep = replay_text_block(block, device='cuda')
        torch.cuda.synchronize()
        t_replay = (time.perf_counter() - t0) * 1e3
        added = _launch_counts()
        m = int(rep.order['vis_index'].shape[0])
        if added != {('rga_order', 'order', 'wide-grid'): 1}:
            raise AssertionError(f'config 4 replay launched {added}, not '
                                 f'one grid RGA kernel')
        t0 = time.perf_counter()
        ref = replay_text_block(block, device='cpu')
        t_cpu = (time.perf_counter() - t0) * 1e3
        text = rep.text()
        if text != ref.text() or rep.elem_ids() != ref.elem_ids():
            raise AssertionError('config 4: cuda replay != cpu replay')
        print(f'config 4 ({card}): {len(trace)} changes, {rep.n_nodes} '
              f'nodes padded to m = {m}, {len(text)} chars (trace made and '
              f'blocked in {t_gen:.1f} s); replay_text_block '
              f'{t_replay:.1f} ms on the card (the cpu replay {t_cpu:.1f} '
              f'ms);'
              f' launches {added}; text and elem_ids == cpu', flush=True)

        # the replayed document, edited through the facade at a cursor
        before_e = _launch_counts()
        doc = rep.to_doc(actor_id='author')
        cdoc = ref.to_doc(actor_id='author')
        pos = int(np.random.default_rng(4).integers(len(text) // 4,
                                                    3 * len(text) // 4))
        times = []
        for k in range(n_edits):
            cb, new_pos = _text_edit(pos, k)
            t0 = time.perf_counter()
            doc = am.change(doc, cb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            cdoc = am.change(cdoc, cb)
            got = ''.join(str(c) for c in doc['text'])
            if got != ''.join(str(c) for c in cdoc['text']):
                raise AssertionError(f'config 4 edit {k}: cuda text != cpu')
            pos = new_pos
        snap = am.save_snapshot(doc)
        t0 = time.perf_counter()
        back = am.load_snapshot(snap, actor_id='author')
        t_load = (time.perf_counter() - t0) * 1e3
        if ''.join(str(c) for c in back['text']) != got:
            raise AssertionError('config 4: load_snapshot changed the text')
        try:
            am.save(doc)
        except ValueError:
            pass
        else:
            raise AssertionError('save() of a replayed (truncated) '
                                 'document did not raise')
        rga_e = {k: n for k, n in _added(_launch_counts(), before_e).items()
                 if k[0] == 'rga_order'}
        if set(rga_e) != {('rga_order', 'order', 'wide-grid')}:
            raise AssertionError(f'config 4 edits launched {rga_e}, not '
                                 f'the grid RGA kernel alone')
        times.sort()
        print(f'config 4 edits ({card}): {n_edits} facade changes at a '
              f'cursor on the replayed document, each == the cpu document; '
              f'change p50 {times[len(times) // 2]:.1f} ms, max '
              f'{times[-1]:.1f} ms; save_snapshot {len(snap)} bytes, '
              f'load_snapshot on the card {t_load:.1f} ms, same text; save() '
              f'refuses the truncated log; launches {_launch_counts()}',
              flush=True)

        # the wire-to-patch line: the bulk route into the general engine
        before = _launch_counts()
        t0 = time.perf_counter()
        st, patch = bulk('cuda')
        torch.cuda.synchronize()
        t_bulk = (time.perf_counter() - t0) * 1e3
        added_b = _added(_launch_counts(), before)
    counts = _launch_counts()
    fmt = st.store.pool.mirror['fmt']
    t0 = time.perf_counter()
    _, cpatch = bulk('cpu')
    t_cbulk = (time.perf_counter() - t0) * 1e3
    if patch != cpatch:
        raise AssertionError('config 4 wire-to-patch: cuda patch != cpu')
    for key in (('rga_order', 'order', 'wide-grid'),
                ('edit_stream', 'wide', 'grid')):
        if not added_b.get(key):
            raise AssertionError(f'the wire-to-patch line did not launch '
                                 f'{key}: {added_b}')
    print(f'config 4 wire-to-patch ({card}): DeviceBackend.apply_changes of'
          f' {n_bulk} changes into a fresh document on the card (the general '
          f'engine, {fmt} mirror) {t_bulk:.1f} ms (the cpu run '
          f'{t_cbulk:.1f} ms), {len(patch["diffs"])} diffs, patch == cpu; '
          f'launches {added_b}', flush=True)
    prof = _profiled(lambda: replay_text_block(block, device='cuda'))
    busy, k_ms = _kernel_share(prof, 'the config-4 replay', _RGA_KERNELS)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f'profile (the config-4 replay again under torch.profiler, '
          f'{card}): device busy {busy:.3f} ms, the RGA kernel '
          f'{k_ms:.3f} ms = {k_ms / t_replay:.4f} of the unprofiled '
          f'replay\'s wall time; its launch as the trace records it '
          f'(the card has {n_sm} SMs): '
          f'{_launch_geometry(prof, _RGA_KERNELS)}', flush=True)
    prof = _profiled(lambda: bulk('cuda'))
    busy, k_rga = _kernel_share(prof, 'the wire-to-patch line', _RGA_KERNELS)
    _, k_es = _kernel_share(prof, 'the wire-to-patch line', _ES_KERNELS)
    print(f'profile (the wire-to-patch line again under torch.profiler, '
          f'{card}): device busy {busy:.3f} ms, the RGA kernel {k_rga:.3f} '
          f'ms and the edit stream {k_es:.3f} ms = '
          f'{(k_rga + k_es) / t_bulk:.4f} of the unprofiled wall time',
          flush=True)
    return counts


def _facade_map_path(card, inputs):
    """Phase 4f: the facade on map-only device documents. 8 documents
    from ``init`` (the card, its default) each make 16 seeded set/del
    ops over the same 32 root keys through ``change``; the first half
    merge into one document and the second half into another, which
    then merge both ways. They must converge, equal the host oracle
    (``Frontend.init({'backend': Backend})``) doing the same, and launch
    the flat-map kernel. Returns the launch counts, by key."""
    import torch
    import automerge_tpu_torch as am
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view

    n_actors, n_ops, n_keys = 8, 16, 32

    def run(make):
        rng = np.random.default_rng(21)
        docs = []
        for a in range(n_actors):
            doc = make(f'{a:02d}-actor')
            for _ in range(n_ops // 4):
                picks = [(f'k{int(rng.integers(0, n_keys))}',
                          int(rng.integers(0, 1000)), rng.random() < 0.1)
                         for _ in range(4)]

                def cb(d, picks=picks):
                    for key, v, delete in picks:
                        if delete and key in d:
                            del d[key]
                        else:
                            d[key] = v
                doc = am.change(doc, cb)
            docs.append(doc)
        half = n_actors // 2
        left, right = docs[0], docs[half]
        for d in docs[1:half]:
            left = am.merge(left, d)
        for d in docs[half + 1:]:
            right = am.merge(right, d)
        return am.merge(left, right), am.merge(right, left)

    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        t0 = time.perf_counter()
        ab, ba = run(am.init)
        torch.cuda.synchronize()
        t_run = (time.perf_counter() - t0) * 1e3
    added = _launch_counts()
    if am.Frontend.get_backend_state(ab).device.type != 'cuda':
        raise AssertionError('init() did not make a document on the card')
    oab, oba = run(lambda actor: am.Frontend.init(
        {'actorId': actor, 'backend': am.Backend}))
    if not (doc_view(ab) == doc_view(ba) == doc_view(oab) ==
            doc_view(oba)):
        raise AssertionError('the facade map documents did not converge '
                             'to the oracle')
    _require_launch(added, 'flatmap_resolve', 'the facade map path')
    print(f'facade ({card}): {n_actors} device documents x {n_ops} set/del '
          f'ops over {n_keys} keys, merged both ways through the facade in '
          f'{t_run:.1f} ms; converged, == the host oracle; launches '
          f'{added}', flush=True)
    return added


# ---- phase 4g: BASELINE configs 1-3 through the public entry points ------

def counter_uuids():
    """A uuid factory counting from 0: two runs of one script (two
    packages, or the card and the CPU) then name the same objects."""
    n = itertools.count()
    return lambda: f'00000000-0000-4000-8000-{next(n):012x}'


def card_list_docs(am, new):
    """BASELINE config 1 (the JAX package's ``bench.py:269``): the
    README's card list through facade ``am``, ``new(actor)`` making each
    empty document. Actor a makes the list and two cards, b merges them
    in, then a ticks the first card off while b deletes the other.
    Returns (a, b)."""
    a = am.change(new('aaaa-bench'), lambda d: d.__setitem__('cards', []))
    a = am.change(a, lambda d: d['cards'].append(
        {'title': 'Rewrite everything in JAX', 'done': False}))
    a = am.change(a, lambda d: d['cards'].insert(
        0, {'title': 'Rewrite everything in Pallas', 'done': False}))
    b = am.merge(new('bbbb-bench'), a)
    a = am.change(a, lambda d: d['cards'][1].__setitem__('done', True))
    b = am.change(b, lambda d: d['cards'].__delitem__(0))
    return a, b


def card_list_merge(am, new, a, b):
    """Config 1's timed step: a fresh third document merges a, then b."""
    return am.merge(am.merge(new('cccc-bench'), a), b)


def text_writer_changes(am, n_chars):
    """BASELINE config 2 (``bench.py:295``): the changes of three
    concurrent writers, each typing ``n_chars // 3`` copies of its
    letter at the front of one shared ``Text``, built on facade ``am``'s
    host oracle as the bench builds them: the base change, then one
    change a writer."""
    F, B = am.Frontend, am.Backend
    base_doc = F.set_actor_id(F.init({'backend': B}), 'base')
    base_doc, _ = F.change(base_doc,
                           lambda d: d.__setitem__('text', am.Text()))
    base = B.get_changes_for_actor(F.get_backend_state(base_doc), 'base')
    changes = list(base)
    for i in range(3):
        actor = f'writer-{i}'
        doc = F.set_actor_id(F.init({'backend': B}), actor)
        state, patch = B.apply_changes(F.get_backend_state(doc), base)
        patch['state'] = state
        doc = F.apply_patch(doc, patch)
        doc, _ = F.change(doc, lambda d, c=chr(97 + i): d['text'].insert_at(
            0, *(c * (n_chars // 3))))
        changes.extend(B.get_changes_for_actor(F.get_backend_state(doc),
                                               actor))
    return changes


def text_through_frontend(am, diffs):
    """The text a patch's ``diffs`` give a fresh frontend document of
    facade ``am`` (no backend), as a string."""
    doc = am.Frontend.apply_patch(am.Frontend.init('reader'),
                                  {'diffs': list(diffs)})
    return ''.join(str(c) for c in doc['text'])


def docset_source(am, new, n_docs, rich=False):
    """BASELINE config 3's source replica (``bench.py:362``, ``:429``): an
    ``am.DocSet`` of ``n_docs`` documents ``doc{i}``, each made by
    ``new(f'actor-{i:05d}')`` and one change setting ``id`` and ``n``;
    ``rich``: a title, a nested map, a list and a ``Text``, then a
    second change typing "hey"."""
    src = am.DocSet()

    def rich_init(d, i):
        d['title'] = f'doc {i}'
        d['meta'] = {'v': i}
        d['items'] = [1, 2, i]
        d['text'] = am.Text()

    for i in range(n_docs):
        doc = new(f'actor-{i:05d}')
        if rich:
            doc = am.change(doc, lambda d, i=i: rich_init(d, i))
            doc = am.change(doc, lambda d: d['text'].insert_at(
                0, 'h', 'e', 'y'))
        else:
            doc = am.change(doc, lambda d, i=i: d.update({'id': i,
                                                          'n': i * 2}))
        src.set_doc(f'doc{i}', doc)
    return src


def sync_round(src, dst, connection, batching=None):
    """One exchange of the bench (``bench.py:383``): ``src`` and ``dst``
    each behind a ``connection``, or ``dst`` behind ``batching`` (a
    ``BatchingConnection``, flushed once a delivery round), message
    queues drained until quiet. Returns the message log, each message
    with its sender ('a' the source, 'b' the destination)."""
    msgs_a, msgs_b, log = [], [], []
    ca = connection(src, msgs_a.append)
    cb = (batching or connection)(dst, msgs_b.append)
    ca.open()
    cb.open()
    while msgs_a or msgs_b:
        batch, msgs_a[:] = msgs_a[:], []
        for msg in batch:
            log.append(('a', msg))
            cb.receive_msg(msg)
        if batching is not None:
            cb.flush()
        batch, msgs_b[:] = msgs_b[:], []
        for msg in batch:
            log.append(('b', msg))
            ca.receive_msg(msg)
    return log


def _wall_ms(fn):
    """(fn's result, wall ms with the card drained)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _keys(added):
    return ', '.join(f'{":".join(k)} x{n}' for k, n in sorted(added.items()))


def _config1_cards(am, card):
    """Phase 4g, config 1: the card list built with ``init`` on the card,
    20 three-way merges timed; its saves equal, byte for byte, to the
    same run on the CPU (counter uuids in both), and the merged document
    to the host oracle's."""
    def run(new):
        am.uuid.set_factory(counter_uuids())
        try:
            a, b = card_list_docs(am, new)
            merges = [_wall_ms(lambda: card_list_merge(am, new, a, b))
                      for _ in range(20)]
        finally:
            am.uuid.reset()
        return [am.save(d) for d in (a, b, merges[-1][0])], merges

    before = _launch_counts()
    saves, merges = run(am.init)
    added = _added(_launch_counts(), before)
    merged, t = merges[-1][0], [ms for _, ms in merges]
    if merged['cards'] != [{'title': 'Rewrite everything in JAX',
                            'done': True}]:
        raise AssertionError(f'config 1: cards {merged["cards"]}')
    if saves != run(lambda actor: am.init(actor, device='cpu'))[0]:
        raise AssertionError('config 1: the card run\'s saves != the CPU '
                             'run\'s')
    oracle = lambda actor: am.Frontend.init({'actorId': actor,
                                             'backend': am.Backend})
    if doc_view(merged) != doc_view(card_list_merge(
            am, oracle, *card_list_docs(am, oracle))):
        raise AssertionError('config 1: merged document != the host '
                             'oracle\'s')
    _require_launch(added, 'flatmap_resolve', 'config 1')
    _require_launch(added, 'rga_order', 'config 1')
    print(f'config 1, card list ({card}): 3-way merge p50 '
          f'{np.percentile(t, 50):.3f} ms, p90 {np.percentile(t, 90):.3f} '
          f'ms over 20 merges of card documents; saves byte-equal to the '
          f'CPU run\'s ({sum(map(len, saves))} B), merged == the host '
          f'oracle; launches {_keys(added)}', flush=True)


def _config2_text(am, card, n_chars=10000):
    """Phase 4g, config 2: three writers' changes (built on the host
    oracle) into one ``Text`` through ``DeviceBackend.apply_changes`` by
    its bulk auto-route (the general engine) and by the per-doc route,
    and through ``apply_general_block``; each route's diffs equal to the
    same route on the CPU, its text to the host oracle's."""
    from automerge_tpu_torch.config import Options
    from automerge_tpu_torch.device import backend as DeviceBackend
    from automerge_tpu_torch.device import general
    t0 = time.perf_counter()
    am.uuid.set_factory(counter_uuids())
    try:
        changes = text_writer_changes(am, n_chars)
    finally:
        am.uuid.reset()
    n_ops = sum(len(c['ops']) for c in changes)
    _, patch = am.Backend.apply_changes(am.Backend.init(), changes)
    want_text = text_through_frontend(am, patch['diffs'])
    t_build = (time.perf_counter() - t0) * 1e3
    per_doc = Options(bulk_route_min_ops=None)

    def bulk(device=None):
        return DeviceBackend.apply_changes(DeviceBackend.init(device=device),
                                           changes)[1]['diffs']

    def doc_route(device=None):
        return DeviceBackend.apply_changes(DeviceBackend.init(device=device),
                                           changes, options=per_doc)[1][
            'diffs']

    def block_route(device=None):
        store = general.init_store(1, device=device)
        block = store.encode_changes([changes])
        return store, block

    before = _launch_counts()
    bulk()
    t_bulk = [_wall_ms(bulk) for _ in range(3)]
    bulk_keys = _added(_launch_counts(), before)
    before = _launch_counts()
    doc_diffs, t_doc = _wall_ms(doc_route)
    doc_keys = _added(_launch_counts(), before)
    before = _launch_counts()
    store, block = block_route()
    general.apply_general_block(store, block).block_until_ready()

    def block_once():
        s = general.init_store(1)
        return general.apply_general_block(s, block).block_until_ready()
    t_block = [_wall_ms(block_once)[1] for _ in range(3)]
    s = general.init_store(1)
    block_diffs = general.apply_general_block(s, block).diffs(0)
    block_keys = _added(_launch_counts(), before)
    cpu_store, cpu_block = block_route('cpu')
    cpu = {'bulk': bulk('cpu'), 'per-doc': doc_route('cpu'),
           'block': general.apply_general_block(cpu_store,
                                                cpu_block).diffs(0)}
    got = {'bulk': t_bulk[-1][0], 'per-doc': doc_diffs,
           'block': block_diffs}
    for route, diffs in got.items():
        if list(diffs) != list(cpu[route]):
            raise AssertionError(f'config 2: the {route} route\'s diffs != '
                                 f'the CPU run\'s')
        if text_through_frontend(am, diffs) != want_text:
            raise AssertionError(f'config 2: the {route} route\'s text != '
                                 f'the host oracle\'s')
    for route, added in (('bulk', bulk_keys), ('per-doc', doc_keys),
                         ('block', block_keys)):
        _require_launch(added, 'rga_order', f'config 2\'s {route} route')
    _require_launch({**bulk_keys, **block_keys}, 'edit_stream',
                    'config 2\'s general-engine routes')
    print(f'config 2, three writers\' Text ({card}): {len(changes)} changes, '
          f'{n_ops} ops, {len(want_text)} chars (built on the host oracle in '
          f'{t_build:.1f} ms); bulk auto-route median of 3 '
          f'{np.median([t for _, t in t_bulk]):.1f} ms (launches '
          f'{_keys(bulk_keys)}); per-doc route once {t_doc:.1f} ms '
          f'(launches {_keys(doc_keys)}); apply_general_block median of 3 '
          f'{np.median(t_block):.1f} ms (launches, with one patch read: '
          f'{_keys(block_keys)}); each route\'s diffs == the CPU run\'s, '
          f'its text == the host oracle\'s', flush=True)


def _config3_docsets(am, card, n_eager=100, n_batch=2000):
    """Phase 4g, config 3: DocSet + Connection. (i) ``n_eager`` documents
    made on the card go to an empty ``DocSet`` over two ``Connection``s,
    the message log equal to the same on the CPU and the copies to the
    source; (ii) ``n_batch`` flat documents over a
    ``BatchingConnection`` into a card ``DenseDocSet``; (iii) ``n_batch``
    rich documents into a card ``GeneralDocSet``, its tick's diffs read
    (the edit stream). (ii) and (iii) equal the source and a CPU doc
    set fed the same way. Source documents are made on the card."""
    from automerge_tpu_torch.sync.connection import BatchingConnection
    from automerge_tpu_torch.sync.dense_doc_set import DenseDocSet
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    cpu = lambda actor: am.init(actor, device='cpu')

    def views(ds):
        return {i: doc_view(ds.get_doc(i)) for i in ds.doc_ids}

    # (i) the eager exchange
    before = _launch_counts()
    src, t_src = _wall_ms(lambda: docset_source(am, am.init, n_eager))
    src_keys = _added(_launch_counts(), before)
    rounds = []
    for _ in range(3):
        dst = am.DocSet()
        log, ms = _wall_ms(lambda: sync_round(src, dst, am.Connection))
        rounds.append(ms)
    cpu_log = sync_round(docset_source(am, cpu, n_eager), am.DocSet(),
                         am.Connection)
    if log != cpu_log:
        raise AssertionError('config 3 (i): the message log != the CPU '
                             'run\'s')
    if views(dst) != views(src):
        raise AssertionError('config 3 (i): the copies != the source')
    _require_launch(src_keys, 'flatmap_resolve', 'config 3\'s source')
    print(f'config 3 (i), DocSet + Connection ({card}): {n_eager} documents '
          f'made on the card in {t_src:.1f} ms ({t_src / n_eager:.2f} ms a '
          f'change, launches {_keys(src_keys)}); eager round '
          f'{np.mean(rounds):.1f} ms mean of 3 ({", ".join(f"{t:.1f}" for t in rounds)}'
          f'), {len(log)} messages == the CPU run\'s log; copies == the '
          f'source', flush=True)

    def batched(what, src, make, check):
        """A warm-up round and a timed one into ``make(device)``, then
        the same into a CPU doc set; returns (round ms, launches)."""
        sync_round(src, make(None), am.Connection, BatchingConnection)
        before = _launch_counts()
        dst = make(None)
        log, ms = _wall_ms(lambda: sync_round(src, dst, am.Connection,
                                               BatchingConnection))
        got = check(dst)
        added = _added(_launch_counts(), before)
        cpu_dst = make('cpu')
        if sync_round(src, cpu_dst, am.Connection,
                      BatchingConnection) != log:
            raise AssertionError(f'config 3 {what}: the message log != '
                                 f'the CPU doc set\'s')
        if check(cpu_dst) != got:
            raise AssertionError(f'config 3 {what}: the documents != the '
                                 f'CPU doc set\'s')
        return ms, len(log), added

    # (ii) the batched dense line
    before = _launch_counts()
    src, t_src = _wall_ms(lambda: docset_source(am, am.init, n_batch))
    src_keys = _added(_launch_counts(), before)
    want = {f'doc{i}': {'id': i, 'n': i * 2} for i in range(n_batch)}

    def dense_check(ds):
        got = {i: ds.materialize(i) for i in ds.doc_ids}
        if got != want:
            raise AssertionError('config 3 (ii): the dense documents != '
                                 'the source')
        return got
    ms, n_msgs, added = batched(
        '(ii)', src, lambda d: DenseDocSet(n_batch, key_capacity=8,
                                           actor_capacity=4, device=d),
        dense_check)
    dst = am.DocSet()
    _, t_eager = _wall_ms(lambda: sync_round(src, dst, am.Connection))
    print(f'config 3 (ii), dense line ({card}): {n_batch} documents made on '
          f'the card in {t_src:.1f} ms ({t_src / n_batch:.2f} ms a change, '
          f'launches {_keys(src_keys)}); BatchingConnection into '
          f'DenseDocSet({n_batch}, key_capacity=8, actor_capacity=4) '
          f'{ms:.1f} ms a round after one warm-up, {n_msgs} messages '
          f'(launches {_keys(added) or "none: PyTorch ops"}); the eager '
          f'round at {n_batch} documents {t_eager:.1f} ms; == the source '
          f'and a CPU dense doc set', flush=True)

    # (iii) the general line
    before = _launch_counts()
    src, t_src = _wall_ms(lambda: docset_source(am, am.init, n_batch,
                                                 rich=True))
    src_keys = _added(_launch_counts(), before)
    want = {f'doc{i}': am.inspect(src.get_doc(f'doc{i}'))
            for i in range(n_batch)}

    def general_check(ds):
        got = ds.materialize_all()
        last = got[f'doc{n_batch - 1}']
        if last['text'] != 'hey' or last['items'] != [1, 2, n_batch - 1]:
            raise AssertionError(f'config 3 (iii): doc{n_batch - 1} is '
                                 f'{last}')
        if got != want:
            raise AssertionError('config 3 (iii): the general documents '
                                 '!= the source')
        # the data tick's patch (its read runs the edit stream): each
        # document's diffs build the source's document
        diffs = {i: ds.last_patch.diffs(ds.id_of[i]) for i in ds.ids}
        for i, d in diffs.items():
            doc = am.Frontend.apply_patch(am.Frontend.init('reader'),
                                          {'diffs': list(d)})
            if am.inspect(doc) != want[i]:
                raise AssertionError(f'config 3 (iii): {i}\'s diffs do '
                                     f'not build the source document')
        return got, diffs
    ms, n_msgs, added = batched(
        '(iii)', src, lambda d: GeneralDocSet(n_batch, device=d),
        general_check)
    _require_launch(src_keys, 'rga_order', 'config 3 (iii)\'s source')
    _require_launch(added, ('rga_order', 'order', 'narrow'),
                    'config 3 (iii)\'s round')
    _require_launch(added, ('edit_stream', 'packed'),
                    'config 3 (iii)\'s round')
    print(f'config 3 (iii), general line ({card}): {n_batch} rich documents '
          f'made on the card in {t_src:.1f} ms ({t_src / (2 * n_batch):.2f} '
          f'ms a change, launches {_keys(src_keys)}); BatchingConnection '
          f'into GeneralDocSet({n_batch}) {ms:.1f} ms a round after one '
          f'warm-up, {n_msgs} messages, the tick\'s diffs read (launches '
          f'{_keys(added)}); == the source and a CPU general doc set',
          flush=True)


def _baseline_configs_path(card, inputs):
    """Phase 4g: BASELINE configs 1-3 through the port's public entry
    points, every document on the card by default (see the three
    ``_config*`` functions). Returns the launch counts, by key, of every
    card run of the phase."""
    import automerge_tpu_torch as am
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    t0 = time.perf_counter()
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        _config1_cards(am, card)
        _config2_text(am, card)
        _config3_docsets(am, card)
    counts = _launch_counts()
    print(f'baseline configs 1-3 ({card}): {time.perf_counter() - t0:.1f} s; '
          f'launches {_keys(counts)}', flush=True)
    return counts


# ---- phase 4h: the JAX package's behavioural suites on the card ----------

class _CaseTally:
    """A pytest plugin that counts the cases of a run by outcome, the
    passed ones by the JAX test module they came from."""

    def __init__(self, source_module):
        self.source_module = source_module
        self.passed = collections.Counter()
        self.not_passed = []

    def pytest_runtest_logreport(self, report):
        if report.when == 'call' and report.passed:
            self.passed[self.source_module(report.nodeid)] += 1
        elif report.failed or report.skipped:
            self.not_passed.append(f'{report.nodeid} ({report.outcome} '
                                   f'in {report.when})')


def _conformance_path(card, inputs):
    """Phase 4h: the ``cuda`` lane of :data:`CONFORMANCE_FILES` in this
    process through ``pytest.main`` (``--noconftest``: the repo's
    conftest imports JAX): the JAX package's own behavioural suites,
    re-collected against the port and run at its default device, the
    card, with nothing patched. Every case must pass, the count per JAX
    module must equal :data:`CONFORMANCE_CASES`, and neither JAX nor the
    JAX package may be loaded at the end. The kernel inputs land in
    ``inputs`` (see :func:`_capturing`). Returns the launch counts, by
    key."""
    import pytest
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, 'tests'))
    from test_torch_conformance_harness import source_module
    tally = _CaseTally(source_module)
    args = ['--noconftest', '-p', 'no:cacheprovider', '-p', 'no:xdist',
            '-p', 'no:randomly', '-m', 'cuda', '-q', '--rootdir', root,
            *(os.path.join(root, f) for f in CONFORMANCE_FILES)]
    t0 = time.perf_counter()
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        rc = pytest.main(args, plugins=[tally])
    counts = _launch_counts()
    secs = time.perf_counter() - t0
    loaded = sorted(k for k in sys.modules
                    if k.split('.')[0] in ('jax', 'automerge_tpu'))
    if rc != 0 or tally.not_passed or tally.passed != CONFORMANCE_CASES:
        raise AssertionError(
            f'the JAX package\'s suites on the card: pytest exit {rc}, '
            f'passed {dict(tally.passed)} of {CONFORMANCE_CASES}, not '
            f'passed {tally.not_passed[:20]}')
    if loaded:
        raise AssertionError(f'phase 4h loaded {loaded[:10]}')
    # the per-doc backend's keys (every map-only change; every list or
    # text change), and those the engine suites' patch reads, incremental
    # applies and long rows reach
    for key in (('flatmap_resolve', 'resolve', 'warp'),
                ('rga_order', 'order', 'narrow'),
                ('rga_order', 'order', 'wide'), ('rga_order', 'delta'),
                ('edit_stream', 'packed', 'warp'),
                ('edit_stream', 'packed', 'block')):
        _require_launch(counts, key, 'the JAX package\'s suites')
    print(f'the JAX package\'s suites on the card ({card}): '
          f'{sum(tally.passed.values())} of '
          f'{sum(CONFORMANCE_CASES.values())} cases passed in '
          f'{secs:.1f} s, by module: '
          + ', '.join(f'{m} {n}' for m, n in tally.passed.items()),
          flush=True)
    print(f'the JAX package\'s suites on the card ({card}): launches '
          f'{_keys(counts)}; no JAX module loaded', flush=True)
    return counts


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


def _total(mod):
    """All launches of a kernel module's counter since its reset."""
    return sum(mod.launches.values())


def _launch_counts():
    """Every kernel module's launches since its reset, by launch key
    (kernel, mode, variant)."""
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    return {(name, *k): n
            for name, mod in (('edit_stream', cuda_view),
                              ('rga_order', cuda_sequence),
                              ('flatmap_resolve', cuda_merge))
            for k, n in mod.launches.items()}


def _added(after, before):
    """The launch counts ``after`` holds beyond ``before``."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n > before.get(k, 0)}


@contextlib.contextmanager
def _capturing(into):
    """Wrap the dispatchers through which the main paths reach the
    kernels, so that the inputs of every call on CUDA tensors land in
    ``into[key]`` as (kind, args), ``key`` being the launch the call
    takes (kernel, mode, variant): the edit stream's
    ``dispatch_edit_stream`` ('es'), the RGA order's
    ``_rga_order_batched`` as the general engine and the per-doc backend
    call it ('rga'), the delta orderer ('delta') and the flat-map
    ``resolve_cuda`` ('fm')."""
    from automerge_tpu_torch.device import backend as DB
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view, sequence
    real = {'es': cuda_view.dispatch_edit_stream,
            'rga': sequence._rga_order_batched,
            'db_rga': DB._rga_order_batched,
            'delta': sequence._rga_delta_order_batched,
            'fm': cuda_merge.resolve_cuda}

    def put(key, kind, args):
        into.setdefault(key, []).append((kind, args))

    def es(vis_fmt, planes, touched_u8, e_pad):
        lead = planes if vis_fmt == 'packed' else planes[0]
        if lead.is_cuda:
            put(('edit_stream', vis_fmt, cuda_view.variant(*lead.shape)),
                'es', (vis_fmt, planes, np.array(touched_u8), e_pad))
        return real['es'](vis_fmt, planes, touched_u8, e_pad)

    def rga_via(fn):
        def rga(*a):
            if a[0].is_cuda:
                put(('rga_order', 'order',
                     cuda_sequence.variant(*a[0].shape)), 'rga', a)
            return fn(*a)
        return rga

    def delta(*a):
        if a[0].is_cuda:
            v = cuda_sequence.delta_variant(*a[0].shape)
            put(('rga_order', 'order' if v == 'wide-grid' else 'delta', v),
                'delta', a)
        return real['delta'](*a)

    def fm(*a, **kw):
        if a[0].is_cuda:
            (D, N), S, A = a[0].shape, kw['num_segments'], a[3].shape[2]
            put(('flatmap_resolve', 'resolve',
                 cuda_merge.variant(N, S, A, kw.get('force'), D=D)), 'fm',
                (a, kw))
        return real['fm'](*a, **kw)

    cuda_view.dispatch_edit_stream = es
    sequence._rga_order_batched = rga_via(real['rga'])
    DB._rga_order_batched = rga_via(real['db_rga'])
    sequence._rga_delta_order_batched = delta
    cuda_merge.resolve_cuda = fm
    try:
        yield into
    finally:
        cuda_view.dispatch_edit_stream = real['es']
        sequence._rga_order_batched = real['rga']
        DB._rga_order_batched = real['db_rga']
        sequence._rga_delta_order_batched = real['delta']
        cuda_merge.resolve_cuda = real['fm']


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
    up to ``M_NARROW``; above it the grid variant for a few rows, one
    block per row for many) and each variant directly: the wide kernel
    (its sort inside) in shared memory up to its cap and on global
    memory at every width; above ``M_NARROW`` the grid one after a
    PyTorch child sort, up to it the narrow one. The shapes add single long rows
    (the long text's 49,152, config 4's 196,608) and a few rows at
    40,000. The C side's shared-memory fit of the wide variant (both
    modes) and its grid launch limits must agree with the Python
    dispatch's."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_grid
    from automerge_tpu_torch.device import cuda_sequence, sequence
    n = cuda_sequence.M_NARROW
    limits = [cuda_build.load('rga_order', name, [], ctypes.c_longlong)()
              for name in ('grid_max_rows', 'grid_max_slots')]
    if limits != [cuda_grid.GRID_MAX_ROWS, cuda_grid.GRID_MAX_SLOTS]:
        raise AssertionError(f'the grid launch limits: C {limits}, Python '
                             f'{cuda_grid.GRID_MAX_ROWS}, '
                             f'{cuda_grid.GRID_MAX_SLOTS}')
    shapes = ((1, 2), (6, 16), (37, 200), (12288, 64), (300, n),
              (300, n + 1), (1, 513), (1, 3071), (64, 4096), (1, 12800),
              (2, 40000), (5, 40000), (1, 49152), (1, 196608))
    for m in (*(m for _, m in shapes), 8599, 8600, 9771, 9772):
        for delta in (False, True):
            if cuda_sequence.uses_global_scratch(m, delta) == \
                    cuda_sequence.wide_fits_smem(m, delta):
                raise AssertionError(f'the wide RGA variant\'s shared-'
                                     f'memory fit at m={m} (delta '
                                     f'{delta}): C and Python disagree')
    for tree, gen in (*TREES.items(), ('wide-key', wide_key_trees)):
        rng = np.random.default_rng(4321)
        for K, m in shapes:
            planes = [torch.as_tensor(p).to(dev) for p in gen(rng, K, m)]
            want = sequence._rga_order_plain(*planes)
            got = {'dispatch': sequence._rga_order_batched(*planes)}
            ran = cuda_sequence.last_variant
            if ran != cuda_sequence.variant(K, m):
                raise AssertionError(f'rga {tree} at {(K, m)}: ran {ran}, '
                                     f'not {cuda_sequence.variant(K, m)}')
            rounds = sequence._ceil_log2(m) + 1
            raw = [t.to(torch.int32) for t in planes[:3]]
            if m <= cuda_sequence.M_NARROW:
                got['narrow'] = cuda_sequence.rga_order_cuda(
                    *raw, planes[3], planes[4], rounds=rounds)
            else:
                srt = [t.to(torch.int32) for t in sequence._child_sort(
                    planes[0], planes[1], planes[2], planes[4])]
                got['sort+wide-grid'] = \
                    cuda_sequence.order_from_sorted_cuda(
                        *srt, planes[3], planes[4], rounds=rounds)
            for v in ('wide', 'wide-global'):
                if v == 'wide-global' or cuda_sequence.wide_fits_smem(m):
                    got[v] = cuda_sequence.rga_wide_cuda(
                        *raw, planes[3], planes[4], rounds=rounds, force=v)
            torch.cuda.synchronize()
            for how, out in got.items():
                if _bits_err(out, want, f'rga {(K, m)}', mask=planes[4]):
                    raise AssertionError(f'rga {how} kernel != plain on '
                                         f'{tree} trees at {(K, m)}')
            print(f'kernel: rga_order {tree} trees (K={K}, m={m}) '
                  f'bit-equal to the plain version: {", ".join(got)} '
                  f'(dispatch ran {ran})', flush=True)


def _check_delta_kernel(dev):
    """Phase 3d: the RGA kernel's delta mode against the delta orderer's
    plain version (tree_pos on valid rows) on seeded delta forests —
    anchors up to 2^22 - 1, elems past 2^15 — at every width up to 33
    and at 129, 513, 1,025 and 8,600 through the dispatch (the subwarp
    variant up to ``M_SUBWARP``, the narrow one above, the wide kernel
    with the anchor plane past ``M_NARROW``, on global memory past its
    cap) and each variant directly up to its limit (``M_NARROW``,
    ``M_SUBWARP``; the wide kernel in shared memory up to its cap, on
    global memory at every width)."""
    import torch
    from automerge_tpu_torch.device import cuda_sequence, sequence
    rng = np.random.default_rng(2468)
    for K, m in ((1024, 9), (12288, 9), *((300, w) for w in range(1, 34)),
                 (128, 129), (16, 513), (128, 1025), (3, 8600)):
        planes = [torch.as_tensor(p).to(dev)
                  for p in delta_forests(rng, K, m)]
        valid = planes[4]
        want = sequence._rga_delta_order_plain(*planes)
        got = {'dispatch': sequence._rga_delta_order_batched(*planes)}
        ran = cuda_sequence.last_variant
        if ran != cuda_sequence.delta_variant(K, m):
            raise AssertionError(f'rga delta at m={m}: ran {ran}')
        rounds = sequence._ceil_log2(m) + 1
        for v in ('narrow', 'subwarp'):
            if m <= (cuda_sequence.M_SUBWARP if v == 'subwarp'
                     else cuda_sequence.M_NARROW):
                got[v] = cuda_sequence.rga_delta_cuda(
                    *planes[:4], valid, rounds=rounds, force=v)
        for v in ('wide', 'wide-global'):
            if v == 'wide-global' or cuda_sequence.wide_fits_smem(m, True):
                got[v] = cuda_sequence.rga_wide_cuda(
                    planes[0], planes[2], planes[3], None, valid,
                    rounds=rounds, anchor=planes[1], force=v)
        torch.cuda.synchronize()
        for how, out in got.items():
            if out.dtype != want.dtype or \
                    not torch.equal(out[valid], want[valid]):
                raise AssertionError(f'rga delta {how} kernel != plain at '
                                     f'{(K, m)}')
        print(f'kernel: rga_order delta mode (K={K}, m={m}) bit-equal to '
              f'the plain version on valid rows: {", ".join(got)} '
              f'(dispatch ran {ran})', flush=True)


def _es_plain(vis_fmt, planes, t_u8, e_pad):
    from automerge_tpu_torch.device import cuda_view
    if vis_fmt == 'packed':
        return cuda_view.edit_stream_packed(planes, t_u8, e_pad=e_pad)
    if vis_fmt == 'wide':
        return cuda_view.edit_stream_wide(*planes, t_u8, e_pad=e_pad)
    return cuda_view.edit_stream(*planes, t_u8, e_pad=e_pad)


def _check_wide_edit_stream(dev):
    """Phase 3e: the edit stream's wide format (two word planes) against
    its plain version: a long text's one row (m past 32,768) and rows at
    m <= 512 (the warp variant), each also forced onto the other
    variants; then the grid variant at K = 1 and 3 rows of m in {513,
    32,768, 65,536, 300,000}, packed (up to its 15-bit indexes) and
    wide, e_pad 1, 8 and m, forced and through the dispatch. The C
    side's shared-memory fit of the block variant must agree with the
    Python dispatch's."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_view
    fits = cuda_build.load('edit_stream', 'edit_stream_block_uses_smem',
                           [ctypes.c_int])
    for m in (513, 32768, 65536, 273056, 273057, 300000):
        if bool(fits(m)) != cuda_view.block_fits_smem(m):
            raise AssertionError(f'the edit stream block variant\'s '
                                 f'shared-memory fit at m={m}: C and '
                                 f'Python disagree')
    rng = np.random.default_rng(97531)
    for K, m, e_pad in ((1, 40960, 64), (2, 65536, 256), (64, 200, 24),
                        (1024, 512, 64)):
        pv, nv, pi, ni, tb, _ = random_planes(rng, K, m)
        t_u8 = torch.as_tensor(tb).to(dev)
        planes = tuple(torch.as_tensor(x).to(dev)
                       for x in wide_planes(pv, nv, pi, ni))
        want = _es_plain('wide', planes, t_u8, e_pad)
        picked = cuda_view.variant(K, m)
        for force in (None, 'warp', 'block', 'grid'):
            got = cuda_view.edit_stream_cuda('wide', planes, t_u8, e_pad,
                                             force=force)
            torch.cuda.synchronize()
            if force is None and cuda_view.last_variant != picked:
                raise AssertionError(f'wide edit stream at m={m} ran '
                                     f'{cuda_view.last_variant}')
            if _max_abs_err(got, want, 'wide'):
                raise AssertionError(f'wide kernel ({cuda_view.last_variant})'
                                     f' != plain at {(K, m, e_pad)}')
        print(f'kernel: edit_stream wide format (K={K}, m={m}, '
              f'e_pad={e_pad}), warp, block and grid variants, bit-equal '
              f'to the plain version (dispatch picks {picked})', flush=True)
    for K in (1, 3):
        for m in (513, 32768, 65536, 300000):
            pv, nv, pi, ni, tb, packed = random_planes(rng, K, m)
            t_u8 = torch.as_tensor(tb).to(dev)
            fmts = {'wide': tuple(torch.as_tensor(x).to(dev)
                                  for x in wide_planes(pv, nv, pi, ni))}
            if m <= 32768:
                fmts['packed'] = torch.as_tensor(packed).to(dev)
            for fmt, planes in fmts.items():
                for e_pad in (1, 8, m):
                    want = _es_plain(fmt, planes, t_u8, e_pad)
                    outs = [cuda_view.edit_stream_cuda(fmt, planes, t_u8,
                                                       e_pad, force='grid')]
                    if cuda_view.variant(K, m) == 'grid':
                        outs.append(cuda_view.dispatch_edit_stream(
                            fmt, planes, tb, e_pad))
                    torch.cuda.synchronize()
                    if cuda_view.last_variant != 'grid':
                        raise AssertionError(f'edit stream grid at {(K, m)} '
                                             f'ran {cuda_view.last_variant}')
                    for got in outs:
                        if _max_abs_err(got, want, fmt):
                            raise AssertionError(
                                f'{fmt} grid kernel != plain at '
                                f'{(K, m, e_pad)}')
            print(f'kernel: edit_stream grid variant (K={K}, m={m}), '
                  f'{" and ".join(fmts)}, e_pad 1, 8 and m, bit-equal to '
                  f'the plain version (dispatch picks '
                  f'{cuda_view.variant(K, m)})', flush=True)


LONG_CHARS, LONG_TICKS, LONG_WARM, LONG_BATCH = 32760, 48, 8, 8


def long_text_applies(n_chars=LONG_CHARS, ticks=LONG_TICKS,
                      batch=LONG_BATCH):
    """The JAX package's long-document lane (``bench.py:971``
    ``bench_incremental_order``) at 32,760 chars — 8 below the packed
    format's 32,767-node bound, so the first tick crosses it: one text
    document typed in one change, then ``ticks`` changes of ``batch``
    appended chars, every 5th also deleting the char typed ``batch``
    elems earlier. Returns (the per-apply change lists, the text after
    each apply)."""
    obj = '00000000-0000-4000-8000-00000000a11c'
    ops = [{'action': 'makeText', 'obj': obj},
           {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': obj}]
    prev = '_head'
    chars = []
    for e in range(1, n_chars + 1):
        c = chr(97 + e % 26)
        ops += [{'action': 'ins', 'obj': obj, 'key': prev, 'elem': e},
                {'action': 'set', 'obj': obj, 'key': f'w:{e}', 'value': c}]
        prev = f'w:{e}'
        chars.append((e, c))
    applies = [[{'actor': 'w', 'seq': 1, 'deps': {}, 'ops': ops}]]
    texts = [''.join(c for _, c in chars)]
    elem = n_chars
    for t in range(ticks):
        ops = []
        if t % 5 == 4:
            gone = elem - batch
            ops.append({'action': 'del', 'obj': obj, 'key': f'w:{gone}'})
            chars = [x for x in chars if x[0] != gone]
        for _ in range(batch):
            elem += 1
            c = chr(65 + elem % 26)
            ops += [{'action': 'ins', 'obj': obj, 'key': prev,
                     'elem': elem},
                    {'action': 'set', 'obj': obj, 'key': f'w:{elem}',
                     'value': c}]
            prev = f'w:{elem}'
            chars.append((elem, c))
        applies.append([{'actor': 'w', 'seq': t + 2, 'deps': {},
                         'ops': ops}])
        texts.append(''.join(c for _, c in chars))
    return applies, texts


# the tick path's spans, summed per long-text tick (dict encode, then
# the fused apply's admit -> stage -> dispatch, then the patch read)
_LONG_SPANS = ('admit.encode', 'device.admit', 'device.stage',
               'device.dispatch', 'device.patch_read')

_IDX_KEYS = ('device_idx_incremental_applies', 'device_idx_window_applies',
             'device_idx_rebuild_applies', 'device_idx_invalidations',
             'general_mirror_convert_packed_to_wide')


def _long_text_path(card, inputs):
    """Phase 4b: one long text on the card through ``GeneralDocSet``,
    two arms — the shipped one (incremental index, suffix window) and
    the A/B one (``_INDEX_MODE='rebuild'``, ``_WINDOW_MODE='off'``) —
    each checked after every apply against the host-built string and a
    ``device='cpu'`` run of the port (diffs and text). Prints the p50
    and p90 tick time (apply -> device drained -> diff read) of each
    arm over the ticks after the 8th. The kernel inputs of the card's
    applies land in ``inputs`` (see :func:`_capturing`). Returns (p50 and
    p90 per arm and the launch counts of both arms, by launch key; the
    applies; the CPU run's diffs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    from automerge_tpu_torch.device import general as G
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    from automerge_tpu_torch.utils.metrics import metrics

    t0 = time.perf_counter()
    applies, texts = long_text_applies()
    cpu = GeneralDocSet(1, device='cpu')
    cpu_diffs = []
    for k, ch in enumerate(applies):
        cpu.apply_changes('t', ch)
        cpu_diffs.append(cpu.last_patch.diffs(0))
        if cpu.materialize('t')['text'] != texts[k]:
            raise AssertionError(f'long text apply {k}: cpu text != host')
    print(f'long text: {len(texts[0])} chars, then {LONG_TICKS} ticks of '
          f'{LONG_BATCH} chars (a delete every 5th) to {len(texts[-1])} '
          f'chars; the cpu run of the port matched the host string after '
          f'every apply ({time.perf_counter() - t0:.1f} s)', flush=True)

    counts = {}
    saved = G._INDEX_MODE, G._WINDOW_MODE
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    try:
        for arm, imode, wmode in (('incremental+window', None, None),
                                  ('rebuild, window off', 'rebuild',
                                   'off')):
            G._INDEX_MODE, G._WINDOW_MODE = imode, wmode
            ds = GeneralDocSet(1, device='cuda')
            base = {k: metrics.counters.get(k, 0) for k in _IDX_KEYS}
            launches0 = _launch_counts()
            times, warm_bumps, spans = [], 0, []
            for k, ch in enumerate(applies):
                before = {k2: metrics.counters.get(k2, 0)
                          for k2 in _IDX_KEYS}
                last = k == len(applies) - 1
                ev = []
                metrics.subscribe(ev.append)
                # the last tick runs under torch.profiler (the arm's
                # device busy time and idle share) and is not timed
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) \
                    if last else contextlib.nullcontext()
                try:
                    with prof, _capturing(inputs):
                        t1 = time.perf_counter()
                        ds.apply_changes('t', ch)
                        torch.cuda.synchronize()
                        diffs = ds.last_patch.diffs(0)
                        dt = (time.perf_counter() - t1) * 1e3
                finally:
                    metrics.unsubscribe(ev.append)
                if last:
                    busy, rows = _device_rows(prof, f'the long text '
                                              f'({arm})')
                    last_tick = (dt, busy, rows[:3])
                elif k > LONG_WARM:
                    times.append(dt)
                    spans.append({n: _span_sum(
                        [(e['name'], e['dur_ms']) for e in ev
                         if e.get('event') == 'span'], n)
                        for n in _LONG_SPANS})
                if diffs != cpu_diffs[k]:
                    raise AssertionError(f'long text ({arm}) apply {k}: '
                                         f'cuda diffs != cpu diffs')
                if ds.materialize('t')['text'] != texts[k]:
                    raise AssertionError(f'long text ({arm}) apply {k}: '
                                         f'cuda text != host string')
                d = {k2: metrics.counters.get(k2, 0) - before[k2]
                     for k2 in _IDX_KEYS}
                if imode is None and k >= LONG_WARM + 1:
                    if d['device_idx_incremental_applies'] != 1 or \
                            d['device_idx_window_applies'] != 1:
                        raise AssertionError(f'long text tick {k}: not '
                                             f'incremental and windowed: {d}')
                    warm_bumps += 1
            tot = {k2: metrics.counters.get(k2, 0) - base[k2]
                   for k2 in _IDX_KEYS}
            if tot['general_mirror_convert_packed_to_wide'] != 1:
                raise AssertionError(f'long text ({arm}): packed -> wide '
                                     f'converted {tot} times')
            if ds.store.pool.mirror['fmt'] != 'wide':
                raise AssertionError('the long text is not on the wide '
                                     'mirror')
            arm_launches = _added(_launch_counts(), launches0)
            if imode == 'rebuild':
                for key in (('rga_order', 'order', 'wide-grid'),
                            ('edit_stream', 'wide', 'grid')):
                    if not arm_launches.get(key):
                        raise AssertionError(f'the long text\'s rebuild '
                                             f'arm did not launch {key}: '
                                             f'{arm_launches}')
            times.sort()
            p50 = times[len(times) // 2]
            p90 = times[int(0.9 * len(times))]
            med = {n: float(np.median([sp[n] for sp in spans]))
                   for n in _LONG_SPANS}
            print(f'long text ({arm}, {card}): tick (apply -> drained -> '
                  f'diff read) p50 {p50:.4f} ms, p90 {p90:.4f} ms over '
                  f'{len(times)} ticks after the {LONG_WARM}th (the last '
                  f'tick profiled apart); span medians (ms) '
                  + ', '.join(f'{n} {v:.4f}' for n, v in med.items())
                  + f'; counters {tot}; launches {arm_launches}; every '
                  f'apply\'s diffs == cpu and text == host string',
                  flush=True)
            wall, busy, rows = last_tick
            print(f'profile (the last long-text tick of the {arm} arm under '
                  f'torch.profiler, {card}): wall {wall:.4f} ms, device '
                  f'busy {busy:.4f} ms, idle share {1 - busy / wall:.4f}; '
                  f'largest: ' + '; '.join(f'{key[:60]} {ms:.4f} ms x{n}'
                                           for key, ms, n in rows),
                  flush=True)
            counts[arm] = {'p50': p50, 'p90': p90}
            if imode is None and warm_bumps != LONG_TICKS - LONG_WARM:
                raise AssertionError('long text: warm ticks missed')
    finally:
        G._INDEX_MODE, G._WINDOW_MODE = saved
    counts['launches'] = _launch_counts()
    if not any(k[:2] == ('edit_stream', 'wide') for k in counts['launches']):
        raise AssertionError('the long text did not launch the wide edit '
                             'stream')
    if not any(k[:2] == ('rga_order', 'delta') for k in counts['launches']):
        raise AssertionError('the long text did not launch the RGA delta '
                             'mode')
    return counts, applies, cpu_diffs


# phase 4i: config 5's mixed lists beside page-length texts
MIXED_SMALL, MIXED_TEXTS, MIXED_LIST_OPS = 1920, 128, 22


def _timed_tick(ds, batch, read, sync):
    """One tick through ``apply_changes_batch``, then the diffs of the
    ``read`` doc ids from its patch (the first read runs the patch read
    for the whole tick). Returns (diffs, apply ms, patch-read ms,
    spans)."""
    from automerge_tpu_torch.utils.metrics import metrics
    spans = []

    def on_event(ev):
        if ev.get('event') == 'span':
            spans.append((ev['name'], ev['dur_ms']))

    metrics.subscribe(on_event)
    try:
        t0 = time.perf_counter()
        ds.apply_changes_batch(batch)
        sync()
        t1 = time.perf_counter()
        patch = ds.last_patch
        diffs = {i: patch.diffs(ds.id_of[i]) for i in read}
        sync()
        t2 = time.perf_counter()
    finally:
        metrics.unsubscribe(on_event)
    return diffs, (t1 - t0) * 1e3, (t2 - t1) * 1e3, spans


def _mixed_tick_path(card, inputs):
    """Phase 4i: one collab tick of many small structured documents
    beside a few page-length texts. A ``GeneralDocSet`` of 2,048
    documents on the card: 1,920 of config 5's mixed lists
    (:func:`gen_mixed_docs`, 22 list ops) and 128 texts of 2,000-6,000
    characters by three writers (:func:`gen_text_docs`). Tick 1 rebuilds
    every dirty list and text object in one job table padded to its
    widest row (m = 6,144: the wide RGA kernel on every row); tick 2
    pastes a paragraph of 600-1,000 characters into each text
    (:func:`gen_paste_tick`), so the delta orderer sees rows past
    ``M_NARROW``. Checks: the launch keys (the wide kernel on tick 1 at m
    = 6,144 with every dirty object's row; no PyTorch child sort on the
    card), views and per-document digests equal to a CPU
    ``GeneralDocSet`` fed the same changes (all 128 texts and a seeded
    256 of the lists, in a fleet of their own), each text's length and
    each list's items. Times: the ticks by span, the patch reads, and a
    ``torch.profiler`` window over tick 1 on a second card fleet (device
    busy share, the RGA kernel's device time). The counters are set to
    0 here; returns the launches of the two ticks by launch key; the
    kernel inputs land in ``inputs``."""
    import torch
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view, sequence
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    from automerge_tpu_torch.utils.metrics import metrics
    n_docs = MIXED_SMALL + MIXED_TEXTS
    t0 = time.perf_counter()
    tick1 = gen_mixed_docs(MIXED_SMALL, MIXED_LIST_OPS)
    texts, meta = gen_text_docs(MIXED_TEXTS, doc0=MIXED_SMALL)
    tick1 += texts
    paste, lengths = gen_paste_tick(meta, doc0=MIXED_SMALL)
    ids = [f'mixed{d}' for d in range(n_docs)]
    text_ids = ids[MIXED_SMALL:]
    batches = [{ids[d]: tick1[d] for d in range(n_docs)},
               dict(zip(text_ids, paste))]
    n_ops = [sum(len(c['ops']) for doc in b.values() for c in doc)
             for b in batches]
    chars = [m[3] for m in meta]
    print(f'mixed tick: {MIXED_SMALL} lists ({MIXED_LIST_OPS} list ops) + '
          f'{MIXED_TEXTS} texts of {min(chars)}-{max(chars)} chars (three '
          f'writers); tick 1 {n_ops[0]} ops, tick 2 {n_ops[1]} ops (a '
          f'paste of 600-1,000 chars a text); generated in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    sub = sorted(np.random.default_rng(8).choice(
        MIXED_SMALL, 256, replace=False).tolist()) + \
        list(range(MIXED_SMALL, n_docs))
    sub_ids = [ids[d] for d in sub]

    sorts = []
    real_sort = sequence._child_sort

    def counted_sort(parent, *a, **kw):
        if parent.is_cuda:
            sorts.append(tuple(parent.shape))
        return real_sort(parent, *a, **kw)

    gds = GeneralDocSet(n_docs, device='cuda')
    mine, added, diffs_gpu = {}, [], []
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    sequence._child_sort = counted_sort
    try:
        with _capturing(mine):
            for k, batch in enumerate(batches):
                before = _launch_counts()
                idx0 = {n: metrics.counters.get(n, 0) for n in _IDX_KEYS}
                diffs, t_apply, t_read, spans = _timed_tick(
                    gds, batch, sub_ids if k == 0 else text_ids,
                    torch.cuda.synchronize)
                added.append(_added(_launch_counts(), before))
                idx = {n: metrics.counters.get(n, 0) - idx0[n]
                       for n in _IDX_KEYS}
                diffs_gpu.append(diffs)
                if k == 0:
                    digests = {i: int(gds.digest_of_id(i))
                               for i in sub_ids[:8] + text_ids[-8:]}
                path = 'rebuild' if k == 0 else \
                    'delta mode (incremental index)' \
                    if idx['device_idx_incremental_applies'] else \
                    'rebuild fallback'
                print(f'mixed tick {k + 1} ({card}): {path}; apply '
                      f'{t_apply:.1f} ms = dict encode '
                      f'{_span_sum(spans, "admit.encode"):.1f} + admit '
                      f'{_span_sum(spans, "device.admit"):.1f} + stage '
                      f'{_span_sum(spans, "device.stage"):.1f} + dispatch '
                      f'{_span_sum(spans, "device.dispatch"):.1f} + rest; '
                      f'patch read {t_read:.1f} ms ({len(diffs)} docs); '
                      f'launches {_keys(added[-1])}; index {idx}',
                      flush=True)
        t0 = time.perf_counter()
        views = gds.materialize_all()
        t_mat = (time.perf_counter() - t0) * 1e3
    finally:
        sequence._child_sort = real_sort
    counts = _launch_counts()
    for key, entries in mine.items():
        inputs.setdefault(key, []).extend(entries)

    wide = mine.get(('rga_order', 'order', 'wide'), [])
    if not added[0].get(('rga_order', 'order', 'wide')) or not wide:
        raise AssertionError(f'mixed tick 1 did not launch the wide RGA '
                             f'kernel: {added[0]}')
    K, m = wide[0][1][0].shape
    rows = int(wide[0][1][4].to(torch.bool).any(dim=1).sum())
    if m != 6144 or rows != n_docs:
        raise AssertionError(f'mixed tick 1 handed the wide kernel K={K}, '
                             f'm={m} with {rows} rows of nodes, not every '
                             f'one of the {n_docs} dirty objects at 6,144')
    ext = cuda_sequence.wide_extent(wide[0][1][0], wide[0][1][4])
    if sorts:
        raise AssertionError(f'the PyTorch child sort ran on the card in '
                             f'the mixed tick: {sorts}')
    delta = [a for key, e in mine.items() for kind, a in e
             if kind == 'delta']
    print(f'mixed tick ({card}): tick 1 handed the wide RGA kernel K={K} '
          f'rows at m={m} ({rows} of them dirty objects, their extents '
          f'{int(ext.min())}-{int(ext.max())} slots, mean '
          f'{float(ext.float().mean()):.1f}); tick 2 the delta orderer '
          f'{[tuple(a[0].shape) for a in delta]}; no PyTorch child sort '
          f'on the card; materialize_all {t_mat:.1f} ms', flush=True)

    bad = [i for j, i in enumerate(text_ids)
           if len(views[i]['text']) != lengths[j]]
    bad += [ids[d] for d in range(MIXED_SMALL)
            if len(views[ids[d]]['items']) != MIXED_LIST_OPS
            or views[ids[d]]['meta'] != d]
    if bad:
        raise AssertionError(f'mixed tick: unexpected views {bad[:3]}')
    cds = GeneralDocSet(len(sub), device='cpu')
    t0 = time.perf_counter()
    diffs_cpu = [_timed_tick(cds, {i: b[i] for i in sub_ids if i in b},
                             sub_ids if k == 0 else text_ids,
                             lambda: None)[0]
                 for k, b in enumerate(batches)]
    views_cpu = cds.materialize_all()
    t_cpu = time.perf_counter() - t0
    for i in sub_ids:
        if views_cpu[i] != views[i]:
            raise AssertionError(f'mixed tick {i}: cuda view != cpu view')
        if int(cds.digest_of_id(i)) != int(gds.digest_of_id(i)):
            raise AssertionError(f'mixed tick {i}: cuda digest != cpu')
    for k in range(2):
        for i, dd in diffs_cpu[k].items():
            if dd != diffs_gpu[k][i]:
                raise AssertionError(f'mixed tick {k + 1} {i}: cuda diffs '
                                     f'!= cpu diffs')
    print(f'check: mixed tick views, digests and both ticks\' diffs == cpu '
          f'for all {MIXED_TEXTS} texts and a seeded '
          f'{len(sub) - MIXED_TEXTS} of the lists (own fleet, {t_cpu:.1f} s '
          f'on the cpu); every text at its expected length, every list at '
          f'{MIXED_LIST_OPS} items', flush=True)

    # a torch.profiler window over tick 1 on a second card fleet
    again = GeneralDocSet(n_docs, device='cuda')
    t0 = time.perf_counter()
    prof = _profiled(lambda: (again.apply_changes_batch(batches[0]),
                              again.last_patch.diffs(0)))
    wall = (time.perf_counter() - t0) * 1e3
    busy, k_ms = _kernel_share(prof, 'mixed tick 1', ('rga_wide_kernel',))
    _, rows_p = _device_rows(prof, 'mixed tick 1')
    print(f'profile (mixed tick 1 under torch.profiler, {card}): wall '
          f'{wall:.1f} ms, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.4f}; rga_wide_kernel {k_ms:.4f} ms; '
          f'largest: ' + '; '.join(f'{key[:60]} {ms:.3f} ms x{n}'
                                   for key, ms, n in rows_p[:5]),
          flush=True)
    for i, dg in digests.items():
        if int(again.digest_of_id(i)) != dg:
            raise AssertionError(f'mixed tick: the profiled fleet\'s {i} '
                                 f'differs from tick 1\'s')
    return counts


def _async_path(card, applies, cpu_diffs):
    """Phase 4c: ``apply_general_block_async`` over two blocks of the
    long-text phase on a card store (after the sync load), then
    ``drain_general``: each future's patch equals the sync apply's (the
    cpu run's diffs)."""
    from automerge_tpu_torch.device import general as G
    store = G.init_store(1, device='cuda')
    G.apply_general_block(store, store.encode_changes([applies[0]])) \
        .diffs(0)
    # each block encoded on a store of its own, before the applier runs
    blocks = [G.init_store(1, device='cpu').encode_changes([applies[k]])
              for k in (1, 2)]
    t0 = time.perf_counter()
    futs = [G.apply_general_block_async(store, b) for b in blocks]
    G.drain_general(store)
    dt = (time.perf_counter() - t0) * 1e3
    for k, f in zip((1, 2), futs):
        if f.diffs(0) != cpu_diffs[k]:
            raise AssertionError(f'async apply {k}: diffs != the sync '
                                 f'apply\'s')
    G.close_general(store)
    print(f'async ({card}): two long-text blocks through '
          f'apply_general_block_async + drain_general in {dt:.1f} ms; both '
          f'patches == the sync apply\'s', flush=True)


def _check_flatmap_kernel(dev):
    """Phase 3c: the flat-map kernel's variants (the dispatch's pick, and
    the warp, block and split variants forced) against the plain
    version on
    ``gen_docset_workload(cross_clock=True)`` at the Pallas tests'
    shapes, the flagship shape (and one document more: a partial CTA),
    a slot-heavy shape on the block variant's global memory, replica
    sync's union of one long document (the split variant's main-path
    shape) and a few documents with A % 4 != 0 or one segment; the
    first document's first ops carry out-of-range segment ids."""
    import torch
    from automerge_tpu_torch.device import cuda_build, cuda_merge, merge
    from automerge_tpu_torch.device.workloads import gen_docset_workload
    for D, N, A, keys, S in ((1, 8, 2, 3, 8), (3, 130, 4, 7, 130),
                             (8, 128, 8, 32, 128), (9, 257, 3, 40, 257),
                             (10240, 128, 8, 32, 32),
                             (10241, 128, 8, 32, 32),
                             (4, 64, 8, 6000, 6000),
                             (1, 65536, 16, 4096, 4096),
                             (3, 4096, 3, 256, 256), (2, 31, 4, 1, 1)):
        args = [torch.as_tensor(a).to(dev) for a in gen_docset_workload(
            n_docs=D, n_ops=N, n_actors=A, n_keys=keys, seed=D + N,
            del_p=0.1, invalid_p=0.1, cross_clock=True)]
        args[0][0, :3] = torch.tensor([-1, S, -S - 2], dtype=torch.int32)
        want = merge.resolve_assignments_batch(*args, num_segments=S)
        picked = cuda_merge.variant(N, S, A, D=D)
        ran = []
        for force in (None, 'warp', 'block', 'split'):
            if force == 'warp' and cuda_merge.warp_slice_bytes(N, S, A) > \
                    cuda_build.SMEM_LIMIT:
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


def _device_doc_set_path(card, n_docs, list_ops, inputs):
    """Phase 5: the per-doc device backend behind ``DeviceDocSet(device=
    'cuda')`` at config-5 size, two batches — a map-only fleet (the
    flat-map kernel) and a list fleet (the fused step's RGA kernel) —
    each checked against ``DeviceDocSet(device='cpu')`` on a seeded
    768-document subset and the host-oracle ``DocSet`` on 64 of them.
    The kernel inputs land in ``inputs`` (see :func:`_capturing`).
    Returns the launch counts by launch key."""
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

    dds = DeviceDocSet(device='cuda')
    for name, fn in originals.items():
        setattr(DB, name, timed(name, fn, name in dev_fns))
    try:
        _reset_counts(cuda_view, cuda_sequence, cuda_merge)
        for name, prefix, per_doc in batches:
            before = (_total(cuda_merge), _total(cuda_sequence))
            phase_s.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _capturing(inputs):
                dds.apply_changes_batch({f'{prefix}{d}': per_doc[d]
                                         for d in range(n_docs)})
                torch.cuda.synchronize()
            t_apply = (time.perf_counter() - t0) * 1e3
            fm = _total(cuda_merge) - before[0]
            rga = _total(cuda_sequence) - before[1]
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
        counts = _launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(DB, name, fn)

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
    return counts


# the source of each CUDA kernel and the TPU kernel it replaces
_KERNEL_FILES = {
    'edit_stream': ('automerge_tpu_torch/csrc/edit_stream.cu',
                    'automerge_tpu/device/pallas_view.py:233'),
    'rga_order': ('automerge_tpu_torch/csrc/rga_order.cu',
                  'automerge_tpu/device/pallas_sequence.py:165'),
    'flatmap_resolve': ('automerge_tpu_torch/csrc/flatmap_resolve.cu',
                        'automerge_tpu/device/pallas_merge.py:136'),
}

# bytes per node of the edit stream's vis planes, by format
_ES_NODE_BYTES = {'packed': 4, 'wide': 8, 'cols': 10}


def _delta_err(got, want, valid, where):
    """Largest |got - want| of the delta orderer's tree positions on the
    valid rows; raises when the dtypes or shapes differ."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f'{where}: {got.dtype}{tuple(got.shape)} != '
                             f'{want.dtype}{tuple(want.shape)}')
    if not bool(valid.any()):
        return 0
    return int((got[valid].to(torch.int64) - want[valid].to(torch.int64))
               .abs().max())


def _kernel_calls(key, kind, args):
    """The calls of one captured input of launch ``key`` (kernel, mode,
    variant): ``dispatch`` (the call as the path makes it), ``kernel``
    (the kernel alone on inputs made ready once), ``plain`` (the
    dispatch's plain version), ``kernel_plain`` (the plain version of
    what ``kernel`` alone computes, on the same ready inputs), ``err(got,
    want)``, ``extra`` (other variants of the
    kernel to hold and time beside it), and the ``bytes`` one launch
    must move (each input read once, each output written once) at
    ``shape``."""
    import torch
    from automerge_tpu_torch.device import cuda_grid, cuda_merge
    from automerge_tpu_torch.device import cuda_sequence, cuda_view, merge
    from automerge_tpu_torch.device import sequence
    i32 = torch.int32
    c = {'extra': {}}
    if kind == 'es':
        vis_fmt, planes, tb, e_pad = args
        lead = planes if vis_fmt == 'packed' else planes[0]
        K, m = lead.shape
        ready = planes.contiguous() if vis_fmt == 'packed' else \
            tuple(p.contiguous() for p in planes)
        t_u8 = torch.as_tensor(tb).to(lead.device)
        c['dispatch'] = lambda: cuda_view.dispatch_edit_stream(
            vis_fmt, planes, tb, e_pad)
        c['kernel'] = lambda: cuda_view.edit_stream_cuda(
            vis_fmt, ready, t_u8, e_pad)
        # the other wide-row variant: one block per row beside the grid
        other = {'grid': 'block', 'block': 'grid',
                 'block-global': 'grid'}.get(key[2])
        if other and (other != 'grid' or cuda_grid.fits(K, K * m)):
            c['extra'][other] = lambda: cuda_view.edit_stream_cuda(
                vis_fmt, ready, t_u8, e_pad, force=other)
        c['plain'] = lambda: _es_plain(vis_fmt, ready, t_u8, e_pad)
        c['kernel_plain'] = c['plain']
        c['err'] = lambda got, want: _max_abs_err(got, want, str(key))
        c['bytes'] = K * m * _ES_NODE_BYTES[vis_fmt] + K * tb.shape[1] + \
            5 * K * e_pad * 4 + 12 * K
        c['shape'] = f'K={K} m={m} e_pad={e_pad}'
    elif kind in ('rga', 'delta'):
        K, m = args[0].shape
        rounds = sequence._ceil_log2(m) + 1
        if kind == 'rga':
            parent, elem, actor, visible, valid = args
            anchor = None
            c['dispatch'] = lambda: sequence._rga_order_batched(*args)
            c['plain'] = lambda: sequence._rga_order_plain(*args)
            mask = valid.to(torch.bool)
            c['err'] = lambda got, want: _bits_err(got, want, str(key),
                                                   mask=mask)
        else:
            parent, anchor, elem, actor, valid = args
            visible = valid
            c['dispatch'] = lambda: sequence._rga_delta_order_batched(*args)
            c['plain'] = lambda: sequence._rga_delta_order_plain(*args)
            mask = valid.to(torch.bool)
            c['err'] = lambda got, want: _delta_err(
                got if torch.is_tensor(got) else got['tree_pos'], want,
                mask, str(key))
        flags = (visible.to(torch.bool).contiguous(),
                 valid.to(torch.bool).contiguous())
        # the narrow and wide kernels sort inside, as their plain versions
        # do; the grid kernel takes the PyTorch child sort's output
        c['kernel_plain'] = c['plain']
        raw = [t.to(i32).contiguous() for t in (parent, elem, actor)]
        an = None if anchor is None else anchor.to(i32).contiguous()

        def wide(force=None):
            return lambda: cuda_sequence.rga_wide_cuda(
                *raw, None if kind == 'delta' else flags[0], flags[1],
                rounds=rounds, anchor=an, force=force)

        def grid_step():
            srt = [t.to(i32).contiguous() for t in sequence._child_sort(
                parent, elem, actor, valid, anchor)]
            return cuda_sequence.order_from_sorted_cuda(
                *srt, *flags, rounds=rounds)
        if key[1:] == ('order', 'narrow'):
            c['kernel'] = lambda: cuda_sequence.rga_order_cuda(
                *raw, *flags, rounds=rounds)
        elif key[1] == 'delta' and key[2] in ('narrow', 'subwarp'):
            c['kernel'] = lambda: cuda_sequence.rga_delta_cuda(
                raw[0], an, raw[1], raw[2], flags[1], rounds=rounds,
                force=key[2])
            # the one-warp-a-row delta mode beside the subwarp variant
            if key[2] == 'subwarp':
                c['extra']['narrow'] = lambda: cuda_sequence.rga_delta_cuda(
                    raw[0], an, raw[1], raw[2], flags[1], rounds=rounds,
                    force='narrow')
        elif key[2] in ('wide', 'wide-global'):
            c['kernel'] = wide(key[2])
            # beside it: the grid variant after the PyTorch child sort
            # (timed with its sort)
            if cuda_grid.fits(K, K * (m + 1)):
                c['extra']['sort+wide-grid'] = grid_step
        else:
            srt = [t.to(i32).contiguous() for t in sequence._child_sort(
                parent, elem, actor, valid, anchor)]
            c['kernel'] = lambda: cuda_sequence.order_from_sorted_cuda(
                *srt, *flags, rounds=rounds)
            # one block a row beside the grid: the wide kernel (its sort
            # inside)
            c['extra']['wide'] = wide()
            c['kernel_plain'] = lambda: sequence._order_from_sorted_plain(
                *srt, *flags)
        # the delta mode reads four int32 planes and valid, and writes
        # tree_pos; the rebuild modes read three int32 planes (or the
        # sorted order, parent_adj and parent) and two bool planes, and
        # write three int32 planes and the lengths. The wide kernel needs
        # only a padded row's valid bytes past its extent (its outputs
        # there are fixed), so its bound counts the other inputs over
        # the extents of this input's rows
        if key[2] in ('wide', 'wide-global'):
            slots = int(cuda_sequence.wide_extent(parent, valid).sum())
            c['bytes'] = K * m + slots * (16 if key[1] == 'delta' else 13) \
                + (K * m * 4 if key[1] == 'delta' else K * m * 12 + K * 4)
        else:
            c['bytes'] = K * m * (4 * 4 + 1 + 4) if key[1] == 'delta' else \
                K * m * (4 * 3 + 2 + 12) + K * 4
        c['shape'] = f'K={K} m={m}'
    else:
        a, kw = args
        D, N = a[0].shape
        A = a[3].shape[2]
        S = kw['num_segments']
        c['dispatch'] = lambda: cuda_merge.dispatch_resolve(
            *a, num_segments=S)
        c['kernel'] = lambda: cuda_merge.resolve_cuda(*a, **kw)
        c['plain'] = lambda: merge.resolve_assignments_batch(
            *a, num_segments=S)
        c['kernel_plain'] = c['plain']
        c['err'] = lambda got, want: _bits_err(got, want, str(key))
        # one block a document beside the other variants (at a slot-heavy
        # shape its global-memory form, the split variant's parent)
        if key[2] != 'block':
            c['extra'][cuda_merge.variant(N, S, A, 'block')] = \
                lambda: cuda_merge.resolve_cuda(*a, num_segments=S,
                                                force='block')
        # seg_id, actor, seq int32 + clock int32 [D, N, A] + is_del,
        # valid bool in; surviving bool + winner, seg_max_actor int32 out
        c['bytes'] = D * N * (4 * 3 + 2) + D * N * A * 4 + D * N + \
            2 * D * S * 4
        c['shape'] = f'D={D} N={N} A={A} S={S}'
    c['size'] = K * m if kind != 'fm' else D * N * A
    return c


def _kernel_row(key, n, entries, card):
    """Phase 7 for launch ``key`` (kernel, mode, variant), which the main
    paths launched ``n`` times: every input of it they handed over,
    through the dispatch (which must launch exactly ``key``) against the
    plain version, bit for bit; then, at the largest of those inputs
    (the later of equals), the kernel and the plain version of what it
    computes (for the wide RGA kernel, steps 2-4 from the same child
    sort) timed the same two ways: device time (a CUDA graph of 50 calls, 20 for the
    plain version; median, min and max of 5 replays) and called eagerly
    (as many calls back to back, host launches included). Both reuse one
    input every call, so it stays in L2 where it fits (50 MB). Also the
    dispatch called eagerly and the byte bound. ``ms`` and ``plain_ms``
    are the graph times. Returns the JSON row."""
    import torch
    if not entries:
        raise AssertionError(f'{key} launched {n} times on the main paths '
                             f'but none of its inputs was captured')
    err, big = 0, None
    for kind, args in entries:
        c = _kernel_calls(key, kind, args)
        before = _launch_counts()
        got = c['dispatch']()
        ran = _added(_launch_counts(), before)
        want = c['plain']()
        outs = {'dispatch': got, **{v: f() for v, f in c['extra'].items()}}
        torch.cuda.synchronize()
        if ran != {key: 1}:
            raise AssertionError(f'a main-path input of {key} launched '
                                 f'{ran}')
        for how, out in outs.items():
            e = c['err'](out, want)
            if e:
                raise AssertionError(f'{key} ({how}) != plain at a '
                                     f'main-path input, {c["shape"]} '
                                     f'(max |diff| {e})')
            err = max(err, e)
        if big is None or c['size'] >= big['size']:
            big = c
    t_k = _time_ms(big['kernel'], graph=True)
    t_k_eager = _time_ms(big['kernel'])
    t_eager = _time_ms(big['dispatch'])
    t_plain = _time_ms(big['kernel_plain'], iters=20, graph=True)
    t_plain_eager = _time_ms(big['kernel_plain'], iters=20)
    t_extra = {v: _time_ms(f, graph=True) for v, f in big['extra'].items()}
    bound = big['bytes'] / _HBM_BYTES_PER_S * 1e3
    name = ':'.join(key)
    print(f'{name} ({card}): {n} launches on the main paths; all '
          f'{len(entries)} of their inputs bit-equal to the plain version '
          f'through the dispatch' + ''.join(f' and the {v} variant'
                                            for v in t_extra)
          + f'; at {big["shape"]}, L2 warm: {_fmt_t(t_k)} per launch on '
          f'the device (a CUDA graph of 50 launches, median of 5 replays)'
          + ''.join(f', the {v} variant {_fmt_t(t)}'
                    for v, t in t_extra.items())
          + f'; plain PyTorch {_fmt_t(t_plain)} per call on the device (a '
          f'CUDA graph of 20 calls); called eagerly: the kernel '
          f'{_fmt_t(t_k_eager)}, the dispatch {_fmt_t(t_eager)}, plain '
          f'PyTorch {_fmt_t(t_plain_eager)}; bound {bound:.5f} ms '
          f'({big["bytes"]} bytes at 3.35 TB/s)', flush=True)
    source, replaces = _KERNEL_FILES[key[0]]
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': n, 'max_abs_err': err,
            'ms': t_k[0], 'plain_ms': t_plain[0], 'bound_ms': bound,
            'bound_by': 'bytes', 'library_ms': None, 'mode': key[1],
            'variant': key[2], 'shape': big['shape'],
            'ms_eager': t_k_eager[0], 'plain_ms_eager': t_plain_eager[0],
            'other_variants_ms': {v: t[0] for v, t in t_extra.items()}}


def _dense_path(card, iters=50, stream_k=8):
    """Phase 5b: the dense flat-map engine at the north-star shape —
    ``gen_block_workload()`` (10,240 documents x 10 actors x 10 ops,
    1,024,000 ops) into ``DenseMapStore(device='cuda')``: ``iters``
    blocking applies (``reset()`` before each, drained by
    ``torch.cuda.synchronize``), p50 and p99; the planes bit-equal to a
    ``device='cpu'`` store after the same block and the patch diffs
    equal on a seeded subset; a stream of ``stream_k`` successive blocks
    through ``apply_block_async`` + ``drain``, synced once, against the
    same stream applied synchronously (equal planes); then one
    ``DenseDocSet`` sync exchange over ``BatchingConnection`` at 1,024
    documents, its views equal to the host-oracle ``DocSet``'s. Returns
    the p50 of the blocking applies, in ms."""
    import torch
    import automerge_tpu_torch as am
    from automerge_tpu_torch.device.dense_store import DenseMapStore
    from automerge_tpu_torch.device.workloads import gen_block_workload
    from automerge_tpu_torch.sync import (BatchingConnection, Connection,
                                          DenseDocSet, DocSet)
    from automerge_tpu_torch.utils.metrics import metrics

    t0 = time.perf_counter()
    block = gen_block_workload()
    t_gen = time.perf_counter() - t0
    kw = dict(key_capacity=64, actor_capacity=16)
    torch.cuda.reset_peak_memory_stats()
    store = DenseMapStore(block.n_docs, device='cuda', **kw)
    t0 = time.perf_counter()
    store.apply_block(block).block_until_ready()
    t_first = (time.perf_counter() - t0) * 1e3
    times, parts = [], []
    for _ in range(iters):
        store.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        patch, tm = store.apply_block(block, return_timing=True)
        patch.block_until_ready()
        times.append((time.perf_counter() - t0) * 1e3)
        parts.append(tm)
    p50, p99 = (float(np.percentile(times, q)) for q in (50, 99))
    part_ms = {k: float(np.median([p[k] for p in parts])) * 1e3
               for k in parts[0]}
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f'dense ({card}): {block.n_ops} ops over {block.n_docs} docs '
          f'(generated in {t_gen:.1f} s) into DenseMapStore(device='
          f'\'cuda\'), planes 3 x {tuple(store.eseq.shape)} int32; first '
          f'apply {t_first:.1f} ms; {iters} blocking applies: p50 '
          f'{p50:.2f} ms, p99 {p99:.2f} ms, min {min(times):.2f} ms '
          f'({block.n_ops / p50 * 1e3:.0f} ops/s at p50; medians: admit '
          f'{part_ms["admit"]:.2f} + pack {part_ms["pack"]:.2f} + '
          f'dispatch {part_ms["dispatch"]:.2f} ms, then the drain); peak '
          f'device memory {peak:.1f} MiB', flush=True)

    # one more blocking apply under torch.profiler: the device's share
    store.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = _profiled(lambda: store.apply_block(block).block_until_ready())
    wall = (time.perf_counter() - t0) * 1e3
    busy, rows = _device_rows(prof, 'the dense apply')
    print(f'profile (one dense apply under torch.profiler, {card}): wall '
          f'{wall:.1f} ms, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.4f}', flush=True)
    for key, ms, n in rows[:6]:
        print(f'profile:   {ms:9.3f} ms  x{n:<5d} {key[:90]}', flush=True)

    cpu = DenseMapStore(block.n_docs, device='cpu', **kw)
    t0 = time.perf_counter()
    cpatch = cpu.apply_block(block)
    t_cpu = (time.perf_counter() - t0) * 1e3
    for name in ('eseq', 'eval_', 'm'):
        if not torch.equal(getattr(store, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f'dense plane {name}: cuda != cpu')
    for name in ('fidx', 'winner_slot', 'winner_value', 'alive', 'values'):
        if not torch.equal(getattr(patch, name).cpu(),
                           getattr(cpatch, name)):
            raise AssertionError(f'dense patch {name}: cuda != cpu')
    sub = np.sort(np.random.default_rng(5).choice(block.n_docs, 512,
                                                  replace=False))
    for d in sub.tolist():
        if patch.diffs(d) != cpatch.diffs(d):
            raise AssertionError(f'dense doc {d}: cuda diffs != cpu diffs')
    print(f'check: dense planes eseq/eval/m and the patch tensors bit-equal '
          f'to a cpu store after the same block (cpu apply {t_cpu:.0f} '
          f'ms); diffs equal on a seeded {len(sub)}-doc subset',
          flush=True)

    def stream():
        return [gen_block_workload(seed=k, seq0=k + 1)
                for k in range(stream_k)]

    def run_stream(blocks, pipelined):
        store.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks:
            if pipelined:
                last = store.apply_block_async(blk)
            else:
                last = store.apply_block(blk)
                last.block_until_ready()
        last.block_until_ready()
        store.drain()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(blocks)

    t_sync = run_stream(stream(), False)
    sync_planes = [getattr(store, n).clone() for n in ('eseq', 'eval_', 'm')]
    t_pipe = run_stream(stream(), True)
    store.close()
    for name, want in zip(('eseq', 'eval_', 'm'), sync_planes):
        if not torch.equal(getattr(store, name), want):
            raise AssertionError(f'dense stream plane {name}: pipelined '
                                 f'!= synchronous')
    print(f'dense stream ({card}): {stream_k} successive 1M-op blocks, '
          f'synchronous {t_sync:.2f} ms a block, pipelined '
          f'(apply_block_async + drain, synced once) {t_pipe:.2f} ms a '
          f'block; final planes equal', flush=True)

    # one DenseDocSet sync exchange (bench.py's dense sync shape)
    n = 1024
    src = DocSet()
    for i in range(n):
        doc = am.Frontend.init({'actorId': f'actor-{i:05d}',
                                'backend': am.Backend})
        src.set_doc(f'doc{i}', am.change(
            doc, lambda d, i=i: d.update({'id': i, 'n': i * 2})))
    dst = DenseDocSet(n, key_capacity=8, actor_capacity=4, device='cuda')
    msgs_a, msgs_b = [], []
    ca = Connection(src, msgs_a.append)
    cb = BatchingConnection(dst, msgs_b.append)
    batches0 = metrics.counters.get('dense_batches', 0)
    n_msgs = 0
    t0 = time.perf_counter()
    ca.open()
    cb.open()
    while msgs_a or msgs_b:
        batch, msgs_a[:] = msgs_a[:], []
        for m in batch:
            n_msgs += 1
            cb.receive_msg(m)
        cb.flush()
        batch, msgs_b[:] = msgs_b[:], []
        for m in batch:
            n_msgs += 1
            ca.receive_msg(m)
    torch.cuda.synchronize()
    t_sync_ms = (time.perf_counter() - t0) * 1e3
    for i in range(n):
        want = dict(src.get_doc(f'doc{i}'))
        if dst.materialize(f'doc{i}') != want:
            raise AssertionError(f'dense doc set doc{i}: view != host '
                                 f'oracle')
    print(f'dense doc set ({card}): {n} documents synced over '
          f'BatchingConnection in {t_sync_ms:.1f} ms, {n_msgs} messages, '
          f'{metrics.counters.get("dense_batches", 0) - batches0} device '
          f'applies; every view equal to the host-oracle DocSet',
          flush=True)
    return p50


# the fault mix of the socket replay (tests/test_socket_chaos.py)
_SOCKET_CHAOS = {'drop': 0.05, 'dup': 0.05, 'cut': 0.01, 'corrupt': 0.01}


def _fleet_path(card, inputs):
    """Phase 5c: serving, control, transport and the fleet simulator on
    the card. (a) ``zipf`` at its full scale (3 nodes, 1,024 documents,
    10,240 load ops, the wire on, the controller on): green, every
    node's views equal to ``run_oracle(schedule, device='cpu')`` (the
    plain path), state digests equal across nodes; (b) ``flash_crowd``
    at full scale with the controller on (green) and off (red), views
    equal to the CPU oracle's; (c) ``replay_schedule_over_sockets`` of
    ``reconnect_storm`` at its smoke scale over loopback sockets through
    the chaos proxies, equal to the oracle, nothing quarantined or
    diverged. Every node's store is on the card; the RGA kernel's
    launches are counted and their inputs captured into ``inputs``.
    Returns the launch counts by launch key."""
    import torch
    from automerge_tpu_torch import fleetsim
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    from automerge_tpu_torch.sync.chaos import replay_schedule_over_sockets

    runs = (('zipf', 'full', True, 'green'),
            ('flash_crowd', 'full', True, 'green'),
            ('flash_crowd', 'full', False, 'red'))
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        for name, scale, controller, verdict in runs:
            sched = fleetsim.build_schedule(name, scale=scale)
            t0 = time.perf_counter()
            r = fleetsim.FleetSim(schedule=sched, controller=controller,
                                  collect_views=True, device='cuda').run()
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            t0 = time.perf_counter()
            oracle = fleetsim.run_oracle(sched, device='cpu')
            t_oracle = time.perf_counter() - t0
            if len(set(oracle)) != 1:
                raise AssertionError(f'{name}: the cpu oracle diverged')
            if any(v != oracle[0] for v in r['views']):
                raise AssertionError(f'{name} (controller {controller}): '
                                     f'cuda views != the cpu oracle')
            if r['verdict'] != verdict:
                raise AssertionError(
                    f'{name} (controller {controller}): verdict '
                    f'{r["verdict"]}, want {verdict}: '
                    f'{[k for k, c in r["checks"].items() if not c["ok"]]}')
            if not r['checks']['replicas_digest_equal']['ok'] or \
                    not r['state_digests']:
                raise AssertionError(f'{name}: node digests differ')
            print(f'fleet {name} {scale} ({card}, controller '
                  f'{"on" if controller else "off"}): {r["verdict"]}; '
                  f'{sched["spec"]["n_nodes"]} nodes x '
                  f'{sched["spec"]["n_docs"]} docs, {r["n_ops"]} ops in '
                  f'{r["wall_s"]} s of ticks ({t_run:.1f} s with set-up), '
                  f'{r["ops_per_sec"]} ops/s, convergence p99 '
                  f'{r["convergence_ms_p99"]} ms, peak memory pressure '
                  f'{r["peak_memory_pressure"]}, control '
                  f'{r["control_actions"]}; views of every node == the cpu '
                  f'oracle (run_oracle {t_oracle:.1f} s), state digests '
                  f'equal across nodes', flush=True)
        # the flash crowd once more under torch.profiler: the device's
        # share of a serving fleet's run
        sched = fleetsim.build_schedule('flash_crowd', scale='full')
        t0 = time.perf_counter()
        prof = _profiled(lambda: fleetsim.FleetSim(
            schedule=sched, device='cuda').run())
        wall = (time.perf_counter() - t0) * 1e3
        busy, rows = _device_rows(prof, 'the flash crowd')
        print(f'profile (flash_crowd full, controller on, under '
              f'torch.profiler, {card}): wall {wall:.1f} ms, device busy '
              f'{busy:.2f} ms, idle share {1 - busy / wall:.4f}',
              flush=True)
        for key, ms, n in rows[:6]:
            print(f'profile:   {ms:9.3f} ms  x{n:<5d} {key[:90]}',
                  flush=True)
        # seed 5: the reference's own socket-replay test of this scenario
        sched = fleetsim.build_schedule('reconnect_storm', seed=5,
                                        scale='smoke')
        t0 = time.perf_counter()
        out = replay_schedule_over_sockets(sched, chaos=_SOCKET_CHAOS,
                                           device='cuda')
        t_sock = time.perf_counter() - t0
        oracle = fleetsim.run_oracle(sched, device='cpu')
        if out['views'] != oracle:
            raise AssertionError('socket replay views != the cpu oracle')
        if out['quarantined'] or out['diverged']:
            raise AssertionError(f'socket replay quarantined '
                                 f'{out["quarantined"]}, diverged '
                                 f'{out["diverged"]}')
        print(f'fleet reconnect_storm smoke over sockets ({card}): '
              f'{sched["spec"]["n_nodes"]} nodes, chaos {_SOCKET_CHAOS}, '
              f'converged in {out["ticks"]} ticks ({t_sock:.1f} s), views '
              f'== the cpu oracle, 0 quarantined, 0 diverged', flush=True)
    counts = _launch_counts()
    rga = {k: n for k, n in counts.items() if k[0] == 'rga_order'}
    if not rga:
        raise AssertionError('the fleet path launched no RGA kernel')
    print(f'fleet launches: {counts} (RGA {sum(rga.values())})',
          flush=True)
    return counts


# ---- phase 5d: the mesh layer ----------------------------------------------


def mesh_of(dev, n=4):
    """The smoke's 4-entry mesh over the visible devices: entry i on
    ``cuda:(i % device_count)`` (``dev`` 'cpu': logical CPU entries)."""
    import torch
    from automerge_tpu_torch.parallel.mesh import make_mesh
    if torch.device(dev).type == 'cpu':
        return make_mesh(n, device='cpu')
    count = torch.cuda.device_count()
    return make_mesh(devices=[torch.device('cuda', i % count)
                              for i in range(n)])


def _sync_all(dev):
    import torch
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize()


class _MeshCounts:
    """Phase 5d's launch counts: each part's drive runs with every
    counter set to 0 just before it and read just after, its kernel
    inputs captured into ``inputs``; the comparisons run outside."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.counts = {}

    @contextlib.contextmanager
    def drive(self, what, need=()):
        from automerge_tpu_torch.device import (cuda_merge, cuda_sequence,
                                                cuda_view)
        _reset_counts(cuda_view, cuda_sequence, cuda_merge)
        with _capturing(self.inputs):
            yield
        got = _launch_counts()
        for kernel in need:
            if not any(k[0] == kernel for k in got):
                raise AssertionError(f'{what} did not launch {kernel}')
        for k, n in got.items():
            self.counts[k] = self.counts.get(k, 0) + n


def _mesh_collectives(mesh, card):
    """5d(a): psum, pmax, all_gather (untiled and tiled) and ppermute on
    ``mesh`` against numpy, bit for bit."""
    import torch
    from automerge_tpu_torch.parallel import mesh as M
    rng = np.random.default_rng(41)
    n = mesh.devices.size
    arr = rng.integers(-2**20, 2**20, size=(n, 1024, 16)).astype(np.int32)
    xs = [torch.as_tensor(a).to(d) for a, d in zip(arr, mesh.devices)]
    ring = [(i, (i + 1) % n) for i in range(n)]
    checks = (('psum', M.psum(xs), [arr.sum(axis=0, dtype=np.int32)] * n),
              ('pmax', M.pmax(xs), [arr.max(axis=0)] * n),
              ('all_gather', M.all_gather(xs), [arr] * n),
              ('all_gather tiled', M.all_gather(xs, tiled=True),
               [arr.reshape(-1, 16)] * n),
              ('ppermute', M.ppermute(xs, ring),
               [arr[(i - 1) % n] for i in range(n)]))
    for name, got, want in checks:
        for g, w, d in zip(got, want, mesh.devices):
            if g.device != d or g.dtype != torch.int32 or \
                    not np.array_equal(g.cpu().numpy(), w):
                raise AssertionError(f'mesh collective {name} != numpy')
    print(f'mesh (a) ({card}): psum, pmax, all_gather (untiled, tiled) '
          f'and ppermute over {n} entries {[str(d) for d in mesh.devices]}'
          f' of [1024, 16] int32 shards == numpy, bit for bit', flush=True)


def _mesh_fleet(mesh, card, counts, ticks, ids, plain, views, diffs, sub,
                apply_ms, dev='cuda', n_migrate=1024):
    """5d(b): config 5 sharded — ``ShardedGeneralDocSet(n, n_shards=4,
    mesh=mesh)`` takes the general ticks through ``apply_changes_batch``;
    each shard's ``last_patch`` diffs for ``sub`` equal the unsharded
    fleet's (``diffs``), ``materialize_all`` its views and the per-doc
    digests its digests; then ``n_migrate`` documents migrate with
    digest verification and the views stay as they were."""
    from automerge_tpu_torch.sync.sharded import ShardedGeneralDocSet
    n_docs = len(ids)
    fleet = ShardedGeneralDocSet(n_docs, n_shards=4, mesh=mesh)
    for k, batch in enumerate(ticks):
        with counts.drive(f'sharded tick {k + 1}',
                          need=('rga_order', 'edit_stream')):
            t0 = time.perf_counter()
            fleet.apply_changes_batch({ids[d]: batch[d]
                                       for d in range(n_docs)})
            _sync_all(dev)
            t_apply = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            got = {}
            for d in sub:
                shard = fleet.shards[fleet.shard_of(ids[d])]
                got[ids[d]] = shard.last_patch.diffs(shard.id_of[ids[d]])
            t_read = (time.perf_counter() - t0) * 1e3
        bad = [i for i in got if got[i] != diffs[k][i]]
        if bad:
            raise AssertionError(f'sharded tick {k + 1}: diffs != the '
                                 f'unsharded fleet\'s for {bad[:3]}')
        print(f'mesh (b) tick {k + 1} ({card}): ShardedGeneralDocSet '
              f'({n_docs} docs, 4 shards) apply {t_apply:.1f} ms against '
              f'the unsharded fleet\'s {apply_ms[k]:.1f} ms (phase 4); '
              f'patch read of {len(sub)} docs {t_read:.1f} ms; diffs == '
              f'phase 4\'s', flush=True)
    per_shard = [sum(1 for s in fleet._doc_shard.values() if s == i)
                 for i in range(4)]
    t0 = time.perf_counter()
    got = fleet.materialize_all()
    t_mat = (time.perf_counter() - t0) * 1e3
    if got != views:
        raise AssertionError('sharded views != the unsharded fleet\'s')
    bad = [i for i in ids
           if int(fleet.digest_of_id(i)) != int(plain.digest_of_id(i))]
    if bad:
        raise AssertionError(f'sharded digests differ for {bad[:3]}')
    rng = np.random.default_rng(17)
    movers = [ids[d] for d in rng.choice(n_docs, n_migrate, replace=False)]
    plan = {d: (fleet.shard_of(d) + 1 + int(rng.integers(3))) % 4
            for d in movers}
    t0 = time.perf_counter()
    moved = fleet.migrate_docs(plan)
    _sync_all(dev)
    t_mig = (time.perf_counter() - t0) * 1e3
    if moved != n_migrate or any(fleet.shard_of(d) != s
                                 for d, s in plan.items()):
        raise AssertionError(f'migrated {moved} of {n_migrate} documents')
    if fleet.materialize_all() != views:
        raise AssertionError('views changed across the migration')
    bad = [i for i in movers
           if int(fleet.digest_of_id(i)) != int(plain.digest_of_id(i))]
    if bad:
        raise AssertionError(f'migrated digests differ for {bad[:3]}')
    status = fleet.fleet_status(docs=False)
    print(f'mesh (b) ({card}): docs per shard {per_shard}; '
          f'materialize_all {t_mat:.1f} ms == the unsharded views of all '
          f'{n_docs} docs, per-doc digests equal; migrate_docs of '
          f'{n_migrate} docs (digest-verified) {t_mig:.1f} ms, views and '
          f'digests unchanged; placement migrations '
          f'{status["placement"]["migrations"]}, imbalance '
          f'{status["placement"]["imbalance"]}', flush=True)


def _mesh_capture(mesh, card, counts, tick, dev='cuda'):
    """5d(c): the reference's multichip gate — a captured config-5 tick
    1 (the fused program's staged planes and outputs) re-run through
    ``sharded_step_from_capture`` on ``mesh``: survivors, winners,
    visibility and visible indexes bit-equal to the fused outputs."""
    from automerge_tpu_torch.device import general
    from automerge_tpu_torch.parallel.general_shard import \
        sharded_step_from_capture
    captured = {}
    store = general.init_store(len(tick), device=dev)
    general._STAGE_CAPTURE = captured.update
    try:
        patch = general.apply_general_block(store,
                                            store.encode_changes(tick))
    finally:
        general._STAGE_CAPTURE = None
    with counts.drive('the sharded general step', need=('rga_order',)):
        t0 = time.perf_counter()
        got, fused = sharded_step_from_capture(mesh, store, patch,
                                               captured)
        t_step = (time.perf_counter() - t0) * 1e3
    for k in ('surviving', 'winner', 'visible', 'vis_index'):
        if got[k].dtype != fused[k].dtype or \
                not np.array_equal(got[k], fused[k]):
            raise AssertionError(f'sharded general step {k} != the fused '
                                 f'program\'s')
    K, m = fused['visible'].shape
    print(f'mesh (c) ({card}): sharded_step_from_capture of tick 1 '
          f'({int(captured["n_rows"])} rows, {captured["vis_fmt"]} '
          f'{captured["variant"]} program, jobs K={K} m={m} over '
          f'{mesh.devices.size} entries) in {t_step:.1f} ms: survivors, '
          f'winners, visibility and visible indexes bit-equal to the '
          f'fused outputs', flush=True)


def _mesh_engine(mesh, card, counts, docs, dev='cuda'):
    """5d(d): ``ShardedDocSetEngine(mesh)`` on the map-only fleet: the
    per-doc fields equal ``batch_merge_docs`` on ``dev``; the kernel
    outputs and stats of ``sharded_merge_step`` on ``mesh`` equal a CPU
    mesh's on the same packed arrays."""
    import torch
    from automerge_tpu_torch.config import Options
    from automerge_tpu_torch.device import engine, packing
    from automerge_tpu_torch.parallel.docset_engine import (
        ShardedDocSetEngine, sharded_merge_step)
    from automerge_tpu_torch.parallel.mesh import make_mesh, shard_docs
    with counts.drive('ShardedDocSetEngine', need=('flatmap_resolve',)):
        t0 = time.perf_counter()
        got, stats = ShardedDocSetEngine(mesh).apply_changes_batch(docs)
        t_eng = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = engine.batch_merge_docs(docs, device=dev)
    t_one = (time.perf_counter() - t0) * 1e3
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f'sharded engine fields != batch_merge_docs '
                             f'for docs {bad[:3]}')
    packed = [packing.pack_assignments(c) for c in docs]
    arrays = packing.pad_and_stack(packed)[:6]
    S = Options().pad_segments(max(p.n_segments for p in packed))
    with counts.drive('sharded_merge_step', need=('flatmap_resolve',)):
        out, st = sharded_merge_step(mesh, *shard_docs(mesh, *arrays),
                                     num_segments=S)
        _sync_all(dev)
    cpu = make_mesh(mesh.devices.size, device='cpu')
    c_out, c_st = sharded_merge_step(cpu, *shard_docs(cpu, *arrays),
                                     num_segments=S)
    for k in out:
        if not torch.equal(torch.cat([t.cpu() for t in out[k]]),
                           torch.cat(c_out[k])):
            raise AssertionError(f'sharded merge step {k}: {dev} != cpu')
    c_st = {k: int(v) for k, v in c_st.items()}
    if stats != c_st or {k: int(v) for k, v in st.items()} != c_st:
        raise AssertionError(f'sharded merge stats {stats} != cpu {c_st}')
    D, N = arrays[0].shape
    print(f'mesh (d) ({card}): ShardedDocSetEngine over '
          f'{mesh.devices.size} entries, {D} docs x {N} ops '
          f'({int(arrays[5].sum())} ops, D = {D // mesh.devices.size} a '
          f'shard) {t_eng:.1f} ms, fields == batch_merge_docs '
          f'({t_one:.1f} ms); kernel outputs and stats {c_st} == a cpu '
          f'mesh', flush=True)


def peer_ops(n_peers=4, n_ops=16384, n_actors=16, n_keys=4096, seed=23):
    """5d(e)'s hot document: ``n_peers`` replicas, each holding
    ``n_ops`` locally made set/del ops from its own ``n_actors /
    n_peers`` writers (each writer's chain sequential, concurrent with
    every other writer), over ``n_keys`` keys. Returns the packed [P, n]
    columns, [P, n, A] clocks and [P, A] replica clocks."""
    rng = np.random.default_rng(seed)
    per = n_actors // n_peers
    chain = n_ops // per
    seg_id = rng.integers(0, n_keys, size=(n_peers, n_ops)).astype(np.int32)
    actor = (np.arange(n_peers)[:, None] * per
             + np.arange(n_ops)[None, :] // chain).astype(np.int32)
    seq = np.tile(np.arange(n_ops, dtype=np.int32) % chain + 1,
                  (n_peers, 1))
    clock = np.zeros((n_peers, n_ops, n_actors), np.int32)
    p_idx, o_idx = np.indices((n_peers, n_ops))
    clock[p_idx, o_idx, actor] = seq - 1
    is_del = rng.random((n_peers, n_ops)) < 0.05
    valid = np.ones((n_peers, n_ops), bool)
    peer_clock = np.zeros((n_peers, n_actors), np.int32)
    for p in range(n_peers):
        peer_clock[p, p * per:(p + 1) * per] = chain
    return seg_id, actor, seq, clock, is_del, valid, peer_clock


def _mesh_peers(card, counts, dev='cuda', n_ops=16384, n_keys=4096,
                windows=(64, 1024)):
    """5d(e): replica sync over ``make_peer_mesh`` on four entries: the
    all-gather and ring rounds give identical rows on every peer, equal
    to a CPU peer mesh's; delta sync (all-gather and ring, each window)
    ends in a round that ships 0, and every peer's buffer then resolves
    to the union's outcome."""
    import torch
    from automerge_tpu_torch.device.cuda_merge import dispatch_resolve
    from automerge_tpu_torch.parallel import ici_sync
    mesh = ici_sync.make_peer_mesh(devices=mesh_of(dev).devices)
    cpu = ici_sync.make_peer_mesh(4, device='cpu')
    cols = peer_ops(n_ops=n_ops, n_keys=n_keys)
    P, A = cols[6].shape
    with counts.drive('peer sync', need=('flatmap_resolve',)):
        t0 = time.perf_counter()
        out, clocks, stats = ici_sync.sync_step(
            mesh, *ici_sync.shard_peers(mesh, *cols), num_segments=n_keys)
        _sync_all(dev)
        t_ag = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ring = ici_sync.ring_sync_step(
            mesh, *ici_sync.shard_peers(mesh, *cols[:6]),
            num_segments=n_keys)
        _sync_all(dev)
        t_ring = (time.perf_counter() - t0) * 1e3
    c_out, c_clocks, c_stats = ici_sync.sync_step(
        cpu, *ici_sync.shard_peers(cpu, *cols), num_segments=n_keys)
    c_ring = ici_sync.ring_sync_step(
        cpu, *ici_sync.shard_peers(cpu, *cols[:6]), num_segments=n_keys)
    for name, got, want in (('all-gather', out, c_out),
                            ('ring', ring, c_ring)):
        for k in got:
            rows = [t.cpu() for t in got[k]]
            if not all(torch.equal(r, c) for r, c in zip(rows, want[k])):
                raise AssertionError(f'{name} sync {k}: {dev} != cpu')
            if name == 'all-gather' and \
                    not all(torch.equal(r, rows[0]) for r in rows):
                raise AssertionError(f'all-gather sync {k}: peers differ')
    if not all(torch.equal(c.cpu(), w) for c, w in zip(clocks, c_clocks)) \
            or {k: int(v) for k, v in stats.items()} != \
            {k: int(v) for k, v in c_stats.items()}:
        raise AssertionError('peer sync clocks or stats != cpu')
    union = [torch.as_tensor(a.reshape((1, -1) + a.shape[2:])).to(
        mesh.devices[0]) for a in cols[:6]]
    ref = dispatch_resolve(*union, num_segments=n_keys)
    ref_surv = int(ref['surviving'].sum())
    logs = {}
    for ring_mode in (False, True):
        for window in windows:
            state = ici_sync.make_delta_state(mesh, *cols[:6],
                                              n_cap=P * n_ops)
            with counts.drive('delta sync'):
                t0 = time.perf_counter()
                state, log = ici_sync.delta_sync_converge(
                    mesh, state, window=window, ring=ring_mode,
                    max_rounds=8192)
                _sync_all(dev)
                t_d = (time.perf_counter() - t0) * 1e3
            if log[-1] != 0 or int(torch.cat(state[6]).min()) != P * n_ops:
                raise AssertionError(f'delta sync (ring {ring_mode}, '
                                     f'window {window}) did not converge')
            for p in range(P):
                got = dispatch_resolve(*(x[p] for x in state[:6]),
                                       num_segments=n_keys)
                if not torch.equal(got['seg_max_actor'],
                                   ref['seg_max_actor'].to(
                                       got['seg_max_actor'].device)) or \
                        int(got['surviving'].sum()) != ref_surv:
                    raise AssertionError(f'delta sync peer {p} resolves '
                                         f'unlike the union')
            logs['ring' if ring_mode else 'all-gather', window] = \
                (len(log), sum(log), t_d)
    print(f'mesh (e) ({card}): {P} peers x {n_ops} ops over A={A} actors, '
          f'S={n_keys} keys; sync_step {t_ag:.1f} ms and ring_sync_step '
          f'{t_ring:.1f} ms, identical rows on every peer == a cpu peer '
          f'mesh; delta sync (rounds, ops shipped, ms): '
          + '; '.join(f'{m} window {w}: {n} rounds, {s} ops, {t:.1f} ms'
                      for (m, w), (n, s, t) in logs.items())
          + '; each ends shipping 0 and every peer resolves like the '
          'union', flush=True)


def _mesh_hot_shard(card, counts, dev='cuda', scale='full'):
    """5d(f): ``hot_shard`` (one sharded node, its documents pinned to
    shard 0): green with the controller, red without; views equal
    ``run_oracle(device='cpu')``; with the controller at least one
    migration and a settled imbalance of at most 2.2."""
    from automerge_tpu_torch import fleetsim
    sched = fleetsim.build_schedule('hot_shard', scale=scale)
    t0 = time.perf_counter()
    oracle = fleetsim.run_oracle(sched, device='cpu')
    t_oracle = time.perf_counter() - t0
    spec = sched['spec']
    for controller, verdict in ((True, 'green'), (False, 'red')):
        with counts.drive('hot_shard', need=('rga_order',)):
            t0 = time.perf_counter()
            r = fleetsim.FleetSim(schedule=sched, controller=controller,
                                  collect_views=True, device=dev).run()
            _sync_all(dev)
            t_run = time.perf_counter() - t0
        if r['verdict'] != verdict or r['views'] != oracle:
            raise AssertionError(
                f'hot_shard (controller {controller}): verdict '
                f'{r["verdict"]}, views == oracle: {r["views"] == oracle}; '
                f'{[k for k, c in r["checks"].items() if not c["ok"]]}')
        if controller and (r['migrations'] < 1 or
                           r['shard_imbalance'] > 2.2):
            raise AssertionError(f'hot_shard: {r["migrations"]} migrations,'
                                 f' imbalance {r["shard_imbalance"]}')
        print(f'mesh (f) hot_shard {scale} ({card}, controller '
              f'{"on" if controller else "off"}): {r["verdict"]}; 1 node x '
              f'{spec["n_docs"]} docs over {spec["n_shards"]} shards, '
              f'{r["n_ops"]} ops in {r["wall_s"]} s of ticks '
              f'({t_run:.1f} s with set-up), {r["ops_per_sec"]} ops/s, '
              f'settled imbalance {r["shard_imbalance"]}, migrations '
              f'{r["migrations"]}, control {r["control_actions"]}; views '
              f'== the cpu oracle ({t_oracle:.1f} s)', flush=True)


def _mesh_dense(mesh, card, dense_p50, dev='cuda', iters=10, block=None):
    """5d(g): the 1M-op dense block into ``DenseMapStore(n, mesh=mesh)``:
    planes and patch tensors bit-equal to an unsharded store on ``dev``
    after the same block; p50 of ``iters`` blocking applies."""
    import torch
    from automerge_tpu_torch.device.dense_store import DenseMapStore
    from automerge_tpu_torch.device.workloads import gen_block_workload
    block = gen_block_workload() if block is None else block
    kw = dict(key_capacity=64, actor_capacity=16)
    plain = DenseMapStore(block.n_docs, device=dev, **kw)
    store = DenseMapStore(block.n_docs, mesh=mesh, **kw)
    want = plain.apply_block(block).block_until_ready()
    got = store.apply_block(block).block_until_ready()
    for name in ('eseq', 'eval_', 'm'):
        if not torch.equal(getattr(store, name), getattr(plain, name)):
            raise AssertionError(f'sharded dense plane {name} != unsharded')
    for name in ('fidx', 'winner_slot', 'winner_value', 'alive', 'values'):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f'sharded dense patch {name} != unsharded')
    times = []
    for _ in range(iters):
        store.reset()
        _sync_all(dev)
        t0 = time.perf_counter()
        store.apply_block(block).block_until_ready()
        _sync_all(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(times, 50))
    print(f'mesh (g) ({card}): {block.n_ops} ops over {block.n_docs} docs '
          f'into DenseMapStore(mesh=4 entries), planes 4 x '
          f'{tuple(store._planes[0][0].shape)} int32 a plane; planes and '
          f'patch tensors bit-equal to the unsharded store; {iters} '
          f'blocking applies p50 {p50:.2f} ms, min {min(times):.2f} ms '
          f'against phase 5b\'s unsharded p50 {dense_p50:.2f} ms',
          flush=True)


def _mesh_scaling(mesh, card, counts, dev='cuda', n_docs=4096,
                  requests=128):
    """5d(h): the JAX package's sharded-fleet scaling lane
    (``bench.py:1400``): ``n_docs`` six-element lists, then ``requests``
    single-doc mid-list inserts, timed one by one (device drained), at
    1 shard and at 4 over ``mesh``. Returns {shards: (p50, p99)}."""
    import random
    from automerge_tpu_torch.parallel.mesh import make_mesh
    from automerge_tpu_torch.sync.sharded import ShardedGeneralDocSet

    def obj_of(d):
        return f'00000000-0000-4000-8000-{d:012x}'

    seed_len = 6
    out = {}
    for n_shards in (1, 4):
        m = mesh if n_shards == 4 else make_mesh(devices=mesh.devices[:1])
        fleet = ShardedGeneralDocSet(n_docs, n_shards=n_shards, mesh=m)
        per = {}
        for d in range(n_docs):
            ops = [{'action': 'makeList', 'obj': obj_of(d)},
                   {'action': 'link', 'obj': ROOT_ID, 'key': 'items',
                    'value': obj_of(d)},
                   {'action': 'ins', 'obj': obj_of(d), 'key': '_head',
                    'elem': 1}]
            for i in range(2, seed_len + 1):
                ops.append({'action': 'ins', 'obj': obj_of(d),
                            'key': f'w0-{d}:{i - 1}', 'elem': i})
            per[f'doc{d}'] = [{'actor': f'w0-{d}', 'seq': 1, 'deps': {},
                               'ops': ops}]
        items = list(per.items())
        for i in range(0, len(items), 1024):
            fleet.apply_changes_batch(dict(items[i:i + 1024]))
        rng = random.Random(7)
        seqs = {}

        def request(t, d=None):
            d = rng.randrange(n_docs) if d is None else d
            k = seqs.get(d, 1) + 1
            seqs[d] = k
            elem = seed_len + 1 + k
            fleet.apply_changes(f'doc{d}', [
                {'actor': f'w0-{d}', 'seq': k, 'deps': {f'w0-{d}': k - 1},
                 'ops': [
                     {'action': 'ins', 'obj': obj_of(d),
                      'key': f'w0-{d}:{rng.randrange(1, seed_len)}',
                      'elem': elem},
                     {'action': 'set', 'obj': obj_of(d),
                      'key': f'w0-{d}:{elem}', 'value': t}]}])

        warm = {}
        for d in range(n_docs):
            warm.setdefault(fleet.shard_of(f'doc{d}'), []).append(d)
        t = 0
        for docs in warm.values():
            for d in docs[:max(6, -(-16 // len(warm)))]:
                request(t, d=d)
                t += 1
        _sync_all(dev)
        times = []
        with counts.drive(f'the scaling lane at {n_shards} shards',
                          need=('rga_order',)):
            for t in range(requests):
                t1 = time.perf_counter()
                request(t)
                _sync_all(dev)
                times.append((time.perf_counter() - t1) * 1e3)
        # the seed's elements carry no value; each insert adds one
        views = fleet.materialize_all()
        short = [d for d in range(n_docs)
                 if len(views[f'doc{d}']['items']) != seqs.get(d, 1) - 1]
        if short:
            raise AssertionError(f'scaling lane lists of the wrong length: '
                                 f'{short[:3]}')
        out[n_shards] = (float(np.percentile(times, 50)),
                         float(np.percentile(times, 99)))
    print(f'mesh (h) ({card}): {n_docs} docs, {requests} single-doc '
          f'mid-list inserts, request p50 / p99: 1 shard '
          f'{out[1][0]:.3f} / {out[1][1]:.3f} ms, 4 shards '
          f'{out[4][0]:.3f} / {out[4][1]:.3f} ms', flush=True)
    return out


def _mesh_path(card, inputs, ticks, ids, plain, views, diffs, sub,
               apply_ms, dense_p50):
    """Phase 5d: the mesh layer on the card, parts (a)-(h) over the
    4-entry mesh :func:`mesh_of`. Returns the launch counts by launch
    key, summed over the parts' drives."""
    from automerge_tpu_torch.parallel.mesh import make_mesh
    t_all = time.perf_counter()
    mesh = mesh_of('cuda')
    print(f'mesh ({card}): make_mesh() covers '
          f'{make_mesh().devices.size} visible card(s); the 4-entry mesh '
          f'is {[str(d) for d in mesh.devices]}', flush=True)
    counts = _MeshCounts(inputs)
    part = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        part[name] = time.perf_counter() - t0
        return out

    timed('a', _mesh_collectives, mesh, card)
    timed('b', _mesh_fleet, mesh, card, counts, ticks, ids, plain, views,
          diffs, sub, apply_ms)
    timed('c', _mesh_capture, mesh, card, counts, ticks[0])
    timed('d', _mesh_engine, mesh, card, counts, gen_map_fleet(len(ids)))
    timed('e', _mesh_peers, card, counts)
    timed('f', _mesh_hot_shard, card, counts)
    timed('g', _mesh_dense, mesh, card, dense_p50)
    timed('h', _mesh_scaling, mesh, card, counts)
    print(f'mesh launches: {counts.counts}; parts (s): '
          + ', '.join(f'{k} {v:.1f}' for k, v in part.items())
          + f'; phase 5d {time.perf_counter() - t_all:.1f} s', flush=True)
    return counts.counts


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from automerge_tpu_torch import native as amnative
    from automerge_tpu_torch.device import (cuda_build, cuda_grid,
                                            cuda_merge, cuda_sequence,
                                            cuda_view)
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
        picked = cuda_view.variant(K, m)
        forced = ('warp', 'block', 'grid') if cuda_grid.fits(K, K * m) \
            else ('warp', 'block')
        for force in (None, *forced):
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
              f'cols, {", ".join(forced)} variants, bit-equal to the '
              f'plain version (dispatch picks {picked}; drop path hit: '
              f'{drops})', flush=True)
    _check_rga_kernel(dev)
    _check_delta_kernel(dev)
    _check_wide_edit_stream(dev)
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

    # every kernel input the main paths hand the kernels, by the launch
    # it takes, for the kernel-vs-plain checks and the timings of phase 7
    inputs = {}

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
    diffs_gpu, apply_ms = [], []
    _reset_counts(cuda_view, cuda_sequence, cuda_merge)
    with _capturing(inputs):
        for k, batch in enumerate(ticks):
            before = _launch_counts()
            incr0 = metrics.counters.get('device_idx_incremental_applies', 0)
            diffs, t_apply, t_read, spans = run_tick(
                gds, batch, range(n_docs), sub, torch.cuda.synchronize)
            added = _added(_launch_counts(), before)
            if not any(key[0] == 'edit_stream' for key in added):
                raise AssertionError(f'tick {k + 1} did not launch the '
                                     f'edit-stream kernel')
            if not any(key[0] == 'rga_order' for key in added):
                raise AssertionError(f'tick {k + 1} did not launch the RGA '
                                     f'kernel')
            if k == 1 and (
                    not added.get(('rga_order', 'delta', 'subwarp'))
                    or metrics.counters.get(
                        'device_idx_incremental_applies', 0) != incr0 + 1):
                raise AssertionError('tick 2 did not take the incremental '
                                     'index update through the RGA '
                                     'kernel\'s delta mode (subwarp)')
            diffs_gpu.append(diffs)
            apply_ms.append(t_apply)
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
    main_counts = _launch_counts()
    native_batches = metrics.counters.get('general_stage_native_batches', 0)
    variants = {k: v for k, v in metrics.counters.items()
                if k.startswith('general_variant_')}
    if _total(cuda_merge):
        raise AssertionError('the general tick launched the flat-map kernel')
    mir = gds.store.pool.mirror
    if mir['fmt'] != 'packed' or mir['w2'].device.type != 'cuda':
        raise AssertionError(f'mirror not packed on the card: {mir["fmt"]}')
    idx = {k: metrics.counters.get(k, 0) for k in _IDX_KEYS}
    print(f'main path (cuda, {card}): materialize_all {t_mat:.1f} ms, '
          f'launches {main_counts}, native staging batches '
          f'{native_batches}, variants {variants}, index {idx}, '
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

    # ---- 4b. a long text across the packed bound, and the async apply ----
    long_counts, long_applies, long_diffs = _long_text_path(card, inputs)
    _async_path(card, long_applies, long_diffs)


    # ---- 4d-4f. config 5 over the wire, config 4, the facade ----
    with tempfile.TemporaryDirectory() as workdir:
        wire_counts = _wire_fleet_path(card, ticks, ids, cds, sub, inputs,
                                       workdir)
    text_counts = _text_trace_path(card, inputs)
    facade_counts = _facade_map_path(card, inputs)

    # ---- 4g. BASELINE configs 1-3 through the public entry points ----
    baseline_counts = _baseline_configs_path(card, inputs)

    # ---- 4h. the JAX package's behavioural suites on the card ----
    conformance_counts = _conformance_path(card, inputs)

    # ---- 4i. a mixed tick: small lists beside page-length texts ----
    t0 = time.perf_counter()
    mixed_counts = _mixed_tick_path(card, inputs)
    print(f'phase 4i ({card}): {time.perf_counter() - t0:.1f} s',
          flush=True)

    # ---- 5. the per-doc device backend: DeviceDocSet at config-5 size ----
    dds_counts = _device_doc_set_path(card, n_docs, list_ops, inputs)

    # ---- 5b. the dense engine's 1M-op block; 5c. the fleet ----
    dense_p50 = _dense_path(card)
    fleet_counts = _fleet_path(card, inputs)

    # ---- 5d. the mesh layer ----
    mesh_counts = _mesh_path(card, inputs, ticks, ids, gds, views_gpu,
                             diffs_gpu, sub, apply_ms, dense_p50)

    # ---- 6. device busy vs wall ----
    _profile_tick(gds, ids, n_docs, list_ops, card)

    # ---- 7. the kernels at the main paths' inputs ----
    launched = {}
    for counts in (main_counts, long_counts['launches'], mixed_counts,
                   wire_counts, text_counts, facade_counts,
                   baseline_counts, conformance_counts, dds_counts,
                   fleet_counts, mesh_counts):
        for key, n in counts.items():
            launched[key] = launched.get(key, 0) + n
    # the widths the delta orderer was handed, over every call the paths
    # made on the card (the subwarp variant's bound rests on them)
    widths = collections.Counter(
        a[0].shape[1] for entries in inputs.values()
        for kind, a in entries if kind == 'delta')
    print(f'delta orderer widths ({card}): m -> calls over all '
          f'{sum(widths.values())} calls on the main paths, '
          f'{sum(n for k, n in launched.items() if k[1] == "delta")} of '
          f'them delta-mode launches: {dict(sorted(widths.items()))}',
          flush=True)
    kernels = [_kernel_row(key, n, inputs.get(key), card)
               for key, n in sorted(launched.items())]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def _device_rows(prof, what):
    """(busy ms, rows sorted by device time) of a ``torch.profiler``
    capture: device-side events only (kernels and copies) — the aten op
    rows carry the same device time again as their own "self" time.
    Raises when the capture recorded no device event."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError(f'torch.profiler recorded no device events '
                             f'for {what}; the idle share was not measured')
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def _profile_tick(gds, ids, n_docs, list_ops, card):
    """One more tick (a fourth actor per document) under
    ``torch.profiler``: device busy time against the tick's wall time,
    and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from automerge_tpu_torch.utils.metrics import metrics
    tick3 = gen_tick2(n_docs, list_ops, seed=1, actor='w3')
    before = {k: metrics.counters.get(k, 0) for k in _IDX_KEYS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gds.apply_changes_batch({ids[d]: tick3[d] for d in range(n_docs)})
        gds.last_patch.diffs(0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # tick 3 re-inserts elems 49 and 50, not above the pre-tick maximum:
    # the eligibility gate must send it to the whole-object rebuild
    d = {k: metrics.counters.get(k, 0) - before[k] for k in _IDX_KEYS}
    if d['device_idx_rebuild_applies'] != 1 or \
            d['device_idx_invalidations'] != 1 or \
            d['device_idx_incremental_applies']:
        raise AssertionError(f'tick 3 did not fall back to the rebuild: {d}')
    busy, rows = _device_rows(prof, 'tick 3')
    print(f'profile (tick 3 under torch.profiler, {card}): a rebuild '
          f'fallback ({d["device_idx_invalidations"]} invalidation); wall '
          f'{wall:.1f} ms, device busy {busy:.2f} ms, idle share '
          f'{1 - busy / wall:.4f}', flush=True)
    for key, ms, n in rows[:8]:
        print(f'profile:   {ms:9.3f} ms  x{n:<5d} {key[:90]}', flush=True)


if __name__ == '__main__':
    sys.exit(main())
