"""The dense flat-map engine: the PyTorch port's ``DenseMapStore`` and
``DenseDocSet`` against the JAX package's on the same numpy-seeded
inputs — exact equality, dtypes included.

The three device programs (``_apply_kernel``, ``_apply_extract_kernel``,
``_extract_kernel``) take the same staged columns in both packages, with
padding rows, deletes, cross-actor closure clocks (COO triples) and
value refs both sequential (rebuilt on the device) and shipped. Then the
store end to end: ``apply_block`` patches over a causal stream,
``extract_all``, the async applier, snapshots written by either package
and loaded by the other, and ``DenseDocSet`` replicating against the JAX
package's over ``Connection``. A ``mesh=`` store (its planes split over
logical CPU mesh entries) is bit-equal to the unsharded store and to
the JAX package's sharded store, and resumes sharded from a snapshot. A ``cuda``-marked case holds the card's
planes bit-equal to a CPU store's (run there with ``python -m pytest
tests/test_torch_dense_store.py -m cuda``)."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.common import ROOT_ID
from automerge_tpu_torch.device import blocks as tblocks
from automerge_tpu_torch.device import dense_store as tdense
from automerge_tpu_torch.device import workloads as twork
from automerge_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_metrics():
    """Each test starts and ends with both packages' registries empty."""
    from automerge_tpu.utils.metrics import metrics as jmetrics
    from automerge_tpu_torch.utils.metrics import metrics as tmetrics
    jmetrics.reset()
    tmetrics.reset()
    yield
    jmetrics.reset()
    tmetrics.reset()

PLANES = ('eseq', 'eval_', 'm')
OUTS = ('fidx', 'winner_slot', 'winner_value', 'alive', 'values')


def _change(actor, seq, deps, ops):
    return {'actor': actor, 'seq': seq, 'deps': deps, 'ops': ops}


def _random_stream(seed, n_docs, n_blocks, actors=('aa', 'bb', 'cc', 'dd'),
                   n_keys=6, ops=3, del_p=0.3):
    """Per-block per-doc change lists: every change depends on what its
    doc has seen from other actors (cross-actor closure clocks), some
    ops delete, values repeat (so the value table dedupes)."""
    rng = np.random.default_rng(seed)
    seqs = [{a: 0 for a in actors} for _ in range(n_docs)]
    out = []
    for _ in range(n_blocks):
        per_doc = [[] for _ in range(n_docs)]
        for d in range(n_docs):
            for a in rng.permutation(actors)[:rng.integers(0, 3)]:
                a = str(a)
                deps = {b: s for b, s in seqs[d].items()
                        if b != a and s and rng.random() < 0.6}
                keys = rng.permutation(n_keys)[:ops]
                body = []
                for k in keys:
                    if rng.random() < del_p:
                        body.append({'action': 'del', 'obj': ROOT_ID,
                                     'key': f'k{k}'})
                    else:
                        body.append({'action': 'set', 'obj': ROOT_ID,
                                     'key': f'k{k}',
                                     'value': int(rng.integers(0, 5))})
                seqs[d][a] += 1
                per_doc[d].append(_change(a, seqs[d][a], deps, body))
        out.append(per_doc)
    return out


def _same_planes(jstore, tstore):
    for name in PLANES:
        a = np.asarray(getattr(jstore, name))
        b = getattr(tstore, name).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def _same_outs(jout, tout, names):
    for name, a, b in zip(names, jout, tout):
        a = np.asarray(a)
        b = b.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def _staged(seed, n_docs, key_capacity, actor_capacity, shipped_values):
    """One block staged by the JAX store (admission, slots, packing),
    its planes seeded at random so the scatters meet prior state."""
    from automerge_tpu.device import blocks as jblocks
    from automerge_tpu.device import dense_store as jdense
    stream = _random_stream(seed, n_docs, 2)
    store = jdense.DenseMapStore(n_docs, key_capacity=key_capacity,
                                 actor_capacity=actor_capacity)
    store.apply_block(jblocks.ChangeBlock.from_changes(stream[0]))
    finish, _ = store._stage_block(
        jblocks.ChangeBlock.from_changes(stream[1]))
    args, statics = finish()
    args = [np.array(a) for a in args]
    # eight more padded op rows, as a larger bucket would leave
    n_pad = args[7].shape[0]
    args[7] = np.concatenate([args[7], np.zeros(8, args[7].dtype)])
    args[8] = np.packbits(np.concatenate(
        [np.unpackbits(args[8])[:n_pad], np.zeros(8, np.uint8)]))
    if args[9].shape[0] == n_pad:
        args[9] = np.concatenate([args[9], np.full(8, -1, np.int32)])
    # three more padded COO triples (row c_pad: dropped by the scatter)
    c_pad = args[0].shape[0]
    args[4] = np.concatenate([args[4], np.full(3, c_pad, np.int32)])
    args[5] = np.concatenate([args[5], np.zeros(3, args[5].dtype)])
    args[6] = np.concatenate([args[6], np.zeros(3, args[6].dtype)])
    rng = np.random.default_rng(seed + 100)
    shape = (store.n_fields, actor_capacity)
    planes = [rng.integers(0, 8, shape).astype(np.int32),
              rng.integers(-3, 9, shape).astype(np.int32),
              rng.integers(-1, 4, shape).astype(np.int32)]
    planes[1][rng.random(shape) < 0.3] = tdense._VAL_NONE
    if shipped_values:
        # value refs shipped as a column (not rebuilt from v_base)
        n_pad = args[7].shape[0]
        args[9] = rng.integers(-1, 50, n_pad).astype(np.int32)
        statics = dict(statics, seq_values=False)
    return planes, args, statics


def _to_torch(args):
    return [torch.from_numpy(a) if a.ndim else int(a) for a in args]


@pytest.mark.parametrize('shipped_values', [False, True])
@pytest.mark.parametrize('seed,n_docs,key_capacity,actor_capacity',
                         [(0, 3, 8, 4), (1, 7, 6, 8), (2, 12, 8, 5)])
def test_device_programs_match_jax(seed, n_docs, key_capacity,
                                   actor_capacity, shipped_values):
    from automerge_tpu.device import dense_store as jdense
    planes, args, statics = _staged(seed, n_docs, key_capacity,
                                    actor_capacity, shipped_values)
    if not shipped_values:
        assert statics['seq_values']
    assert (args[4] < args[0].shape[0]).any()       # cross-actor clocks
    assert args[10] < args[7].shape[0]              # padded op rows
    tplanes = [torch.from_numpy(p) for p in planes]
    targs = _to_torch(args)
    kargs = dict(n_fields=statics['n_fields'],
                 n_actors=statics['n_actors'],
                 seq_values=statics['seq_values'])
    # _apply_kernel takes the op counts after the COO triples
    order = [0, 1, 2, 4, 5, 6, 3, 7, 8, 9, 10, 11, 12]
    japply = jdense._apply_kernel(*planes, *[args[i] for i in order],
                                  **kargs)
    tapply = tdense._apply_kernel(*tplanes, *[targs[i] for i in order],
                                  **kargs)
    _same_outs(japply, tapply, PLANES)
    jfull = jdense._apply_extract_kernel(*planes, *args, **statics)
    tfull = tdense._apply_extract_kernel(*tplanes, *targs, **statics)
    _same_outs(jfull, tfull, PLANES + OUTS)
    # the extract alone, over a mask with more fields than the floor
    mask = np.random.default_rng(seed).random(statics['n_fields']) < 0.5
    f_pad = int(mask.sum()) + 5
    jext = jdense._extract_kernel(*japply, args[13], key_capacity,
                                  mask, f_pad=f_pad)
    text = tdense._extract_kernel(*tapply, targs[13], key_capacity,
                                  torch.from_numpy(mask), f_pad=f_pad)
    _same_outs(jext, text, OUTS)
    assert int((np.asarray(jext[0]) == -1).sum()) == 5


def _pair(n_docs, key_capacity=8, actor_capacity=6):
    from automerge_tpu.device import dense_store as jdense
    return (jdense.DenseMapStore(n_docs, key_capacity=key_capacity,
                                 actor_capacity=actor_capacity),
            tdense.DenseMapStore(n_docs, key_capacity=key_capacity,
                                 actor_capacity=actor_capacity,
                                 device='cpu'))


def test_apply_block_stream_and_extract_all_match_jax():
    from automerge_tpu.device import blocks as jblocks
    n_docs = 9
    jstore, tstore = _pair(n_docs)
    for per_doc in _random_stream(3, n_docs, 4):
        jp = jstore.apply_block(jblocks.ChangeBlock.from_changes(per_doc))
        tp = tstore.apply_block(tblocks.ChangeBlock.from_changes(per_doc))
        _same_planes(jstore, tstore)
        _same_outs([getattr(jp, k) for k in OUTS],
                   [getattr(tp, k) for k in OUTS], OUTS)
        assert [jp.diffs(d) for d in range(n_docs)] == \
            [tp.diffs(d) for d in range(n_docs)]
    je, te = jstore.extract_all(), tstore.extract_all()
    assert je.to_patches() == te.to_patches()
    assert jstore.host.clock_of(2) == tstore.host.clock_of(2)


def test_workload_stream_async_applier_and_snapshots_match_jax():
    """The config-5 generator's block stream (sequential values, the
    wire-lean path) through the async applier against the JAX package's
    synchronous applies; then snapshots cross both ways."""
    from automerge_tpu.device import dense_store as jdense
    from automerge_tpu.device import workloads as jwork
    n_docs = 16
    jstore, tstore = _pair(n_docs, key_capacity=16, actor_capacity=8)
    jpatches, tpatches = [], []
    for k in range(3):
        kw = dict(n_docs=n_docs, n_actors=4, ops_per_change=3, n_keys=12,
                  seed=k, del_p=0.2, seq0=k + 1)
        jpatches.append(jstore.apply_block(jwork.gen_block_workload(**kw)))
        tpatches.append(tstore.apply_block_async(
            twork.gen_block_workload(**kw)))
    tstore.drain()
    _same_planes(jstore, tstore)
    for jp, tp in zip(jpatches, tpatches):
        assert jp.to_patches() == tp.to_patches()
    tstore.close()
    assert tstore._applier is None

    back = jdense.DenseMapStore.load_snapshot(tstore.save_snapshot())
    _same_planes(back, tstore)
    assert back.extract_all().to_patches() == \
        tstore.extract_all().to_patches()
    fwd = tdense.DenseMapStore.load_snapshot(jstore.save_snapshot(),
                                             device='cpu')
    _same_planes(jstore, fwd)
    assert fwd.host.log_truncated and fwd.device.type == 'cpu'
    # both resumed stores keep applying identically
    kw = dict(n_docs=n_docs, n_actors=4, ops_per_change=3, n_keys=12,
              seed=9, seq0=4)
    back.apply_block(jwork.gen_block_workload(**kw))
    fwd.apply_block(twork.gen_block_workload(**kw))
    _same_planes(back, fwd)


def test_dense_doc_set_replicates_against_jax():
    """A port DenseDocSet and a JAX DenseDocSet, each fed half of the
    writes, converge over Connection to the same views and clocks."""
    from automerge_tpu.sync import DenseDocSet as JDense
    from automerge_tpu.sync import Connection as JConnection
    from automerge_tpu_torch.sync import Connection, DenseDocSet
    n_docs = 6
    jset = JDense(8, key_capacity=8, actor_capacity=8)
    tset = DenseDocSet(8, key_capacity=8, actor_capacity=8, device='cpu')
    # each replica writes as its own actors, as real peers do
    j_stream = _random_stream(5, n_docs, 2, actors=('aa', 'bb'))
    t_stream = _random_stream(6, n_docs, 2, actors=('cc', 'dd'))
    for per_doc, dset in ((j_stream[0], jset), (t_stream[0], tset),
                          (j_stream[1], jset), (t_stream[1], tset)):
        dset.apply_changes_batch(
            {f'doc{d}': ch for d, ch in enumerate(per_doc) if ch})
    to_j, to_t = [], []
    cj = JConnection(jset, to_t.append)
    ct = Connection(tset, to_j.append)
    cj.open()
    ct.open()
    for _ in range(50):
        if not (to_j or to_t):
            break
        while to_j:
            cj.receive_msg(to_j.pop(0))
        while to_t:
            ct.receive_msg(to_t.pop(0))
    assert sorted(jset.doc_ids) == sorted(tset.doc_ids)
    for doc_id in jset.doc_ids:
        assert jset.materialize(doc_id) == tset.materialize(doc_id), doc_id
        clock = tset.get_doc(doc_id)._state['backendState'].clock
        assert clock == jset.get_doc(doc_id)._state['backendState'].clock
    assert any(len(tset.get_doc(d)._state['backendState'].clock) == 4
               for d in tset.doc_ids)
    assert not tset.store.host.queue and not jset.store.host.queue


def test_entry_points_resolve_their_device():
    from automerge_tpu_torch.sync import DenseDocSet
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tdense.DenseMapStore(2)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            DenseDocSet(2)
    store = tdense.DenseMapStore(2, key_capacity=4, actor_capacity=2,
                                 device='cpu')
    assert all(getattr(store, p).device.type == 'cpu' for p in PLANES)
    # a mesh store lives on its mesh's entries, whatever ``device`` says
    store = tdense.DenseMapStore(2, key_capacity=4, actor_capacity=2,
                                 mesh=make_mesh(2, device='cpu'))
    assert store.device.type == 'cpu'
    assert all(getattr(store, p).device.type == 'cpu' for p in PLANES)


def _mesh_pair(n_docs, n_dev, **kw):
    return (tdense.DenseMapStore(n_docs, device='cpu', **kw),
            tdense.DenseMapStore(n_docs, mesh=make_mesh(n_dev,
                                                        device='cpu'),
                                 **kw))


def _same_store(a, b):
    for name in PLANES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert getattr(b, name).dtype == torch.int32


@pytest.mark.parametrize('n_dev', [1, 3, 4])
def test_mesh_store_is_bit_equal_to_the_unsharded_store(n_dev):
    """Causal blocks with closure clocks, deletes and shipped value
    refs: planes, every patch tensor (padding rows included) and the
    diffs equal the unsharded store's after every block; then the
    wire-lean workload stream (sequential value refs) through the async
    applier, and extract_all."""
    n_docs = 12
    plain, sharded = _mesh_pair(n_docs, n_dev, key_capacity=8,
                                actor_capacity=6)
    assert [len(p[0]) for p in sharded._planes] == [96 // n_dev] * n_dev
    for per_doc in _random_stream(11, n_docs, 4):
        pp = plain.apply_block(tblocks.ChangeBlock.from_changes(per_doc))
        sp = sharded.apply_block(tblocks.ChangeBlock.from_changes(per_doc))
        _same_store(plain, sharded)
        for name in OUTS:
            a, b = getattr(pp, name), getattr(sp, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert [pp.diffs(d) for d in range(n_docs)] == \
            [sp.diffs(d) for d in range(n_docs)]
    plain, sharded = _mesh_pair(n_docs, n_dev, key_capacity=16,
                                actor_capacity=8)
    for k in range(3):
        kw = dict(n_docs=n_docs, n_actors=4, ops_per_change=3, n_keys=12,
                  seed=k, del_p=0.2, seq0=k + 1)
        want = plain.apply_block(twork.gen_block_workload(**kw))
        got = sharded.apply_block_async(twork.gen_block_workload(**kw))
        got.block_until_ready()
        for name in OUTS:
            assert torch.equal(getattr(want, name), getattr(got, name))
    sharded.drain()
    _same_store(plain, sharded)
    assert plain.extract_all().to_patches() == \
        sharded.extract_all().to_patches()
    sharded.close()


def test_mesh_store_matches_the_references_sharded_store():
    import jax
    from automerge_tpu.device import blocks as jblocks
    from automerge_tpu.device import dense_store as jdense
    from automerge_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 4:
        pytest.skip('needs 4 host devices')
    n_docs = 8
    jstore = jdense.DenseMapStore(n_docs, key_capacity=8, actor_capacity=6,
                                  mesh=jmake_mesh(4))
    tstore = tdense.DenseMapStore(n_docs, key_capacity=8, actor_capacity=6,
                                  mesh=make_mesh(4, device='cpu'))
    for per_doc in _random_stream(12, n_docs, 3):
        jp = jstore.apply_block(jblocks.ChangeBlock.from_changes(per_doc))
        tp = tstore.apply_block(tblocks.ChangeBlock.from_changes(per_doc))
        _same_planes(jstore, tstore)
        _same_outs([getattr(jp, k) for k in OUTS],
                   [getattr(tp, k) for k in OUTS], OUTS)


def test_mesh_store_needs_whole_documents_per_entry():
    with pytest.raises(ValueError, match='10 docs do not divide over 4 '
                                         'devices'):
        tdense.DenseMapStore(10, mesh=make_mesh(4, device='cpu'))


def test_load_snapshot_onto_a_mesh():
    from automerge_tpu.device import dense_store as jdense
    from automerge_tpu.device import workloads as jwork
    n_docs = 8
    kw = dict(n_docs=n_docs, n_actors=3, ops_per_change=3, n_keys=10,
              seed=4, del_p=0.2)
    jstore = jdense.DenseMapStore(n_docs, key_capacity=16, actor_capacity=4)
    jstore.apply_block(jwork.gen_block_workload(**kw))
    mesh = make_mesh(4, device='cpu')
    for data in (jstore.save_snapshot(),
                 tdense.DenseMapStore.load_snapshot(
                     jstore.save_snapshot(), device='cpu').save_snapshot()):
        store = tdense.DenseMapStore.load_snapshot(data, mesh=mesh)
        assert len(store._planes) == 4
        _same_planes(jstore, store)
        assert store.extract_all().to_patches() == \
            jstore.extract_all().to_patches()
        nxt = dict(kw, seed=5, seq0=2)
        want = tdense.DenseMapStore.load_snapshot(data, device='cpu')
        want.apply_block(twork.gen_block_workload(**nxt))
        store.apply_block(twork.gen_block_workload(**nxt))
        _same_store(want, store)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_dense_store.py -m cuda)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n_docs', [16, 1024])
def test_cuda_store_matches_cpu_store(cuda_device, n_docs):
    kw = dict(key_capacity=64, actor_capacity=16)
    gpu = tdense.DenseMapStore(n_docs, device=cuda_device, **kw)
    cpu = tdense.DenseMapStore(n_docs, device='cpu', **kw)
    for k in range(2):
        wk = dict(n_docs=n_docs, n_actors=10, ops_per_change=10,
                  seed=k, del_p=0.1, seq0=k + 1)
        gp = gpu.apply_block(twork.gen_block_workload(**wk))
        cp = cpu.apply_block(twork.gen_block_workload(**wk))
        for name in PLANES:
            assert torch.equal(getattr(gpu, name).cpu(),
                               getattr(cpu, name)), name
        _same_outs([getattr(cp, k) for k in OUTS],
                   [getattr(gp, k) for k in OUTS], OUTS)
    assert gpu.extract_all().to_patches() == cpu.extract_all().to_patches()
