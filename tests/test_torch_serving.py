"""The serving layer: the PyTorch port's ``ServingDocSet`` (park
shards, eviction, fault-in, the memory budget, pin grace, crash
recovery) against the JAX package's.

One scripted drive runs on each package, the port's doc sets on the
CPU. After every step it records the views, the per-doc state digests,
the logical ``fleet_status`` totals and each document's residency
(resident, evicted or parked; last touch; estimated bytes), and the two
records must be equal: the budget reads ``doc_byte_estimates`` (a
logical estimate), so every park and evict decision is the
reference's, op for op. Then state carried across the packages: park
shards, a checkpoint and a journal written by the JAX package's serving
stack recover and fault in on the port's."""

import os
import pickle
import subprocess
import sys

import pytest
import torch

from automerge_tpu_torch.common import ROOT_ID

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _rich_changes(i):
    obj = f'00000000-0000-4000-8000-{i:012x}'
    return [
        {'actor': f'w0-{i}', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeList', 'obj': obj},
            {'action': 'link', 'obj': ROOT_ID, 'key': 'items',
             'value': obj},
            {'action': 'ins', 'obj': obj, 'key': '_head', 'elem': 1},
            {'action': 'set', 'obj': obj, 'key': f'w0-{i}:1',
             'value': i}]},
        {'actor': f'w1-{i}', 'seq': 1, 'deps': {f'w0-{i}': 1},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                  'value': i}] + [
             {'action': 'set', 'obj': ROOT_ID, 'key': f'pad{k}',
              'value': 'x' * (i + k)} for k in range(i % 4)]}]


def _write(i, seq, key, value):
    return [{'actor': f'w1-{i}', 'seq': seq, 'deps': {f'w1-{i}': seq - 1},
             'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': key,
                      'value': value}]}]


def _packages(which):
    """(GeneralDocSet factory, ServingDocSet, DurableDocSet, canonical,
    metrics) of one package."""
    if which == 'jax':
        from automerge_tpu.durability import DurableDocSet
        from automerge_tpu.sync import GeneralDocSet, ServingDocSet
        from automerge_tpu.sync.chaos import canonical
        from automerge_tpu.utils.metrics import metrics
        return GeneralDocSet, ServingDocSet, DurableDocSet, canonical, \
            metrics, {}
    from automerge_tpu_torch.durability import DurableDocSet
    from automerge_tpu_torch.sync import GeneralDocSet, ServingDocSet
    from automerge_tpu_torch.sync.chaos import canonical
    from automerge_tpu_torch.utils.metrics import metrics
    return (lambda cap: GeneralDocSet(cap, device='cpu')), ServingDocSet, \
        DurableDocSet, canonical, metrics, {'device': 'cpu'}


def _snap(ds, canonical):
    st = ds.fleet_status()
    per_doc = {d: {k: v.get(k) for k in ('state', 'last_touch',
                                          'resident_bytes', 'clock')}
               for d, v in st['docs'].items()}
    return {'totals': st['totals'], 'docs': per_doc,
            'memory': {k: st['memory'][k] for k in
                       ('resident_bytes', 'memory_budget_bytes')},
            'digests': ds.heartbeat_digests()}


def _drive(which, path, n_docs=10):
    Gds, Serving, Durable, canonical, metrics, dev = _packages(which)
    metrics.reset()
    out = []
    inner = Gds(32)
    inner.apply_changes_batch(
        {f'doc{i}': _rich_changes(i) for i in range(n_docs)})
    ds = Serving(Durable(inner, str(path)), str(path), shard_docs=3,
                 check_every=4)
    ds.checkpoint()
    out.append(('seeded', _snap(ds, canonical)))
    # budget: half the fleet's estimate, LRU over the touch ticks
    total = ds.fleet_status()['totals']['resident_bytes']
    for i in (0, 3, 6):
        ds.materialize(f'doc{i}')
        ds.tick()
    ds.memory_budget_bytes = total // 2
    ds.tick()
    ds.tick()
    out.append(('budget', _snap(ds, canonical)))
    # fault-in by a write, by a read, by a batch
    ds.apply_changes('doc1', _write(1, 2, 'new', 'x'))
    out.append(('write', canonical(ds.materialize('doc1'))))
    out.append(('read', canonical(ds.materialize('doc9'))))
    ds.apply_changes_batch({'doc2': _write(2, 2, 'b', 1),
                            'doc8': _write(8, 2, 'b', 2)})
    ds.tick()
    out.append(('faulted', _snap(ds, canonical)))
    # pin grace: a doc written every quantum stays resident under a
    # one-byte budget; two idle quanta age the pin and it parks
    ds.memory_budget_bytes = 1
    for seq in range(3, 6):
        ds.apply_changes('doc4', _write(4, seq, 'hot', seq))
        ds.tick()
        out.append(('pinned', _snap(ds, canonical)['docs']['doc4']))
    ds.tick()
    ds.tick()
    out.append(('aged', _snap(ds, canonical)))
    # checkpoint while evicted: the shards are the only durable copy
    ds.checkpoint()
    ds.apply_changes('doc5', _write(5, 2, 'post', 9))
    ds.memory_budget_bytes = None
    out.append(('views', {d: canonical(ds.materialize(d))
                          for d in ds.doc_ids}))
    out.append(('all', _snap(ds, canonical)))
    ds.memory_budget_bytes = 1
    ds.tick()
    ds.tick()
    ds.close()
    rec = Serving.recover(str(path), capacity=32, **dev)
    out.append(('recovered', _snap(rec, canonical)))
    out.append(('recovered_views', {d: canonical(rec.materialize(d))
                                    for d in rec.doc_ids}))
    out.append(('after', _snap(rec, canonical)))
    rec.close()
    return out


def _reference_drive(path):
    """:func:`_drive` on the JAX package in a fresh interpreter: its
    XLA programs hold thousands of memory maps (one process may hold
    65,530, vm.max_map_count), which leave with the subprocess instead
    of crowding the worker that runs the next test files."""
    code = ('import pickle, sys; sys.path[:0] = sys.argv[1:3]; '
            'import test_torch_serving as t; '
            'sys.stdout.buffer.write(pickle.dumps(t._drive("jax", '
            'sys.argv[3])))')
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               JAX_COMPILATION_CACHE_DIR=os.path.join(ROOT, '.jax_cache'),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS='0.5')
    done = subprocess.run(
        [sys.executable, '-c', code, ROOT, os.path.join(ROOT, 'tests'),
         str(path)], capture_output=True, env=env, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stderr.decode()[-4000:]
    return pickle.loads(done.stdout)


def test_serving_drive_matches_reference(tmp_path):
    want = _reference_drive(tmp_path / 'jax')
    got = _drive('port', tmp_path / 'port')
    assert [k for k, _ in got] == [k for k, _ in want]
    for (step, g), (_, w) in zip(got, want):
        assert g == w, step
    budget = dict(got)['budget']['totals']
    assert 0 < budget['evicted'] < 10 and budget['evictions'] > 0
    assert dict(got)['faulted']['totals']['fault_ins'] >= 3
    assert all(s['state'] == 'resident'
               for k, s in got if k == 'pinned')
    assert dict(got)['aged']['docs']['doc4']['state'] == 'evicted'
    assert dict(got)['recovered']['totals']['evicted'] == 10


def test_reference_park_shards_fault_in_on_the_port(tmp_path):
    """The JAX package's serving stack checkpoints, parks every doc and
    crashes; the port's ``recover`` loads its snapshot, journal and
    park shards onto the CPU and faults each doc in to the reference's
    views."""
    Gds, Serving, Durable, canonical, metrics, _ = _packages('jax')
    from automerge_tpu_torch.sync import ServingDocSet
    from automerge_tpu_torch.sync.chaos import canonical as tcanonical
    inner = Gds(32)
    inner.apply_changes_batch(
        {f'doc{i}': _rich_changes(i) for i in range(6)})
    ds = Serving(Durable(inner, str(tmp_path)), str(tmp_path))
    ds.checkpoint()
    ds.memory_budget_bytes = 1
    ds.tick()
    ds.tick()
    ds.checkpoint()
    ds.apply_changes('doc2', _write(2, 2, 'tail', 7))   # journal tail
    ds.tick()
    ds.tick()
    want = {d: canonical(ds.materialize(d)) for d in ds.doc_ids}
    digests = ds.heartbeat_digests()
    ds.close()
    rec = ServingDocSet.recover(str(tmp_path), capacity=32, device='cpu')
    assert rec.inner.device.type == 'cpu'
    st = rec.fleet_status()
    assert sum(1 for v in st['docs'].values()
               if v['state'] == 'evicted') == 6
    got = {d: tcanonical(rec.materialize(d)) for d in rec.doc_ids}
    assert got == want and rec.materialize('doc2')['tail'] == 7
    assert rec.heartbeat_digests() == digests
    assert rec.fleet_status()['totals']['fault_ins'] == 6
    rec.close()


def test_recover_resolves_its_device(tmp_path):
    from automerge_tpu_torch.sync import ServingDocSet
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ServingDocSet.recover(str(tmp_path), capacity=4)
