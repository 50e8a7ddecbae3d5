"""The public facade of the PyTorch port against ``automerge_tpu``'s.

The same seeded edits go through both facades: ``init``, ``change``,
``merge``, ``diff``, ``undo``/``redo``, ``save``/``load``,
``get_history``, ``get_changes``/``apply_changes``,
``get_missing_deps``, ``equals``, ``inspect`` and the conflicts, on
host-oracle documents (built on ``Backend`` by name) and on the
device-backed documents that the port's ``init``/``load`` make (here
with ``device='cpu'``), where the facade sends each state to the device
backend bound to the device it records.
Also ``interop.load_reference_save`` and the background-thread backend
(``frontend.worker.BackendWorker``).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import automerge_tpu as jam
import automerge_tpu_torch as tam
from automerge_tpu import interop as jinterop
from automerge_tpu_torch import interop
from automerge_tpu_torch.device import backend as DeviceBackend
from automerge_tpu_torch.frontend.worker import BackendWorker

from chip_smoke import doc_view as _doc_view

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'reference_save.transit.json')


def _script(seed):
    """A seeded list of edits, each a function of a facade module and
    a document proxy: map sets and deletes, a list, a text, nested
    maps."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(8):
        k = f'k{int(rng.integers(0, 4))}'
        kind = int(rng.integers(0, 5))
        v = int(rng.integers(0, 100))
        if kind == 0:
            steps.append(lambda am, d, k=k, v=v: d.__setitem__(k, v))
        elif kind == 1:
            steps.append(lambda am, d, k=k: d.__delitem__(k)
                         if k in d else d.__setitem__(k, None))
        elif kind == 2:
            steps.append(lambda am, d, v=v: d.__setitem__(
                'list', [v, v + 1]) if 'list' not in d
                else d['list'].insert_at(0, v))
        elif kind == 3:
            steps.append(lambda am, d, v=v: d.__setitem__(
                'text', am.Text()) if 'text' not in d
                else d['text'].insert_at(0, chr(97 + v % 26)))
        else:
            steps.append(lambda am, d, v=v: d.__setitem__(
                'nested', {'a': {'b': v}}))
    return steps


def _plain(x):
    """Values of either package as plain Python (a Text becomes its
    string, a list or map proxy a list or dict)."""
    name = type(x).__name__
    if name == 'Text':
        return ('text', ''.join(str(c) for c in x))
    if isinstance(x, dict) or hasattr(x, '_conflicts') and \
            hasattr(x, 'items') and name != 'AmList':
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) or name == 'AmList':
        return [_plain(v) for v in x]
    return x


def doc_view(doc):
    return _plain(_doc_view(doc))


def _counter():
    """Object ids from a counter, so two facades' diffs name the same
    objects."""
    import itertools
    n = itertools.count()
    return lambda: f'00000000-0000-4000-8000-{next(n):012x}'


@pytest.fixture(autouse=True)
def _restore_uuids():
    yield
    jam.uuid.reset()
    tam.uuid.reset()


def _on(am, backend):
    """A maker of empty documents of facade ``am`` on ``backend``."""
    return lambda actor: am.Frontend.init({'actorId': actor,
                                           'backend': backend})


def _tam_init(actor):
    return tam.init(actor, device='cpu')


def _tam_load(data, actor):
    return tam.load(data, actor, device='cpu')


def _run(am, new, load, seed, actors=('aaaa-1', 'bbbb-2')):
    """Two documents made by ``new(actor)`` edit concurrently through the
    facade ``am`` and merge both ways; ``load(data, actor)`` reads back
    what ``am.save`` wrote. Returns every intermediate result worth
    comparing."""
    am.uuid.set_factory(_counter())
    out = {}
    a, b = new(actors[0]), new(actors[1])
    base = a
    for step in _script(seed)[:3]:
        a = am.change(a, lambda d, s=step: s(am, d))
    b = am.merge(b, a)
    for step in _script(seed + 1):
        a = am.change(a, lambda d, s=step: s(am, d))
    for step in _script(seed + 2):
        b = am.change(b, lambda d, s=step: s(am, d))
    b = am.change(b, lambda d: d.__setitem__('k0', 'from b'))
    a = am.change(a, lambda d: d.__setitem__('k0', 'from a'))
    out['diff'] = am.diff(base, a)
    out['changes'] = am.get_changes(base, a)
    ab, ba = am.merge(a, b), am.merge(b, a)
    out['ab'], out['ba'] = doc_view(ab), doc_view(ba)
    out['equals'] = am.equals(ab, ba)
    out['inspect'] = am.inspect(ab)
    out['conflicts'] = _plain(dict(am.get_conflicts(ab)))
    u = am.undo(a)
    out['undo'] = (doc_view(u), am.can_undo(u), am.can_redo(u))
    r = am.redo(u)
    out['redo'] = doc_view(r)
    out['empty'] = doc_view(am.empty_change(ab, 'nothing'))
    hist = am.get_history(ab)
    out['history'] = [(h.change['actor'], h.change['seq']) for h in hist]
    out['history_doc'] = doc_view(hist[2].snapshot)
    gap = am.apply_changes(new('cccc-3'), out['changes'][1:])
    out['missing'] = am.get_missing_deps(gap)
    out['load'] = doc_view(load(am.save(ab), 'dddd-4'))
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_oracle_documents_equal_the_jax_facade(seed):
    got = _run(tam, _on(tam, tam.Backend), _tam_load, seed)
    want = _run(jam, jam.init, jam.load, seed)
    assert got == want
    assert got['ab'] == got['ba'] and got['equals']
    assert got['missing']


def test_device_documents_equal_the_jax_facade():
    from automerge_tpu.device import backend as JDeviceBackend
    got = _run(tam, _tam_init, _tam_load, 3)
    want = _run(jam, _on(jam, JDeviceBackend), jam.load, 3)
    assert got == want
    # and equal the host-oracle documents of the same edits (the device
    # backend's diffs are a compaction of the oracle's diff stream, so
    # only what they build is compared)
    oracle = _run(tam, _on(tam, tam.Backend), _tam_load, 3)
    assert {k: v for k, v in oracle.items() if k != 'diff'} \
        == {k: v for k, v in got.items() if k != 'diff'}


def test_facade_routes_device_states_to_their_device():
    doc = tam.change(tam.init('aaaa-1', device='cpu'),
                     lambda d: d.__setitem__('x', 1))
    state = tam.Frontend.get_backend_state(doc)
    bound = tam._backend_of(state)
    assert bound.device == state.device and state.device.type == 'cpu'
    for made in (tam.load(tam.save(doc), 'cccc-3', device='cpu'),
                 tam.doc_from_changes('dddd-4', tam.get_changes(
                     tam.init('eeee-5', device='cpu'), doc), device='cpu'),
                 tam.get_history(doc)[0].snapshot):
        assert tam.Frontend.get_backend_state(made).device.type == 'cpu'
        assert made['x'] == 1
    oracle = _on(tam, tam.Backend)('bbbb-2')
    assert tam._backend_of(tam.Frontend.get_backend_state(oracle)) \
        is tam.Backend
    # the entry points' default is the card: without one they raise
    defaults = (lambda: tam.init('ffff-6'),
                lambda: tam.load(tam.save(doc), 'ffff-6'),
                lambda: tam.doc_from_changes('ffff-6', []))
    for make in defaults:
        if torch.cuda.is_available():
            assert tam.Frontend.get_backend_state(make()).device.type \
                == 'cuda'
        else:
            with pytest.raises(RuntimeError, match='CUDA is not available'):
                make()
    for name in ('GeneralDocSet', 'GeneralStore', 'init_store', 'Options',
                 'DocSet', 'WatchableDoc', 'Connection', 'MessageRejected',
                 'ResilientConnection', 'save_snapshot', 'load_snapshot',
                 'applyChanges', 'getHistory', 'uuid', 'Text'):
        assert hasattr(tam, name), name


def test_reference_save_interop():
    with open(FIXTURE, 'rb') as f:
        blob = f.read()
    changes = interop.load_reference_save(blob)
    assert changes == jinterop.load_reference_save(blob)
    ds = tam.GeneralDocSet(1, device='cpu')
    ds.apply_changes('imported', changes)
    assert ds.materialize('imported') == {
        'cards': [{'title': 'hello card'}], 'title': 'hi'}
    with pytest.raises(interop.ReferenceSaveError):
        interop.load_reference_save(b'{"not": "transit"}')
    doc = tam.apply_changes(tam.init('eeee-5', device='cpu'), changes)
    assert json.loads(json.dumps(tam.inspect(doc)))['title'] == 'hi'


def _pump(doc, worker, timeout=10.0):
    deadline = time.time() + timeout
    while True:
        for patch in worker.poll_patches(timeout=0.05):
            doc = tam.Frontend.apply_patch(doc, patch)
        if not doc._state['requests']:
            return doc
        if time.time() > deadline:
            raise TimeoutError('request queue never drained')


@pytest.mark.parametrize('device', [False, True], ids=['oracle', 'device'])
def test_background_worker(device):
    backend = DeviceBackend.for_device('cpu') if device else tam.Backend
    worker = BackendWorker(backend)
    doc = tam.Frontend.init('aaaa-ui')
    remote = tam.change(tam.init('zzzz-remote', device='cpu'),
                        lambda d: d.__setitem__('remote_key', 'remote'))
    remote_changes = tam.get_changes(tam.init('yyyy-0', device='cpu'),
                                     remote)
    doc, r1 = tam.Frontend.change(doc, lambda d: d.__setitem__('a', 1))
    worker.submit_request(r1)
    worker.submit_changes(remote_changes)
    doc, r2 = tam.Frontend.change(doc, lambda d: d.update({'a': 10,
                                                          'c': 3}))
    worker.submit_request(r2)
    doc = _pump(doc, worker)
    assert doc_view(doc)[0] == {'a': 10, 'c': 3, 'remote_key': 'remote'}
    replay = tam.apply_changes(tam.init('viewer', device='cpu'),
                               worker.get_changes({}))
    assert doc_view(replay)[0] == doc_view(doc)[0]
    worker.close()
