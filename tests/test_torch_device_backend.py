"""The per-doc device backend and DeviceDocSet of the PyTorch port, on
``device='cpu'`` (the kernels' plain versions): held against the port's
host oracle (materialized documents and conflicts through the port's
frontend) and against the JAX package's ``DeviceBackend`` (the patches,
exact JSON equality) on the same changes, minted by the port's frontend.
Scenarios from ``tests/test_device_backend.py`` and
``tests/test_device_sequences.py`` (those that need ``Connection`` stay
with the wire/sync slice)."""

import random

import numpy as np
import pytest
import torch

from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.device import backend as DeviceBackend
from automerge_tpu_torch.device import general_backend as GB
from automerge_tpu_torch.sync import DeviceDocSet, DocSet
from automerge_tpu_torch.text import Text

torch.set_num_threads(1)

CPU = DeviceBackend.for_device('cpu')


def _materialize(doc):
    def conv(obj):
        name = type(obj).__name__
        if name == 'Text':
            return ''.join(str(c) for c in obj)
        if name == 'AmList':
            return [conv(v) for v in obj]
        if hasattr(obj, '_conflicts'):
            return {k: conv(v) for k, v in obj.items()}
        return obj
    return conv(doc)


def _conflicts_of(doc):
    def conv(obj):
        name = type(obj).__name__
        out = {}
        if hasattr(obj, '_conflicts'):
            out['.'] = obj._conflicts
            items = obj.items() if name not in ('AmList', 'Text') else \
                enumerate(obj)
            for k, v in items:
                sub = conv(v)
                if sub:
                    out[k] = sub
        return out
    return conv(doc)


def _frontend_doc(actor, *edits, base=()):
    doc = Frontend.init({'backend': Backend})
    doc = Frontend.set_actor_id(doc, actor)
    if base:
        state, patch = Backend.apply_changes(
            Frontend.get_backend_state(doc), list(base))
        patch['state'] = state
        doc = Frontend.apply_patch(doc, patch)
    for e in edits:
        doc, _ = Frontend.change(doc, e)
    return doc


def _changes(actor, *edits, base=()):
    return Backend.get_changes_for_actor(
        Frontend.get_backend_state(_frontend_doc(actor, *edits, base=base)),
        actor)


def _via_oracle(changes):
    state, _ = Backend.apply_changes(Backend.init(), changes)
    return Frontend.apply_patch(Frontend.init('viewer'),
                                Backend.get_patch(state))


def _via_device(changes, incremental=False):
    state = CPU.init()
    doc = Frontend.init({'backend': CPU})
    patches = []
    for batch in ([[c] for c in changes] if incremental else [changes]):
        state, patch = DeviceBackend.apply_changes(state, batch)
        patches.append({k: v for k, v in patch.items()})
        patch['state'] = state
        doc = Frontend.apply_patch(doc, patch)
    return doc, state, patches


def _jax_patches(changes, incremental=False):
    from automerge_tpu.device import backend as JaxDeviceBackend
    state = JaxDeviceBackend.init()
    out = []
    for batch in ([[c] for c in changes] if incremental else [changes]):
        state, patch = JaxDeviceBackend.apply_changes(state, batch)
        out.append(patch)
    return out, JaxDeviceBackend.get_patch(state)


def assert_equivalent(changes, jax_too=True, incremental_too=True):
    """Port device backend == port oracle (documents, conflicts, the
    get_patch rebuild) and, with ``jax_too``, == the JAX DeviceBackend's
    patches; single-shot and change by change."""
    oracle = _via_oracle(changes)
    modes = (False, True) if incremental_too else (False,)
    for inc in modes:
        doc, state, patches = _via_device(changes, incremental=inc)
        assert _materialize(doc) == _materialize(oracle)
        assert _conflicts_of(doc) == _conflicts_of(oracle)
        if jax_too:
            want, want_full = _jax_patches(changes, incremental=inc)
            assert patches == want
            assert DeviceBackend.get_patch(state) == want_full
    rebuilt = Frontend.apply_patch(Frontend.init('viewer'),
                                   DeviceBackend.get_patch(state))
    assert _materialize(rebuilt) == _materialize(oracle)
    return doc, state


# -- maps --------------------------------------------------------------------

def _fork(base, actor, *edits):
    return _changes(actor, *edits, base=base)


def _map_conflict():
    return (_changes('actor-00', lambda d: d.__setitem__('k', 1))
            + _changes('actor-01', lambda d: d.__setitem__('k', 2))
            + _changes('actor-02', lambda d: d.__setitem__('k', 3)))


def _map_delete():
    return _changes('aa', lambda d: d.update({'k': 1, 'keep': 2}),
                    lambda d: d.__delitem__('k'))


def _map_set_vs_delete():
    base = _changes('base', lambda d: d.__setitem__('x', 'orig'))
    return (base + _fork(base, 'deleter', lambda d: d.__delitem__('x'))
            + _fork(base, 'writer', lambda d: d.__setitem__('x', 'new')))


def _map_nested_links():
    return _changes('aa', lambda d: d.__setitem__(
        'config', {'theme': {'color': 'red'}, 'depth': 2}),
        lambda d: d['config']['theme'].__setitem__('color', 'blue'),
        lambda d: d.__setitem__('config', {'fresh': True}))


def _map_causal_chain():
    a = _changes('aa', lambda d: d.__setitem__('x', 1))
    b = _fork(a, 'bb', lambda d: d.__setitem__('x', 2))
    return a + b


MAPS = {'conflict': _map_conflict, 'delete': _map_delete,
        'set_vs_delete': _map_set_vs_delete,
        'nested_links': _map_nested_links, 'causal_chain': _map_causal_chain}


@pytest.mark.parametrize('name', sorted(MAPS))
def test_map_scenarios(name):
    changes = MAPS[name]()
    doc, _ = assert_equivalent(changes)
    if name == 'conflict':
        assert doc['k'] == 3
        assert doc._conflicts['k'] == {'actor-00': 1, 'actor-01': 2}
    if name == 'causal_chain':       # reversed delivery buffers, then applies
        doc, _ = assert_equivalent(changes[::-1], incremental_too=False)
        assert doc['x'] == 2 and 'x' not in doc._conflicts


def test_duplicate_and_out_of_order_delivery():
    c1, c2 = _changes('aa', lambda d: d.__setitem__('x', 1),
                      lambda d: d.__setitem__('y', 2))
    state, patch = DeviceBackend.apply_changes(CPU.init(), [c2])
    assert patch['diffs'] == []
    assert DeviceBackend.get_missing_deps(state) == {'aa': 1}
    state, patch = DeviceBackend.apply_changes(state, [c1])
    assert {d.get('key') for d in patch['diffs']} == {'x', 'y'}
    assert DeviceBackend.get_missing_deps(state) == {}
    state, patch = DeviceBackend.apply_changes(state, [c1, c2])
    assert patch['diffs'] == []
    assert DeviceBackend.get_missing_changes(state, {'aa': 1}) == [c2]
    assert DeviceBackend.get_changes_for_actor(state, 'aa') == [c1, c2]


def test_local_change_undo_redo_and_merge():
    doc = Frontend.init({'backend': CPU})
    doc = Frontend.set_actor_id(doc, 'local-1')
    doc, _ = Frontend.change(doc, lambda d: d.__setitem__('msg', 'hi'))
    doc, _ = Frontend.change(doc, lambda d: d.__setitem__('msg', 'bye'))
    assert doc['msg'] == 'bye'
    state = Frontend.get_backend_state(doc)
    assert state.clock == {'local-1': 2} and state.device.type == 'cpu'
    doc, _ = Frontend.undo(doc)
    assert doc['msg'] == 'hi' and Frontend.can_redo(doc)
    doc, _ = Frontend.redo(doc)
    assert doc['msg'] == 'bye'
    other, _ = DeviceBackend.apply_changes(
        CPU.init(), _changes('zz', lambda d: d.__setitem__('msg', 'zz')))
    merged, patch = DeviceBackend.merge(Frontend.get_backend_state(doc),
                                        other)
    assert patch['diffs'][0]['value'] == 'zz'
    with pytest.raises(ValueError, match='nothing to be undone'):
        DeviceBackend.apply_local_change(
            CPU.init(), {'requestType': 'undo', 'actor': 'a', 'seq': 1,
                         'deps': {}})


# -- lists and text ---------------------------------------------------------

def _list_insert_delete():
    return _changes('aa', lambda d: d.__setitem__('items', ['a', 'b', 'c']),
                    lambda d: d['items'].insert(1, 'x'),
                    lambda d: d['items'].__delitem__(0),
                    lambda d: d['items'].__setitem__(1, 'B'))


def _list_concurrent_inserts():
    base = _changes('base', lambda d: d.__setitem__('items', ['m']))
    return (base + _fork(base, 'aaaa', lambda d: d['items'].insert(0, 'A'))
            + _fork(base, 'bbbb', lambda d: d['items'].insert(0, 'B')))


def _list_set_vs_delete():
    base = _changes('base', lambda d: d.__setitem__('items', ['a', 'b', 'c']))
    return (base + _fork(base, 'deleter', lambda d: d['items'].__delitem__(1))
            + _fork(base, 'setter', lambda d: d['items'].__setitem__(1, 'B!')))


def _list_of_maps():
    return _changes('aa', lambda d: d.__setitem__(
        'cards', [{'title': 'one', 'done': False}]),
        lambda d: d['cards'].append({'title': 'two', 'done': True}),
        lambda d: d['cards'][0].__setitem__('done', True),
        lambda d: d['cards'].__delitem__(1))


def _text_splice():
    return _changes('aa', lambda d: d.__setitem__('text', Text()),
                    lambda d: d['text'].insert_at(0, *'hello'),
                    lambda d: d['text'].insert_at(5, '!'),
                    lambda d: d['text'].delete_at(1, 3))


def _text_concurrent():
    base = _changes('base', lambda d: d.__setitem__('text', Text()),
                    lambda d: d['text'].insert_at(0, *'ab'))
    return (base + _fork(base, 'aaaa', lambda d: d['text'].insert_at(1, 'X'))
            + _fork(base, 'bbbb', lambda d: d['text'].insert_at(1, 'Y')))


def _random_splices(seed=3):
    rng = random.Random(seed)
    base = _changes('base', lambda d: d.__setitem__(
        'items', [str(i) for i in range(5)]))

    def random_edits(tag):
        def one(d):
            items = d['items']
            for k in range(rng.randint(1, 4)):
                roll = rng.random()
                n = len(items)
                if roll < 0.5 or n == 0:
                    items.insert(rng.randint(0, n), f'{tag}{k}')
                elif roll < 0.75:
                    del items[rng.randrange(n)]
                else:
                    items[rng.randrange(n)] = f'{tag}set{k}'
        return one

    changes = base + [c for i in range(3)
                      for c in _fork(base, f'actor-{i}',
                                     random_edits(f'f{i}'))]
    rng.shuffle(changes)
    return changes


SEQS = {'list_insert_delete': _list_insert_delete,
        'list_concurrent_inserts': _list_concurrent_inserts,
        'list_set_vs_delete': _list_set_vs_delete,
        'list_of_maps': _list_of_maps, 'text_splice': _text_splice,
        'text_concurrent': _text_concurrent,
        'random_splices': _random_splices}


@pytest.mark.parametrize('name', sorted(SEQS))
def test_sequence_scenarios(name):
    doc, _ = assert_equivalent(SEQS[name]())
    if name == 'list_concurrent_inserts':
        assert _materialize(doc)['items'] == ['B', 'A', 'm']
    if name == 'list_set_vs_delete':
        assert _materialize(doc)['items'] == ['a', 'B!', 'c']
    if name == 'text_splice':
        assert _materialize(doc)['text'] == 'ho!'


# -- DeviceDocSet -----------------------------------------------------------

def test_docset_mixed_batch_matches_oracle_and_jax():
    from automerge_tpu.device import backend as JaxDeviceBackend
    docs = {'maps': _map_conflict(), 'nested': _map_nested_links(),
            'list': _list_insert_delete(), 'text': _text_concurrent()}
    dds = DeviceDocSet(device='cpu')
    assert dds.device.type == 'cpu'
    dds.apply_changes_batch(docs)
    ods = DocSet()
    for doc_id, chs in docs.items():
        ods.apply_changes(doc_id, chs)
    _, jpatches = JaxDeviceBackend.apply_changes_batch(
        [JaxDeviceBackend.init() for _ in docs], list(docs.values()))
    _, patches = DeviceBackend.apply_changes_batch(
        [CPU.init() for _ in docs], list(docs.values()))
    assert patches == jpatches
    for doc_id in docs:
        d, o = dds.get_doc(doc_id), ods.get_doc(doc_id)
        assert _materialize(d) == _materialize(o)
        assert _conflicts_of(d) == _conflicts_of(o)
        state = Frontend.get_backend_state(d)
        assert isinstance(state, DeviceBackend.DeviceBackendState)
        assert state.device.type == 'cpu'
    # a second batch extends the same documents
    more = {'list': _fork(docs['list'], 'zz',
                          lambda d: d['items'].append('tail')),
            'maps': _fork(docs['maps'], 'zz', lambda d: d.__setitem__('k', 0))}
    dds.apply_changes_batch(more)
    for doc_id, chs in more.items():
        ods.apply_changes(doc_id, chs)
        assert _materialize(dds.get_doc(doc_id)) == \
            _materialize(ods.get_doc(doc_id))


def test_docset_set_doc_stays_on_the_oracle():
    doc = _frontend_doc('host-actor', lambda d: d.__setitem__('x', 1))
    dds = DeviceDocSet(device='cpu')
    dds.set_doc('d1', doc)
    dds.apply_changes('d1', _changes('other', lambda d: d.__setitem__('y', 2)))
    out = dds.get_doc('d1')
    assert out['x'] == 1 and out['y'] == 2
    assert isinstance(Frontend.get_backend_state(out), Backend.BackendState)
    migrated = dds.migrate_doc('d1')
    assert _materialize(migrated) == {'x': 1, 'y': 2}
    assert isinstance(Frontend.get_backend_state(migrated),
                      DeviceBackend.DeviceBackendState)


def test_bulk_route_then_local_change_through_to_device_state():
    n = 1500
    changes = _changes('bulk', lambda d: d.__setitem__(
        'items', list(range(n))))
    assert sum(len(c['ops']) for c in changes) >= 3000
    state, _ = DeviceBackend.apply_changes(CPU.init(), changes)
    assert isinstance(state, GB.GeneralBackendState)
    assert state.store.device.type == 'cpu'
    dev = GB.to_device_state(state)
    assert isinstance(dev, DeviceBackend.DeviceBackendState)
    assert dev.device.type == 'cpu'
    assert DeviceBackend.get_patch(dev)['diffs'] == \
        GB.get_patch(state)['diffs']
    obj = next(d['obj'] for d in GB.get_patch(state)['diffs']
               if d.get('action') == 'create')
    elem = dev.objects[obj].elem_ids[0]
    local = {'requestType': 'change', 'actor': 'bulk', 'seq': 2,
             'deps': {}, 'ops': [{'action': 'set', 'obj': obj, 'key': elem,
                                  'value': 'first'}]}
    _, p = DeviceBackend.apply_local_change(dev, local)
    assert p['diffs'][0]['index'] == 0 and p['diffs'][0]['value'] == 'first'
    assert p['canUndo']
    # a historical token's patch replays through the per-doc backend
    state2, _ = DeviceBackend.apply_changes(
        state, [{'actor': 'other', 'seq': 1, 'deps': {'bulk': 1},
                 'ops': [{'action': 'set', 'obj': obj, 'key': elem,
                          'value': 'x'}]}])
    assert GB.get_patch(state)['diffs'] == \
        DeviceBackend.get_patch(dev)['diffs']
    assert GB.get_patch(state2)['clock'] == {'bulk': 1, 'other': 1}


def test_device_choice_is_explicit():
    with pytest.raises(ValueError, match='one batch runs on one device'):
        DeviceBackend.apply_changes_batch(
            [CPU.init(), DeviceBackend.DeviceBackendState(
                torch.device('meta'))], [[], []])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            DeviceBackend.init()
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            DeviceDocSet()
    assert CPU.init().device == torch.device('cpu')
    assert CPU.apply_changes is DeviceBackend.apply_changes


def test_fused_step_visibility_matches_np_reference():
    """The fused step's scatter-any of survivors into the job planes
    (the reference's ``.at[].max(mode='drop')``) on a hand-built batch."""
    rng = np.random.default_rng(1)
    k, m = 3, 8
    row_slot = np.array([[0, 1, 9, -1, 23, 23]], np.int32)
    seg = np.array([[0, 1, 2, 3, 4, 4]], np.int32)
    actor = np.array([[0, 0, 0, 0, 0, 1]], np.int32)
    seq = np.ones((1, 6), np.int32)
    clock = np.zeros((1, 6, 2), np.int32)
    is_del = np.array([[False, True, False, False, True, False]])
    valid = np.ones((1, 6), bool)
    parent = np.zeros((k, m), np.int32)
    parent[:, 1:] = np.arange(m - 1)
    prior = rng.random((k, m)) < 0.5
    s_valid = np.ones((k, m), bool)
    out, visible, ordered = DeviceBackend._fused_step(
        *(torch.as_tensor(a) for a in (seg, actor, seq, clock, is_del, valid,
                                       row_slot, parent, parent, parent * 0,
                                       prior, s_valid)), num_segments=8)
    want = prior.copy().reshape(-1)
    surv = out['surviving'].numpy()[0]
    for j, slot in enumerate(row_slot[0]):
        if slot >= 0:
            want[slot] = False
    for j, slot in enumerate(row_slot[0]):
        if slot >= 0 and surv[j]:
            want[slot] = True
    assert np.array_equal(visible.numpy().reshape(-1), want)
    assert ordered['vis_index'].dtype == torch.int32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_device_backend.py -m cuda)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_docset_launches_both_kernels_and_matches_cpu(cuda_device):
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    maps = {'maps': _map_conflict(), 'nested': _map_nested_links()}
    seqs = {'list': _list_insert_delete(), 'text': _text_concurrent(),
            'mixed': _map_delete()}
    gpu, cpu = DeviceDocSet(), DeviceDocSet(device='cpu')
    assert gpu.device.type == 'cuda'
    for batch, counter in ((maps, cuda_merge), (seqs, cuda_sequence)):
        before = sum(counter.launches.values())
        gpu.apply_changes_batch(batch)
        assert sum(counter.launches.values()) > before
        cpu.apply_changes_batch(batch)
    for doc_id in (*maps, *seqs):
        g, c = gpu.get_doc(doc_id), cpu.get_doc(doc_id)
        assert _materialize(g) == _materialize(c)
        assert _conflicts_of(g) == _conflicts_of(c)
