"""The host oracle of the PyTorch port (``automerge_tpu_torch.backend``)
against the JAX package's (``automerge_tpu.backend``): the same changes
give the same patches, whole-document patches, change-log answers and
undo/redo patches — exact JSON equality. Changes are minted by the
port's frontend; both oracles are pure host code."""

import pytest

from automerge_tpu import backend as JaxBackend
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.common import ROOT_ID
from automerge_tpu_torch.text import Text


def _changes(actor, *edits, base=()):
    doc = Frontend.init({'backend': Backend})
    doc = Frontend.set_actor_id(doc, actor)
    if base:
        state, patch = Backend.apply_changes(
            Frontend.get_backend_state(doc), list(base))
        patch['state'] = state
        doc = Frontend.apply_patch(doc, patch)
    for e in edits:
        doc, _ = Frontend.change(doc, e)
    return Backend.get_changes_for_actor(Frontend.get_backend_state(doc),
                                         actor)


def _scenario(name):
    if name == 'maps':
        base = _changes('base', lambda d: d.update(
            {'x': 1, 'cfg': {'theme': 'red'}}))
        return (base + _changes('aa', lambda d: d.__setitem__('x', 2),
                                base=base)
                + _changes('zz', lambda d: d.__delitem__('x'),
                           lambda d: d['cfg'].__setitem__('theme', 'blue'),
                           base=base))
    if name == 'lists':
        base = _changes('base', lambda d: d.__setitem__('items', ['a', 'b']))
        return (base + _changes('aa', lambda d: d['items'].insert(1, 'x'),
                                base=base)
                + _changes('bb', lambda d: d['items'].__delitem__(0),
                           lambda d: d['items'].append({'k': 1}), base=base))
    base = _changes('base', lambda d: d.__setitem__('t', Text()),
                    lambda d: d['t'].insert_at(0, *'hello'))
    return (base + _changes('aa', lambda d: d['t'].insert_at(2, 'X'),
                            base=base)
            + _changes('bb', lambda d: d['t'].delete_at(1, 2), base=base))


@pytest.mark.parametrize('name', ['maps', 'lists', 'text'])
@pytest.mark.parametrize('order', ['forward', 'reversed'])
def test_patches_match_the_jax_oracle(name, order):
    changes = _scenario(name)
    if order == 'reversed':
        changes = changes[::-1]
    s, js = Backend.init(), JaxBackend.init()
    for c in changes:                      # one change at a time
        s, p = Backend.apply_changes(s, [c])
        js, jp = JaxBackend.apply_changes(js, [c])
        assert p == jp
        assert Backend.get_missing_deps(s) == JaxBackend.get_missing_deps(js)
    assert Backend.get_patch(s) == JaxBackend.get_patch(js)
    assert Backend.get_missing_changes(s, {'base': 1}) == \
        JaxBackend.get_missing_changes(js, {'base': 1})
    merged, mp = Backend.merge(Backend.init(), s)
    jmerged, jmp = JaxBackend.merge(JaxBackend.init(), js)
    assert mp == jmp


def test_local_change_undo_redo_match_the_jax_oracle():
    reqs = [
        {'requestType': 'change', 'actor': 'me', 'seq': 1, 'deps': {},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                  'value': 'v1'}]},
        {'requestType': 'change', 'actor': 'me', 'seq': 2, 'deps': {},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                  'value': 'v2'}]},
        {'requestType': 'undo', 'actor': 'me', 'seq': 3, 'deps': {}},
        {'requestType': 'redo', 'actor': 'me', 'seq': 4, 'deps': {}},
    ]
    s, js = Backend.init(), JaxBackend.init()
    for r in reqs:
        s, p = Backend.apply_local_change(s, r)
        js, jp = JaxBackend.apply_local_change(js, r)
        assert p == jp
    assert Backend.get_patch(s) == JaxBackend.get_patch(js)
    with pytest.raises(ValueError, match='already been applied'):
        Backend.apply_local_change(s, reqs[0])
