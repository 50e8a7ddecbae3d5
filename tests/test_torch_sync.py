"""The sync stack of the PyTorch port against the JAX package's.

* A JAX ``GeneralDocSet`` peer and a port ``GeneralDocSet(device='cpu')``
  peer hold divergent, concurrent edits of the same documents (same-key
  sets from two actors) and documents only one of them has; they
  converge over ``WireConnection`` v1, v2 and v3 and over
  ``ResilientConnection`` (wire v3 with session tables and acks) to
  equal per-document state digests and views, equal to a direct apply
  of every change.
* Duplicate and out-of-order wire delivery into the port: a duplicate
  is a no-op, a change that arrives before its dependency waits and
  applies when the dependency comes.
* ``Connection`` and ``BatchingConnection`` over the host-oracle
  ``DocSet`` and ``DeviceDocSet(device='cpu')`` against a JAX
  ``DocSet`` peer: equal documents.
* ``WatchableDoc`` calls its handlers as the reference's does.
"""

import pytest
import torch

import automerge_tpu.sync as J
import automerge_tpu_torch.sync as P
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.sync.connection import validate_wire_msg

from chip_smoke import ROOT_ID, doc_view
from test_torch_wire import seeded_docs

torch.set_num_threads(1)

N_SHARED, N_OWN = 5, 2


def _split(seed=0):
    """(JAX peer's changes, port peer's changes, all changes), by doc id:
    both peers hold every shared document's first change; the JAX peer
    adds the second actor's, the port the third's (concurrent, the same
    root key); each peer also holds documents of its own."""
    docs = seeded_docs(N_SHARED + 2 * N_OWN, seed)
    ids = [f'doc{d}' for d in range(len(docs))]
    jax_side, port_side = {}, {}
    for d in range(N_SHARED):
        jax_side[ids[d]] = [docs[d][0], docs[d][1]]
        port_side[ids[d]] = [docs[d][0], docs[d][2]]
    for d in range(N_SHARED, N_SHARED + N_OWN):
        jax_side[ids[d]] = docs[d]
        port_side[ids[d + N_OWN]] = docs[d + N_OWN]
    return jax_side, port_side, dict(zip(ids, docs))


def _peers(seed=0):
    jax_side, port_side, every = _split(seed)
    a = J.GeneralDocSet(16)
    b = P.GeneralDocSet(16, device='cpu')
    a.apply_changes_batch(jax_side)
    b.apply_changes_batch(port_side)
    return a, b, every


def _pump(ca, cb, ma, mb, rounds=60):
    for _ in range(rounds):
        for c in (ca, cb):
            if hasattr(c, 'flush'):
                c.flush()
        if not (ma or mb):
            return
        for src, dst in ((ma, cb), (mb, ca)):
            batch = src[:]
            src.clear()
            for m in batch:
                dst.receive_msg(m)
    raise AssertionError('the peers did not go quiet')


def _assert_converged(a, b, every):
    ids = sorted(every)
    oracle = P.GeneralDocSet(16, device='cpu')
    oracle.apply_changes_batch(every)
    want = dict(zip(ids, oracle.materialize_many(ids)))
    assert dict(zip(ids, a.materialize_many(ids))) == want
    assert dict(zip(ids, b.materialize_many(ids))) == want
    for doc_id in ids:
        digest = oracle.digest_of_id(doc_id)
        assert a.digest_of_id(doc_id) == digest, doc_id
        assert b.digest_of_id(doc_id) == digest, doc_id
    # the concurrent same-key set: the higher actor wins, the other
    # stays as a conflict, the same on both peers
    assert want['doc1']['n'] == -1


@pytest.mark.parametrize('version', [1, 2, 3])
def test_wire_connection_converges(version):
    a, b, every = _peers()
    ma, mb, sent = [], [], []
    ca = J.WireConnection(a, ma.append, wire_version=version)
    cb = P.WireConnection(b, lambda m: (sent.append(m), mb.append(m)),
                          wire_version=version)
    ca.open()
    cb.open()
    _pump(ca, cb, ma, mb)
    _assert_converged(a, b, every)
    data = [m for m in sent if sum(m.get('counts', ()))]
    assert data and all(m.get('wire', 1) == version for m in data)
    for m in data:
        validate_wire_msg(m)


def test_resilient_connection_converges():
    a, b, every = _peers(seed=1)
    conns = {}
    ca = J.ResilientConnection(a, lambda env: conns['b'].receive_msg(env),
                               wire=True, peer_id='b')
    cb = P.ResilientConnection(b, lambda env: conns['a'].receive_msg(env),
                               wire=True, peer_id='a')
    conns['a'], conns['b'] = ca, cb
    ca.open()
    cb.open()
    for _ in range(10):
        for c in (ca, cb):
            c.flush()
        for c in (ca, cb):
            c.tick()
    _assert_converged(a, b, every)
    assert cb.connection_status()['wire_version'] == 3


def _jax_wire(changes, version):
    """``changes`` of one document as the JAX package puts them on the
    wire: a v1 JSON payload or a columnar v3 container."""
    from automerge_tpu import wire as jwire
    block = J.GeneralDocSet(2).store.encode_changes([changes])
    rows = list(range(block.n_changes))
    if version == 1:
        return b'[[' + b','.join(jwire.encode_change_rows(block, rows)) + \
            b']]'
    spans, tab = jwire.assemble_columnar_spans(
        jwire.encode_change_rows_columnar_v3(block, rows))
    return jwire.build_columnar_container(
        [tab], [[(0, s) for s in spans]], version=3)


@pytest.mark.parametrize('version', [1, 3])
def test_duplicate_and_out_of_order_delivery(version):
    docs = seeded_docs(1, 4)[0]
    b = P.GeneralDocSet(8, device='cpu')
    # the second actor's change first: it waits for its dependency
    b.apply_wire(_jax_wire(docs[1:2], version), doc_ids=['d'])
    assert b.store.clock_of(b.id_of['d']) == {}
    assert b.store.get_missing_deps() == {'w0-0': 1}
    b.apply_wire(_jax_wire(docs[:1], version), doc_ids=['d'])
    assert set(b.store.clock_of(b.id_of['d'])) == {'w0-0', 'w1-0'}
    view, digest = b.materialize('d'), b.digest_of_id('d')
    # a duplicate delivery changes nothing
    b.apply_wire(_jax_wire(docs[:2], version), doc_ids=['d'])
    assert b.materialize('d') == view and b.digest_of_id('d') == digest
    # the concurrent third actor's same-key set wins over the second's
    b.apply_wire(_jax_wire(docs[2:], version), doc_ids=['d'])
    ref = J.GeneralDocSet(2)
    ref.apply_changes_batch({'d': docs})
    assert b.materialize('d') == ref.materialize('d')
    assert b.digest_of_id('d') == ref.digest_of_id('d')
    assert b.materialize('d')['n'] == 0


def _frontend_changes():
    """Two actors' frontend edits of one document: a map, a list and a
    text, a concurrent same-key set, and a delete."""
    from automerge_tpu_torch import backend as Backend
    from automerge_tpu_torch.text import Text
    base = Frontend.init({'actorId': 'aa01', 'backend': Backend})
    base, _ = Frontend.change(base, None, lambda d: (
        d.__setitem__('title', 'x'), d.__setitem__('list', [1, 2, 3]),
        d.__setitem__('text', Text())))
    base, _ = Frontend.change(base, None,
                              lambda d: d['text'].insert_at(0, 'a', 'b'))
    other = Frontend.init({'actorId': 'bb02', 'backend': Backend})
    state = Frontend.get_backend_state(base)
    hist = state.op_set.get_history()
    other, _ = Backend.apply_changes(Frontend.get_backend_state(other),
                                     hist), None
    other = Frontend.apply_patch(
        Frontend.init({'actorId': 'bb02', 'backend': Backend}),
        dict(Backend.get_patch(other[0]), state=other[0]))
    base, _ = Frontend.change(base, None,
                              lambda d: d.__setitem__('title', 'from a'))
    other, _ = Frontend.change(other, None, lambda d: (
        d.__setitem__('title', 'from b'), d['list'].__delitem__(0)))
    a_hist = Frontend.get_backend_state(base).op_set.get_history()
    b_hist = Frontend.get_backend_state(other).op_set.get_history()
    return a_hist, [c for c in b_hist if c['actor'] == 'bb02']


@pytest.mark.parametrize('cls', ['Connection', 'BatchingConnection'])
@pytest.mark.parametrize('kind', ['DocSet', 'DeviceDocSet'])
def test_dict_connections_over_doc_sets(cls, kind):
    a_changes, b_changes = _frontend_changes()
    a = J.DocSet()
    b = P.DeviceDocSet(device='cpu') if kind == 'DeviceDocSet' \
        else P.DocSet()
    a.apply_changes('d', a_changes)
    b.apply_changes('d', a_changes[:2] + b_changes)
    ma, mb = [], []
    ca = getattr(J, cls)(a, ma.append)
    cb = getattr(P, cls)(b, mb.append)
    ca.open()
    cb.open()
    _pump(ca, cb, ma, mb)
    assert doc_view(a.get_doc('d')) == doc_view(b.get_doc('d'))
    value, conflicts = doc_view(b.get_doc('d'))
    assert value['title'] == 'from b' and value['list'] == [2, 3]
    assert value['text'] == 'ab'
    assert conflicts['.']['title'] == {'aa01': 'from a'}


def test_watchable_doc():
    from automerge_tpu_torch import backend as Backend
    doc = Frontend.init({'actorId': 'aa01', 'backend': Backend})
    with pytest.raises(ValueError):
        P.WatchableDoc(None)
    w = P.WatchableDoc(doc)
    assert w.get() is doc
    seen = []

    def handler(d):
        seen.append(d)
    w.register_handler(handler)
    w.register_handler(handler)
    new = w.apply_changes([{'actor': 'bb02', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'k', 'value': 1}]}])
    assert new['k'] == 1 and seen == [new] and w.get() is new
    w.unregister_handler(handler)
    w.set(doc)
    assert len(seen) == 1 and w.get() is doc
