"""Snapshots, compaction and durability of the PyTorch port against the
JAX package's.

* ``save_snapshot``/``load_snapshot`` of per-doc device documents and
  of bulk-routed (general-engine) documents: written by either package,
  loaded by the other (``device='cpu'`` on the port's side), the same
  document, which keeps editing alike.
* The general store's tiered snapshot (after ``compact_docset``):
  written by either package and loaded by the other, equal views and
  state digests, and the resumed store keeps serving changes and state.
* ``compaction`` extract/absorb round trips within the port and across
  the packages, and ``GeneralDocSet.extract_doc_state`` /
  ``drop_doc_state`` / ``apply_states`` (eviction and bring-back).
* ``DurableDocSet.recover`` after a crash: checkpoint plus a journal of
  dict batches, a wire payload and a state bootstrap.
* ``SnapshotCorruptError`` has one home (``snapshot.py``): what one
  module raises, another's ``except`` catches.
"""

import base64

import pytest
import torch

import automerge_tpu as jam
from automerge_tpu import compaction as jcompaction
from automerge_tpu import frontend as JFrontend
from automerge_tpu.device import backend as JDeviceBackend
from automerge_tpu.sync.general_doc_set import GeneralDocSet as JaxDocSet
import automerge_tpu_torch as tam
from automerge_tpu_torch import compaction, durability, snapshot
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.config import Options
from automerge_tpu_torch.device import backend as DeviceBackend
from automerge_tpu_torch.sync import general_doc_set as gds_mod
from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet

from chip_smoke import ROOT_ID, doc_view
from test_torch_sync import _jax_wire
from test_torch_wire import seeded_docs

torch.set_num_threads(1)

N = 6
IDS = [f'doc{d}' for d in range(N)]


def _changes():
    docs = seeded_docs(N, 5)
    return {IDS[d]: docs[d] for d in range(N)}


def _edit(doc, key, value):
    return Frontend.change(doc, None, lambda d: d.__setitem__(key, value))[0]


def _jedit(doc, key, value):
    return JFrontend.change(doc, None,
                            lambda d: d.__setitem__(key, value))[0]


def _device_docs(bulk):
    """The same changes into a port device document (on the CPU) and a
    JAX device document; ``bulk`` routes both into the general engine."""
    changes = _changes()['doc1']
    opts = {'bulk_route_min_ops': 4 if bulk else None}
    t_state, _ = DeviceBackend.apply_changes(
        DeviceBackend.init(device='cpu'), changes, options=Options(**opts))
    from automerge_tpu.config import Options as JOptions
    j_state, _ = JDeviceBackend.apply_changes(
        JDeviceBackend.init(), changes, options=JOptions(**opts))
    t_doc = Frontend.apply_patch(
        Frontend.init({'backend': DeviceBackend.for_device('cpu'),
                       'actorId': 'cc03'}),
        dict(DeviceBackend.get_patch(t_state), state=t_state))
    j_doc = JFrontend.apply_patch(
        JFrontend.init({'backend': JDeviceBackend, 'actorId': 'cc03'}),
        dict(JDeviceBackend.get_patch(j_state), state=j_state))
    return t_doc, j_doc


@pytest.mark.parametrize('bulk', [False, True])
def test_doc_snapshots_load_in_the_other_package(bulk):
    t_doc, j_doc = _device_docs(bulk)
    assert doc_view(t_doc) == doc_view(j_doc)
    from automerge_tpu_torch.device.general_backend import \
        GeneralBackendState
    assert isinstance(Frontend.get_backend_state(t_doc),
                      GeneralBackendState) == bulk
    t_snap = tam.save_snapshot(t_doc)
    j_snap = jam.save_snapshot(j_doc)
    from_jax = tam.load_snapshot(j_snap, actor_id='cc03', device='cpu')
    from_port = jam.load_snapshot(t_snap, actor_id='cc03')
    own = tam.load_snapshot(t_snap, actor_id='cc03', device='cpu')
    for d in (from_jax, from_port, own):
        assert doc_view(d) == doc_view(t_doc)
    state = Frontend.get_backend_state(from_jax)
    dev = state.store.device if bulk else state.device
    assert dev.type == 'cpu'
    # both keep editing alike; save() refuses the truncated log
    a = _edit(from_jax, 'after', [1, 2])
    b = _jedit(from_port, 'after', [1, 2])
    assert doc_view(a) == doc_view(b)
    if not bulk:
        with pytest.raises(ValueError, match='save_snapshot'):
            tam.save(own)
    with pytest.raises(snapshot.SnapshotCorruptError):
        tam.load_snapshot(t_snap[:-9], device='cpu')


def _compacted(cls, **kw):
    ds = cls(8, **kw)
    ds.apply_changes_batch(_changes())
    compaction.compact_docset(ds) if cls is GeneralDocSet else \
        jcompaction.compact_docset(ds)
    return ds


def _views(ds):
    return dict(zip(IDS, ds.materialize_many(IDS)))


def test_tiered_store_snapshot_loads_in_the_other_package():
    t = _compacted(GeneralDocSet, device='cpu')
    j = _compacted(JaxDocSet)
    assert t.store.horizon and _views(t) == _views(j)
    from_jax = GeneralDocSet.load_snapshot(j.save_snapshot(), device='cpu')
    from_port = JaxDocSet.load_snapshot(t.save_snapshot())
    assert from_jax.store.horizon and not from_jax.store.log_truncated
    for ds in (from_jax, from_port):
        assert _views(ds) == _views(t)
        assert [ds.digest_of_id(i) for i in IDS] == \
            [t.digest_of_id(i) for i in IDS]
    # the resumed tiered store keeps serving: a new change applies, and
    # a peer behind the horizon gets the state payload
    more = {'doc2': [{'actor': 'zz09', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'late', 'value': 2}]}]}
    from_jax.apply_changes_batch(more)
    from_port.apply_changes_batch(more)
    assert _views(from_jax) == _views(from_port)
    payload, clock = from_jax.serve_state_payload('doc3')
    assert clock == from_jax.store.clock_of(from_jax.id_of['doc3'])
    back = GeneralDocSet(8, device='cpu')
    back.apply_states({'doc3': payload})
    assert back.materialize('doc3') == from_jax.materialize('doc3')


def test_extract_absorb_round_trips_within_and_across():
    t = GeneralDocSet(8, device='cpu')
    j = JaxDocSet(8)
    t.apply_changes_batch(_changes())
    j.apply_changes_batch(_changes())
    idxs = [t.id_of[i] for i in IDS]
    t_states = compaction.extract_doc_states(t.store, idxs)
    j_states = jcompaction.extract_doc_states(j.store, idxs)
    for i in idxs:
        assert t_states[i]['state'] == j_states[i]['state']
        assert t_states[i]['clock'] == j_states[i]['clock']
        assert t_states[i]['digest'] == j_states[i]['digest']
    for states in (t_states, j_states):
        fresh = GeneralDocSet(8, device='cpu')
        fresh.apply_states({IDS[n]: states[i]['state']
                            for n, i in enumerate(idxs)})
        assert _views(fresh) == _views(t)
        assert [fresh.digest_of_id(i) for i in IDS] == \
            [t.digest_of_id(i) for i in IDS]
    decoded = compaction.decode_state_snapshot(t_states[idxs[0]]['state'])
    assert compaction.encode_state_snapshot(decoded) == \
        t_states[idxs[0]]['state']


def test_evict_and_bring_back():
    t = GeneralDocSet(8, device='cpu')
    t.apply_changes_batch(_changes())
    compaction.compact_docset(t, doc_ids=IDS[:2])
    views, digests = _views(t), [t.digest_of_id(i) for i in IDS]
    recs = t.extract_doc_state(IDS[:3])
    assert 'state' in recs['doc0'] and 'changes' in recs['doc2']
    t.drop_doc_state(IDS[:3])
    assert t.store.clock_of(t.id_of['doc0']) == {}
    t.apply_states({d: base64.b64decode(recs[d]['state'])
                    for d in IDS[:2]})
    t.apply_changes_batch({'doc2': recs['doc2']['changes']})
    assert _views(t) == views
    assert [t.digest_of_id(i) for i in IDS] == digests


def test_durable_doc_set_recovers(tmp_path):
    changes = _changes()
    factory = lambda: GeneralDocSet(8, device='cpu')  # noqa: E731
    dds = durability.DurableDocSet(factory(), str(tmp_path), fsync=False)
    dds.apply_changes_batch({d: changes[d][:1] for d in IDS[:5]})
    dds.checkpoint()
    dds.apply_changes_batch({d: changes[d][1:2] for d in IDS[:3]})
    dds.apply_wire(_jax_wire(changes['doc4'][1:], 3), doc_ids=['doc4'])
    src = GeneralDocSet(8, device='cpu')
    src.apply_changes_batch({'doc5': changes['doc5']})
    state = compaction.extract_doc_states(src.store, [0])[0]['state']
    dds.apply_states({'doc5': state})       # a state bootstrap
    want = _views(dds.doc_set)
    digests = [dds.digest_of_id(i) for i in IDS]
    dds.close()                          # the crash
    back = durability.DurableDocSet.recover(
        str(tmp_path), factory, fsync=False,
        load_snapshot=lambda b: GeneralDocSet.load_snapshot(b,
                                                            device='cpu'))
    assert _views(back.doc_set) == want
    assert [back.digest_of_id(i) for i in IDS] == digests
    assert back.doc_set.device.type == 'cpu'
    back.close()


def test_snapshot_corrupt_error_has_one_home():
    err = snapshot.SnapshotCorruptError
    assert not hasattr(gds_mod, 'SnapshotCorruptError') or \
        gds_mod.SnapshotCorruptError is err
    assert durability.SnapshotCorruptError is err
    assert tam.SnapshotCorruptError is err
    raisers = [
        lambda: GeneralDocSet.load_snapshot(b'\x00\x00\x00\x00', device='cpu'),
        lambda: GeneralDocSet.load_snapshot(b'\x00' * 7 + b'\x02{}',
                                            device='cpu'),
        lambda: durability.unpack_snapshot(b'not a snapshot'),
        lambda: compaction.decode_state_snapshot(b'garbage!'),
        lambda: snapshot.load_snapshot('{"format": 1', device='cpu'),
    ]
    for raise_it in raisers:
        try:
            raise_it()
        except snapshot.SnapshotCorruptError:
            pass
        else:
            raise AssertionError('no SnapshotCorruptError')
