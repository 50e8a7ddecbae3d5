"""The sharded fleet: the PyTorch port's ``sync/sharded.py`` over a mesh
of logical CPU entries, against the JAX package's on the same seeded
changes.

Held equal to the reference: the placement ring (``shard_of`` for
1,000 ids), migration units (byte for byte), views and per-doc state
digests against the JAX ``GeneralDocSet`` (the reference's single-shard
compat oracle) and once against its 4-shard ``ShardedGeneralDocSet``,
and sharded snapshots loading across the two packages in both
directions. The port's own: migration parity, the fence and the
rollback, the placement knob draining a hot shard and doing nothing on
a balanced fleet, and ``fleet_status`` totals."""

import json

import numpy as np
import pytest
import torch

from automerge_tpu_torch.parallel.mesh import make_mesh
from automerge_tpu_torch.sync import GeneralDocSet
from automerge_tpu_torch.sync.chaos import canonical, doc_set_view
from automerge_tpu_torch.sync.control import FleetController
from automerge_tpu_torch.sync.sharded import (
    PlacementMap, ShardedGeneralDocSet, decode_migration_unit,
    encode_migration_unit)
from automerge_tpu_torch.utils.metrics import metrics

torch.set_num_threads(1)

ROOT_ID = '00000000-0000-0000-0000-000000000000'


def rich_changes(d, n_items=3):
    """tests/test_sharded_fleet.py's doc: a list with causal inserts
    and sets, and a second actor depending on the first."""
    obj = f'00000000-0000-4000-8000-{d:012x}'
    ops = [
        {'action': 'makeList', 'obj': obj},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'items', 'value': obj},
        {'action': 'ins', 'obj': obj, 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': obj, 'key': f'w0-{d}:1', 'value': d * 10}]
    for i in range(2, n_items + 1):
        ops += [
            {'action': 'ins', 'obj': obj, 'key': f'w0-{d}:{i - 1}',
             'elem': i},
            {'action': 'set', 'obj': obj, 'key': f'w0-{d}:{i}',
             'value': d * 10 + i}]
    return [
        {'actor': f'w0-{d}', 'seq': 1, 'deps': {}, 'ops': ops},
        {'actor': f'w1-{d}', 'seq': 1, 'deps': {f'w0-{d}': 1},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                  'value': d}]}]


def _batch(n_docs=12):
    return {f'doc{d}': rich_changes(d) for d in range(n_docs)}


def _sharded(n_shards=4, capacity=32, n_docs=12, mesh_size=4):
    s = ShardedGeneralDocSet(capacity, n_shards=n_shards,
                             mesh=make_mesh(mesh_size, device='cpu'))
    s.apply_changes_batch(_batch(n_docs))
    return s


def _views(ds):
    return canonical(doc_set_view(ds))


def _digests(ds, ids):
    return {d: int(ds.digest_of_id(d)) for d in ids}


@pytest.fixture(autouse=True)
def _clean_metrics():
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize('n_shards,replicas', [(8, 32), (4, 16), (3, 32)])
def test_placement_ring_matches_reference(n_shards, replicas):
    from automerge_tpu.sync.sharded import PlacementMap as JPlacementMap
    ids = [f'doc{i}' for i in range(1000)]
    want = JPlacementMap(n_shards, replicas=replicas)
    got = PlacementMap(n_shards, replicas=replicas)
    want.pin('doc7', 0)
    got.pin('doc7', 0)
    assert [got.shard_of(d) for d in ids] == [want.shard_of(d) for d in ids]
    assert set(got.shard_of(d) for d in ids) == set(range(n_shards))
    assert got.snapshot() == want.snapshot()
    q = PlacementMap.restore(want.snapshot())
    assert [q.shard_of(d) for d in ids] == [got.shard_of(d) for d in ids]


def test_migration_units_are_byte_equal():
    from automerge_tpu.sync import sharded as jsharded
    s = _sharded()
    rec = s.extract_doc_state(['doc0'])['doc0']
    unit = encode_migration_unit(rec)
    assert unit == jsharded.encode_migration_unit(rec)
    assert decode_migration_unit(unit) == jsharded.decode_migration_unit(
        unit) == json.loads(json.dumps(rec))
    flipped = bytearray(unit)
    flipped[len(unit) // 2] ^= 0xFF
    with pytest.raises(ValueError, match='checksum'):
        decode_migration_unit(bytes(flipped))


@pytest.fixture(scope='module')
def reference():
    """The JAX package's plain GeneralDocSet and 4-shard
    ShardedGeneralDocSet after the seed batch, their views, digests and
    a sharded snapshot."""
    from automerge_tpu.sync import GeneralDocSet as JGeneralDocSet
    from automerge_tpu.sync.chaos import (canonical as jcanonical,
                                          doc_set_view as jview)
    from automerge_tpu.sync.sharded import \
        ShardedGeneralDocSet as JSharded
    batch = _batch()
    plain = JGeneralDocSet(32)
    plain.apply_changes_batch(batch)
    sharded = JSharded(32, n_shards=4)
    sharded.apply_changes_batch(batch)
    ids = sorted(batch)
    return {'plain_views': jcanonical(jview(plain)),
            'plain_digests': {d: int(plain.digest_of_id(d)) for d in ids},
            'sharded_views': jcanonical(jview(sharded)),
            'sharded_digests': {d: int(sharded.digest_of_id(d))
                                for d in ids},
            'placement': {d: sharded.shard_of(d) for d in ids},
            'snapshot': sharded.save_snapshot(),
            'loader': JSharded, 'view': lambda ds: jcanonical(jview(ds))}


@pytest.mark.parametrize('n_shards', [1, 4])
def test_views_and_digests_match_reference(reference, n_shards):
    s = _sharded(n_shards=n_shards)
    ids = sorted(_batch())
    assert _views(s) == reference['plain_views']
    assert _digests(s, ids) == reference['plain_digests']
    if n_shards == 4:
        assert _views(s) == reference['sharded_views']
        assert _digests(s, ids) == reference['sharded_digests']
        assert {d: s.shard_of(d) for d in ids} == reference['placement']
        assert len({s.shard_of(d) for d in ids}) > 1
    # shards sit round-robin on the mesh's entries
    assert s.devices == [torch.device('cpu')] * n_shards


def test_snapshots_cross_load_both_ways(reference):
    # written by the JAX package, served by the port
    restored = ShardedGeneralDocSet.load_snapshot(reference['snapshot'],
                                                  device='cpu')
    assert _views(restored) == reference['sharded_views']
    assert {d: restored.shard_of(d) for d in reference['placement']} == \
        reference['placement']
    # written by the port (after a migration), served by the JAX package
    s = _sharded()
    dst = (s.shard_of('doc0') + 1) % 4
    assert s.migrate_doc('doc0', dst)
    jrestored = reference['loader'].load_snapshot(s.save_snapshot())
    assert reference['view'](jrestored) == _views(s)
    assert jrestored.shard_of('doc0') == dst
    again = ShardedGeneralDocSet.load_snapshot(
        s.save_snapshot(), mesh=make_mesh(2, device='cpu'))
    assert _views(again) == _views(s) and again.shard_of('doc0') == dst
    extra = {'doc0': [{'actor': 'w2-0', 'seq': 1, 'deps': {'w0-0': 1},
                       'ops': [{'action': 'set', 'obj': ROOT_ID,
                                'key': 'post', 'value': 1}]}]}
    again.apply_changes_batch(extra)
    assert again.materialize('doc0')['post'] == 1


def test_migration_parity_and_writes_after():
    s = _sharded()
    oracle = GeneralDocSet(32, device='cpu')
    oracle.apply_changes_batch(_batch())
    doc = 'doc1'
    src = s.shard_of(doc)
    dst = (src + 2) % 4
    before = int(s.digest_of_id(doc))
    assert s.migrate_doc(doc, dst)
    assert s.shard_of(doc) == dst and s.placement.shard_of(doc) == dst
    assert int(s.digest_of_id(doc)) == before
    assert _views(s) == _views(oracle)
    assert metrics.counters.get('placement_migrations', 0) == 1
    status = s.fleet_status()
    assert status['docs'][doc]['shard'] == dst
    assert status['placement']['migrations'] == 1
    extra = [{'actor': f'w2-{doc}', 'seq': 1, 'deps': {'w0-1': 1},
              'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'post',
                       'value': 'moved'}]}]
    s.apply_changes(doc, extra)
    oracle.apply_changes(doc, extra)
    assert _views(s) == _views(oracle)
    # a plan over several destinations
    plan = {d: (s.shard_of(d) + 1 + i) % 4
            for i, d in enumerate(['doc2', 'doc3', 'doc4'])}
    assert s.migrate_docs(plan) == 3
    assert all(s.shard_of(d) == v for d, v in plan.items())
    assert _views(s) == _views(oracle)


def test_fence_reroutes_changes_that_arrive_mid_migration():
    s = _sharded()
    oracle = GeneralDocSet(32, device='cpu')
    oracle.apply_changes_batch(_batch())
    doc = 'doc2'
    src = s.shard_of(doc)
    dst = (src + 1) % 4
    late = [{'actor': f'w9-{doc}', 'seq': 1, 'deps': {},
             'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'late',
                      'value': 'fenced'}]}]
    real_extract = s.shards[src].extract_doc_state
    seen = {}

    def extract_and_race(ids):
        rec = real_extract(ids)
        s.apply_changes_batch({doc: late})
        seen['buffered'] = bool(s._fences.get(doc))
        return rec

    s.shards[src].extract_doc_state = extract_and_race
    assert s.migrate_doc(doc, dst)
    assert seen['buffered'] and doc not in s._fences
    oracle.apply_changes(doc, late)
    assert s.shard_of(doc) == dst
    assert _views(s) == _views(oracle)
    assert metrics.counters.get('placement_fenced_changes', 0) == 1


def test_absorb_fault_rolls_back_and_quarantine_stays():
    s = _sharded()
    want = _views(s)
    doc = 'doc3'
    src = s.shard_of(doc)
    dst = (src + 1) % 4

    def boom(payloads):
        raise RuntimeError('absorb fault')

    s.shards[dst].apply_states = boom
    s.shards[dst].apply_changes_batch = boom
    with pytest.raises(RuntimeError, match='absorb fault'):
        s.migrate_doc(doc, dst)
    del s.shards[dst].apply_states, s.shards[dst].apply_changes_batch
    assert s.shard_of(doc) == src and doc not in s._fences
    assert not s.quarantined and _views(s) == want
    # a quarantined doc refuses to travel
    s.shards[src].quarantined[doc] = {'error': 'poisoned', 'changes': []}
    assert s.migrate_docs([doc], dst) == 0 and s.shard_of(doc) == src


def _knob_writes(t, docs, rng=None):
    writes = {}
    for k in range(16 if rng is not None else len(docs)):
        d = min(int(rng.zipf(1.2)) - 1, len(docs) - 1) if rng is not None \
            else k
        writes.setdefault(docs[d], []).append(
            {'actor': f'h{t}-{k}-{d}', 'seq': 1, 'deps': {f'w0-{d}': 1},
             'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': f'k{t}',
                      'value': t}]})
    return writes


def test_placement_knob_drains_a_hot_shard():
    s = ShardedGeneralDocSet(32, n_shards=4,
                             mesh=make_mesh(2, device='cpu'))
    docs = [f'doc{d}' for d in range(6)]
    for d in docs:
        s.placement.pin(d, 0)
    s.apply_changes_batch({d: rich_changes(i) for i, d in enumerate(docs)})
    FleetController(s, hold=2, cooldown=2, placement_min_ops=8,
                    placement_ratio=1.5, migrate_batch=2)
    rng = np.random.default_rng(3)
    for t in range(6):
        s.apply_changes_batch(_knob_writes(t, docs, rng))
        s.tick()
    assert metrics.counters.get('control_migrations', 0) > 0
    assert s.controller.actions.get('migrate', 0) > 0
    assert sum(1 for n in s.shard_load()['docs'] if n > 0) > 1
    assert not s.quarantined


def test_placement_knob_does_nothing_on_a_balanced_fleet():
    s = ShardedGeneralDocSet(32, n_shards=4,
                             mesh=make_mesh(4, device='cpu'))
    FleetController(s, hold=2, cooldown=2, placement_min_ops=8,
                    placement_ratio=1.5)
    docs = [f'doc{d}' for d in range(8)]
    for i, d in enumerate(docs):
        s.placement.pin(d, i % 4)
    s.apply_changes_batch({d: rich_changes(i) for i, d in enumerate(docs)})
    placed = {d: s.shard_of(d) for d in docs}
    for t in range(4):
        s.apply_changes_batch(_knob_writes(t, docs))
        s.tick()
    assert metrics.counters.get('control_migrations', 0) == 0
    assert {d: s.shard_of(d) for d in docs} == placed


def test_fleet_status_totals():
    s = _sharded(n_docs=10)
    st = s.fleet_status()
    assert st['totals']['docs'] == 10 and st['totals']['capacity'] == 32
    assert st['totals']['quarantined'] == 0 and st['totals']['diverged'] == 0
    place = st['placement']
    assert place['n_shards'] == 4 and place['mesh_devices'] == 4
    assert sum(r['docs'] for r in place['per_shard']) == 10
    assert [r['device'] for r in place['per_shard']] == ['cpu'] * 4
    from automerge_tpu_torch.device.general import mirror_bytes
    assert st['memory']['device_plane_bytes'] == sum(
        mirror_bytes(sh.store.pool.mirror) for sh in s.shards)
    assert st['totals']['dirty'] == sum(
        r['dirty'] for r in place['per_shard'])
    assert sorted(st['docs']) == sorted(s.doc_ids)


def test_default_mesh_follows_the_device():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default mesh works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ShardedGeneralDocSet(8)
    s = ShardedGeneralDocSet(8, device='cpu')
    assert s.n_shards == 1 and s.mesh.devices.size == 1
    made = []

    def factory(i, cap, device):
        made.append((i, cap, device))
        return GeneralDocSet(cap, device=device)

    ShardedGeneralDocSet(16, n_shards=2, mesh=make_mesh(2, device='cpu'),
                         shard_factory=factory)
    assert made == [(0, 8, torch.device('cpu')), (1, 8, torch.device('cpu'))]
