"""The general engine over a mesh: the PyTorch port's
``parallel/general_shard.py`` against the JAX package's, the JAX side
on the 8 forced host devices of ``tests/conftest.py``, the port's on 8
logical CPU mesh entries. ``sharded_rga_jobs``, ``sharded_fleet_order``
and ``fleet_rollup`` take the same seeded numpy inputs in both;
``sharded_general_step`` takes the inputs the JAX package's
``sharded_step_from_capture`` hands its own step (recorded there), so
both steps see the same staged planes. The edge cases of
``tests/test_general_shard.py`` (one segment starting at row 0, fewer
segments than shards) run through both, and the port's
``sharded_step_from_capture`` must equal its own fused outputs.
Everything is bit-equal, dtypes included."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device import general as tgeneral
from automerge_tpu_torch.parallel import general_shard as tgs
from automerge_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

ROOT_ID = '00000000-0000-0000-0000-000000000000'


@pytest.fixture(scope='module')
def meshes():
    import jax
    from jax.sharding import Mesh
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 host devices')
    return Mesh(np.array(jax.devices()[:8]), ('docs',)), \
        make_mesh(8, device='cpu')


def random_jobs(rng, K, m, n_actors=3):
    parent = np.zeros((K, m), np.int32)
    for j in range(K):
        parent[j, 1:] = (rng.random(m - 1) * np.arange(1, m)).astype(np.int32)
    elem = np.tile(np.arange(m, dtype=np.int32), (K, 1))
    actor = rng.integers(0, n_actors, size=(K, m)).astype(np.int32)
    visible = rng.random((K, m)) < 0.8
    visible[:, 0] = False
    valid = np.ones((K, m), bool)
    return parent, elem, actor, visible, valid


def _eq(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize('K,m,seed', [(11, 16, 5), (3, 40, 6), (16, 8, 7)])
def test_sharded_rga_jobs_match_reference(meshes, K, m, seed):
    from automerge_tpu.parallel.general_shard import sharded_rga_jobs
    jmesh, mesh = meshes
    planes = random_jobs(np.random.default_rng(seed), K, m)
    want, wstats = sharded_rga_jobs(jmesh, *planes)
    got, stats = tgs.sharded_rga_jobs(mesh, *planes)
    for k in ('tree_pos', 'vis_index', 'node_at_pos', 'length'):
        _eq(got[k], want[k], k)
    assert stats == wstats
    assert stats['jobs'] == -(-K // 8) * 8           # padded to the mesh


def test_sharded_fleet_order_matches_reference(meshes):
    from automerge_tpu.parallel.general_shard import sharded_fleet_order
    jmesh, mesh = meshes
    rng = np.random.default_rng(7)
    shard_jobs = [random_jobs(rng, 2 + s, 6 + 3 * s) for s in range(3)]
    want, wstats = sharded_fleet_order(jmesh, shard_jobs)
    got, stats = tgs.sharded_fleet_order(mesh, shard_jobs)
    assert stats == wstats
    for g, w, planes in zip(got, want, shard_jobs):
        ref, _ = tgs.sharded_rga_jobs(mesh, *planes)
        for name in w:
            _eq(g[name], w[name], name)
            _eq(g[name], ref[name].numpy(), name)
    assert tgs.sharded_fleet_order(mesh, []) == \
        ([], {'visible_total': 0, 'jobs': 0})


@pytest.mark.parametrize('values', ['small', 'big', 'ragged'])
def test_fleet_rollup_matches_reference(meshes, values):
    from automerge_tpu.parallel.general_shard import fleet_rollup
    jmesh, mesh = meshes
    if values == 'small':
        per_shard = np.arange(8 * 5, dtype=np.int64).reshape(8, 5) * 3
    elif values == 'big':
        # values past the int32 lane take the exact numpy path
        per_shard = np.full((8, 2), 2**40, np.int64)
    else:
        per_shard = np.random.default_rng(1).integers(
            0, 1000, size=(5, 7)).astype(np.int64)
    want = fleet_rollup(jmesh, per_shard)
    got = tgs.fleet_rollup(mesh, per_shard)
    _eq(got, np.asarray(want, np.int64), values)
    _eq(got, per_shard.sum(axis=0), values)
    _eq(tgs.fleet_rollup(make_mesh(device='cpu'), per_shard),
        per_shard.sum(axis=0), 'one device')
    _eq(tgs.fleet_rollup(None, per_shard), per_shard.sum(axis=0), 'none')
    with pytest.raises(ValueError, match=r'\[n_shards, k\]'):
        tgs.fleet_rollup(mesh, per_shard[0])


def single_segment():
    """tests/test_general_shard.py:53 — one touched field, so every
    shard cut snaps to row 0."""
    return [[{'actor': f'ac-{i:02d}', 'seq': 1, 'deps': {},
              'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'x',
                       'value': i}]} for i in range(16)]]


def few_segments():
    """tests/test_general_shard.py:72 — 3 touched fields over 8
    shards: several shards snap to one boundary and hold no rows."""
    return [[{'actor': f'b-{i:02d}', 'seq': 1, 'deps': {},
              'ops': [{'action': 'set', 'obj': ROOT_ID,
                       'key': f'k{i % 3}', 'value': i}]}
             for i in range(24)]]


def list_docs(n_docs=24, list_ops=10):
    """Lists with causal inserts, a second writer and a concurrent
    conflicting set + delete (a cut of the block-scale test)."""
    per_doc = []
    for d in range(n_docs):
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
        ops3 = [{'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                 'value': -d},
                {'action': 'del', 'obj': ROOT_ID,
                 'key': 'meta' if d % 3 else 'other'}]
        per_doc.append([
            {'actor': f'w0-{d}', 'seq': 1, 'deps': {}, 'ops': ops1},
            {'actor': f'w1-{d}', 'seq': 1, 'deps': {f'w0-{d}': 1},
             'ops': ops2},
            {'actor': f'zz-{d}', 'seq': 1, 'deps': {}, 'ops': ops3}])
    return per_doc


WORKLOADS = {'single_segment': single_segment, 'few_segments': few_segments,
             'lists': list_docs}


def _captured(general, per_doc, **kw):
    """Apply through a general engine while capturing its staged planes
    and fused outputs."""
    captured = {}
    store = general.init_store(len(per_doc), **kw)
    general._STAGE_CAPTURE = captured.update
    try:
        patch = general.apply_general_block(
            store, store.encode_changes(per_doc))
    finally:
        general._STAGE_CAPTURE = None
    return store, patch, captured


@pytest.mark.parametrize('workload', sorted(WORKLOADS))
def test_sharded_general_step_matches_reference(meshes, monkeypatch,
                                                workload):
    from automerge_tpu.device import general as jgeneral
    from automerge_tpu.parallel import general_shard as jgs
    jmesh, mesh = meshes
    per_doc = WORKLOADS[workload]()
    store, patch, captured = _captured(jgeneral, per_doc)
    calls = []
    real = jgs.sharded_general_step

    def record(*args, **kw):
        calls.append((args[1:], kw))
        return real(*args, **kw)

    monkeypatch.setattr(jgs, 'sharded_general_step', record)
    want, fused = jgs.sharded_step_from_capture(jmesh, store, patch,
                                                captured)
    (args, kw), = calls
    args = [np.asarray(a) for a in args]
    got = tgs.sharded_general_step(mesh, *args, **kw)
    for k in ('surviving', 'winner', 'visible'):
        _eq(got[k], want[k], k)
        _eq(got[k], fused[k], k)
    _eq(np.asarray(got['vis_index'], np.int64), want['vis_index'],
        'vis_index')
    if workload == 'single_segment':
        assert int(got['winner'][0]) >= 0
    if workload == 'few_segments':
        n_seg = int(np.unpackbits(captured['flags_u8'])[
            :len(captured['ops_slot'])].sum())
        assert (got['winner'][:n_seg] >= 0).all()


@pytest.mark.parametrize('n_dev', [1, 3, 8])
@pytest.mark.parametrize('workload', sorted(WORKLOADS))
def test_step_from_capture_equals_the_ports_fused_outputs(workload, n_dev):
    store, patch, captured = _captured(tgeneral, WORKLOADS[workload](),
                                       device='cpu')
    got, fused = tgs.sharded_step_from_capture(
        make_mesh(n_dev, device='cpu'), store, patch, captured)
    for k in ('surviving', 'winner', 'visible', 'vis_index'):
        _eq(got[k], fused[k], k)
