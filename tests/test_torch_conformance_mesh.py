"""The JAX package's mesh suites on the PyTorch port: the sharded
general step, replica sync as collectives (all-gather, ring and delta
rounds) and the sharded fleet (placement, migration, rollups,
snapshots, chaos with migration), re-collected against
``automerge_tpu_torch`` by ``test_torch_conformance_harness.recollect``.

These modules import ``jax`` and build their meshes from the conftest's
8 forced host devices, so this file runs where JAX is installed, in the
``cpu`` lane only. Where a case builds a ``jax.sharding.Mesh`` and hands
it to the port, it is overridden to build the port's counterpart, 8
logical CPU entries (``test_torch_conformance_harness.port_mesh``).
``test_ici_sync``'s module-scoped ``mesh`` fixture runs under the lane
(``port_lane`` takes its scope).
"""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device.sequence import rga_order_batch
from automerge_tpu_torch.parallel.general_shard import sharded_rga_jobs
from automerge_tpu_torch.parallel.mesh import make_mesh
from automerge_tpu_torch.sync.sharded import ShardedGeneralDocSet

import test_torch_conformance_harness as harness

pytest.importorskip('jax', reason='these JAX test modules import jax')

torch.set_num_threads(1)

MODULES = ('test_general_shard', 'test_ici_sync', 'test_sharded_fleet')


def _on_port_mesh(module, cls, name, doc):
    """The reference case with its module's ``_mesh()`` helper, which
    builds a ``jax.sharding.Mesh`` of ``jax.devices()[:n]``, returning
    the port's mesh of ``n`` CPU entries instead."""
    def patch(monkeypatch):
        monkeypatch.setattr(harness.load(module), '_mesh', harness.port_mesh)
    return harness.patched_case(module, cls, name, patch, doc)


def _sharded_rga_jobs_equal_unsharded(self):
    """Overrides ``test_ici_sync.py:229``, whose reference order is
    ``jax.jit(rga_order_batch)`` on JAX arrays (``:250``): the port has
    no trace, so the reference order is the port's ``rga_order_batch``
    on the same numpy planes, unsharded. The sharded side, the seeded
    planes and every assertion are the reference's."""
    mesh8 = make_mesh(n_devices=8)
    rng = np.random.default_rng(5)
    K, m = 11, 16                       # K does not divide the mesh
    parent = np.zeros((K, m), np.int32)
    for j in range(K):
        parent[j, 1:] = (rng.random(m - 1) * np.arange(1, m)).astype(np.int32)
    elem = np.tile(np.arange(m, dtype=np.int32), (K, 1))
    actor = rng.integers(0, 3, size=(K, m)).astype(np.int32)
    visible = rng.random((K, m)) < 0.8
    visible[:, 0] = False
    valid = np.ones((K, m), bool)

    ref = rga_order_batch(parent, elem, actor, visible, valid)
    out, stats = sharded_rga_jobs(mesh8, parent, elem, actor, visible, valid)
    for k in ('tree_pos', 'vis_index', 'node_at_pos', 'length'):
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=k)
    assert stats['visible_total'] == int(np.asarray(ref['length']).sum())
    assert stats['jobs'] == 16          # padded to the mesh


def _default_shards_cover_mesh_devices(self):
    """Overrides ``test_sharded_fleet.py:150``, which expects 8 shards
    because the reference's default mesh is ``jax.devices()``, the
    conftest's 8 forced host devices. The port's default mesh is every
    device of the lane (``make_mesh()``: the visible cards, or one CPU
    entry in the ``cpu`` lane), so the default shard count must be that
    mesh's size, each shard on its own device."""
    n = make_mesh().devices.size
    sharded = ShardedGeneralDocSet(32)
    assert sharded.n_shards == n
    assert len({str(d) for d in sharded.devices}) == n


harness.recollect(globals(), MODULES, overrides={
    ('test_general_shard', None): {
        'test_single_segment_row0_start': _on_port_mesh(
            'test_general_shard', None, 'test_single_segment_row0_start',
            """Overrides ``test_general_shard.py:53``: its mesh
            (``_mesh``, ``:22``) is a ``jax.sharding.Mesh`` of the
            forced host devices; here the port's 8-entry CPU mesh."""),
        'test_fewer_segments_than_shards': _on_port_mesh(
            'test_general_shard', None, 'test_fewer_segments_than_shards',
            """Overrides ``test_general_shard.py:72``: the same mesh,
            the same remedy."""),
        'test_block_scale_sharded_equality': _on_port_mesh(
            'test_general_shard', None,
            'test_block_scale_sharded_equality',
            """Overrides ``test_general_shard.py:89``: the same mesh,
            the same remedy.""")},
    ('test_ici_sync', 'TestGeneralShard'): {
        'test_sharded_rga_jobs_equal_unsharded':
            _sharded_rga_jobs_equal_unsharded},
    ('test_sharded_fleet', 'TestMeshPlacement'): {
        'test_default_shards_cover_mesh_devices':
            _default_shards_cover_mesh_devices},
    ('test_sharded_fleet', 'TestRollups'): {
        'test_fleet_rollup_psum_equals_numpy': _on_port_mesh(
            'test_sharded_fleet', 'TestRollups',
            'test_fleet_rollup_psum_equals_numpy',
            """Overrides ``test_sharded_fleet.py:315``: its mesh
            (``_mesh``, ``:37``) is a ``jax.sharding.Mesh`` of the
            forced host devices; here the port's 8-entry CPU mesh."""),
        'test_sharded_fleet_order_matches_per_shard': _on_port_mesh(
            'test_sharded_fleet', 'TestRollups',
            'test_sharded_fleet_order_matches_per_shard',
            """Overrides ``test_sharded_fleet.py:330``: the same mesh,
            the same remedy.""")}}, lanes=('cpu',))
