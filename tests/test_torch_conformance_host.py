"""The JAX package's host-side suites on the PyTorch port: the dense
store, native staging, the configuration, and the device functions (the
RGA order, the field resolve, the vector clocks and the batch merge
engine), re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect``. ``test_metrics`` runs in
``test_torch_conformance_metrics.py``, so each file stays short.

Each of these modules imports ``jax`` itself, so this file runs where
JAX is installed, in the ``cpu`` lane only (``chip_smoke.py``'s card
lane runs no JAX); ``test_device`` hands JAX arrays straight to the
port's device functions, which read them as host arrays.
"""

import random

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device import sequence
from automerge_tpu_torch.device.dense_store import DenseMapStore
from automerge_tpu_torch.device.workloads import gen_block_workload
from automerge_tpu_torch.parallel import general_shard, mesh as port_mesh

import test_torch_conformance_harness as harness

pytest.importorskip('jax', reason='these JAX test modules import jax')

torch.set_num_threads(1)

MODULES = ('test_dense_store', 'test_native_staging', 'test_config',
           'test_device')


def _sharded_planes_match_single_device(self):
    """Overrides ``test_dense_store.py:146``, which shards the store
    over a ``jax.sharding.Mesh`` of ``jax.devices()[:8]`` (the
    conftest's forced host devices): the port's store takes the port's
    mesh, here its 8 logical CPU entries. Every assertion is the
    reference's."""
    mesh = harness.port_mesh(8)
    block = gen_block_workload(n_docs=16, n_actors=4, ops_per_change=5,
                               n_keys=8, seed=9, del_p=0.2)
    plain = DenseMapStore(16, key_capacity=8, actor_capacity=4)
    shard = DenseMapStore(16, key_capacity=8, actor_capacity=4, mesh=mesh)
    pb_plain = plain.apply_block(block).to_patch_block()
    pb_shard = shard.apply_block(
        gen_block_workload(n_docs=16, n_actors=4, ops_per_change=5,
                           n_keys=8, seed=9, del_p=0.2)).to_patch_block()
    for d in range(16):
        assert pb_shard.diffs(d) == pb_plain.diffs(d)
    np.testing.assert_array_equal(np.asarray(shard.eseq),
                                  np.asarray(plain.eseq))
    np.testing.assert_array_equal(np.asarray(shard.m), np.asarray(plain.m))
    # second apply continues correctly on the sharded store
    more = gen_block_workload(n_docs=16, n_actors=4, ops_per_change=5,
                              n_keys=8, seed=10)
    more.seq[:] = 2
    pb2s = shard.apply_block(more).to_patch_block()
    more2 = gen_block_workload(n_docs=16, n_actors=4, ops_per_change=5,
                               n_keys=8, seed=10)
    more2.seq[:] = 2
    pb2p = plain.apply_block(more2).to_patch_block()
    for d in range(16):
        assert pb2s.diffs(d) == pb2p.diffs(d)


def _sharded_snapshot_resumes_sharded(self):
    """Overrides ``test_dense_store.py:181``: the same ``jax.devices()``
    mesh, built here as the port's 8-entry CPU mesh. Its check that the
    resumed planes span 8 devices (``eseq.sharding.device_set``, a JAX
    array's attribute, ``:194``) reads the port's per-entry planes: one
    block per mesh entry, each on its entry's device."""
    mesh = harness.port_mesh(8)
    store = DenseMapStore(8, key_capacity=8, actor_capacity=4, mesh=mesh)
    block = gen_block_workload(n_docs=8, n_actors=3, ops_per_change=4,
                               n_keys=8, seed=12)
    store.apply_block(block)
    restored = DenseMapStore.load_snapshot(store.save_snapshot(), mesh=mesh)
    assert len(restored._planes) == 8
    assert [p[0].device for p in restored._planes] == list(mesh.devices)
    a = restored.extract_all().to_patch_block()
    b = store.extract_all().to_patch_block()
    for d in range(8):
        assert a.diffs(d) == b.diffs(d)


@pytest.mark.parametrize('axis', ['nodes', 'docs'])
def _sharded_ordering_matches_unsharded(self, axis):
    """Overrides ``test_device.py:191``, which places the planes on a
    ``jax.sharding.Mesh`` along the node or the document axis and runs
    ``rga_order_batch`` under ``jax.jit`` (``:203``, ``:209``): the port
    has no XLA sharding and no trace. Its mesh layer splits whole jobs
    over the mesh entries, so ``docs`` holds ``rga_order_batch`` on each
    shard of ``shard_docs`` over the 8-entry CPU mesh, and ``nodes`` the
    general engine's sharded job path (``sharded_rga_jobs``), against
    the unsharded order, on the reference's seeded traces and keys."""
    ref = harness.load('test_device')
    rng = random.Random(41)
    traces = [ref.random_trace(rng, n_ops=25) for _ in range(8)]
    packed = [ref.pack_trace(ops, dels, pad_to=64) for ops, dels in traces]
    args = tuple(np.stack([p[0][k] for p in packed]) for k in range(5))
    reference = sequence.rga_order_batch(*args)
    mesh = harness.port_mesh(8)
    if axis == 'nodes':
        sharded, _ = general_shard.sharded_rga_jobs(mesh, *args)
    else:
        parts = [sequence.rga_order_batch(*shard)
                 for shard in zip(*port_mesh.shard_docs(mesh, *args))]
        sharded = {k: torch.cat([p[k] for p in parts]) for k in reference}
    for k in ('tree_pos', 'vis_index', 'length'):
        np.testing.assert_array_equal(np.asarray(sharded[k]),
                                      np.asarray(reference[k]), err_msg=k)


harness.recollect(globals(), MODULES, overrides={
    ('test_dense_store', 'TestDenseDifferential'): {
        'test_sharded_planes_match_single_device':
            _sharded_planes_match_single_device,
        'test_sharded_snapshot_resumes_sharded':
            _sharded_snapshot_resumes_sharded},
    ('test_device', 'TestSequenceKernel'): {
        'test_sharded_ordering_matches_unsharded':
            _sharded_ordering_matches_unsharded},
    ('test_device', 'TestPallasDispatchRule'): {
        # left out: tests/test_device.py:407 encodes the TPU's measured
        # Pallas-vs-XLA bound (engine._pallas_wins). The port picks its
        # flat-map kernel variant by bounds measured on the H100
        # (cuda_merge.variant), which tests/test_torch_flatmap_resolve.py
        # tests.
        'test_rule_matches_measured_ab': None}}, lanes=('cpu',))
