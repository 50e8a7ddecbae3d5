"""``chip_smoke.py`` phase 5d's parts, rehearsed on the CPU at a small
size: each part drives the mesh layer over 4 logical CPU entries and
raises on any disagreement, so a wrong path, shape or comparison shows
here before the card runs it at full size (where its launch counts are
also required; on the CPU nothing launches, so the counted drives only
run)."""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from automerge_tpu_torch.device.workloads import gen_block_workload
from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet

torch.set_num_threads(1)

CARD = 'cpu rehearsal'


class _Uncounted(cs._MeshCounts):
    """The counted drive without its launch requirement (the CPU runs
    the kernels' plain versions)."""

    @contextlib.contextmanager
    def drive(self, what, need=()):
        yield


@pytest.fixture
def counts():
    return _Uncounted({})


@pytest.fixture(scope='module')
def fleet():
    """Phase 4's two ticks on an unsharded CPU fleet of 48 documents."""
    n_docs, list_ops = 48, 6
    ticks = [cs.gen_mixed_docs(n_docs, list_ops),
             cs.gen_tick2(n_docs, list_ops)]
    ids = [f'doc{d}' for d in range(n_docs)]
    sub = list(range(0, n_docs, 5))
    plain = GeneralDocSet(n_docs, device='cpu')
    diffs = []
    for batch in ticks:
        plain.apply_changes_batch({ids[d]: batch[d] for d in range(n_docs)})
        diffs.append({ids[d]: plain.last_patch.diffs(plain.id_of[ids[d]])
                      for d in sub})
    return ticks, ids, plain, plain.materialize_all(), diffs, sub


def test_mesh_of_builds_four_entries():
    mesh = cs.mesh_of('cpu')
    assert mesh.devices.size == 4
    cs._mesh_collectives(mesh, CARD)


def test_sharded_fleet_and_capture(fleet, counts):
    ticks, ids, plain, views, diffs, sub = fleet
    mesh = cs.mesh_of('cpu')
    cs._mesh_fleet(mesh, CARD, counts, ticks, ids, plain, views, diffs, sub,
                   [1.0, 1.0], dev='cpu', n_migrate=12)
    cs._mesh_capture(mesh, CARD, counts, ticks[0], dev='cpu')


def test_engine_and_peers(counts):
    cs._mesh_engine(cs.mesh_of('cpu'), CARD, counts, cs.gen_map_fleet(24),
                    dev='cpu')
    cs._mesh_peers(CARD, counts, dev='cpu', n_ops=128, n_keys=32,
                   windows=(8, 64))


def test_peer_ops_hold_contiguous_chains():
    seg_id, actor, seq, clock, is_del, valid, peer_clock = cs.peer_ops(
        n_ops=64, n_keys=16)
    assert seg_id.shape == (4, 64) and clock.shape == (4, 64, 16)
    for p in range(4):
        for a in range(4 * p, 4 * p + 4):
            np.testing.assert_array_equal(np.sort(seq[p][actor[p] == a]),
                                          np.arange(1, 17))
        assert (peer_clock[p] == np.bincount(actor[p], minlength=16)).all()


def test_hot_shard_dense_and_scaling(counts):
    mesh = cs.mesh_of('cpu')
    cs._mesh_hot_shard(CARD, counts, dev='cpu', scale='smoke')
    cs._mesh_dense(mesh, CARD, 1.0, dev='cpu', iters=2,
                   block=gen_block_workload(n_docs=32, n_actors=4,
                                            ops_per_change=4))
    out = cs._mesh_scaling(mesh, CARD, counts, dev='cpu', n_docs=32,
                           requests=8)
    assert sorted(out) == [1, 4]
