"""The sharded batch merge: the PyTorch port's
``parallel/docset_engine.py`` against the JAX package's, the JAX side
on the 8 forced host devices of ``tests/conftest.py`` and the port's on
8 (and 3) logical CPU mesh entries. The same seeded change lists go
through both; the per-doc fields, the kernel outputs (dtypes included)
and the psum'd stats must be equal, bit for bit."""

import random

import numpy as np
import pytest
import torch

from automerge_tpu_torch.config import Options
from automerge_tpu_torch.device import engine as tengine
from automerge_tpu_torch.device import packing as tpacking
from automerge_tpu_torch.parallel import docset_engine as tde
from automerge_tpu_torch.parallel.mesh import make_mesh, shard_docs

torch.set_num_threads(1)

ROOT_ID = '00000000-0000-0000-0000-000000000000'


def random_doc_changes(rng, n_actors=3, n_changes=6, n_keys=4):
    """tests/test_device.py's generator: causal chains with random
    happened-before edges, sets and deletes over a few root keys."""
    actors = sorted(f'actor-{rng.randrange(1000):03d}-{i}'
                    for i in range(n_actors))
    seqs = {a: 0 for a in actors}
    clock_seen = {a: {} for a in actors}
    changes = []
    for _ in range(n_changes):
        a = rng.choice(actors)
        seqs[a] += 1
        deps = dict(clock_seen[a])
        deps.pop(a, None)
        ops = []
        for _ in range(rng.randrange(1, 4)):
            key = f'k{rng.randrange(n_keys)}'
            if rng.random() < 0.2:
                ops.append({'action': 'del', 'obj': ROOT_ID, 'key': key})
            else:
                ops.append({'action': 'set', 'obj': ROOT_ID, 'key': key,
                            'value': f'{a}:{seqs[a]}:{key}'})
        changes.append({'actor': a, 'seq': seqs[a], 'deps': deps,
                        'ops': ops})
        clock_seen[a][a] = seqs[a]
        if rng.random() < 0.5:
            b = rng.choice(actors)
            for actor_k, s in clock_seen[b].items():
                clock_seen[a][actor_k] = max(clock_seen[a].get(actor_k, 0),
                                             s)
    return changes


def _docs(seed, n_docs):
    rng = random.Random(seed)
    return [random_doc_changes(rng, n_changes=8) for _ in range(n_docs)]


def _jax_mesh(n):
    import jax
    from automerge_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < n:
        pytest.skip(f'needs {n} host devices')
    return jmake_mesh(n)


@pytest.mark.parametrize('n_dev,n_docs,seed', [(8, 11, 0), (8, 16, 1),
                                               (3, 7, 2)])
def test_engine_matches_reference(n_dev, n_docs, seed):
    from automerge_tpu.parallel.docset_engine import \
        ShardedDocSetEngine as JEngine
    docs = _docs(seed, n_docs)
    want, want_stats = JEngine(_jax_mesh(n_dev)).apply_changes_batch(docs)
    got, stats = tde.ShardedDocSetEngine(
        make_mesh(n_dev, device='cpu')).apply_changes_batch(docs)
    assert got == want
    assert stats == want_stats
    assert stats['ops_applied'] > 0 and stats['conflicts'] > 0
    # and the single-device engine on the same batch
    assert got == tengine.batch_merge_docs(docs, device='cpu')


@pytest.mark.parametrize('kernel', ['auto', 'xla'])
def test_merge_step_outputs_bit_equal(kernel):
    import jax.numpy as jnp
    from automerge_tpu.parallel import docset_engine as jde
    from automerge_tpu.parallel.mesh import shard_docs as jshard_docs
    docs = _docs(3, 16)
    packed = [tpacking.pack_assignments(c) for c in docs]
    arrays = tpacking.pad_and_stack(packed)[:6]
    S = Options().pad_segments(max(p.n_segments for p in packed))
    jmesh = _jax_mesh(8)
    jout, jstats = jde.sharded_merge_step(
        jmesh, *jshard_docs(jmesh, *(jnp.asarray(a) for a in arrays)),
        num_segments=S)
    mesh = make_mesh(8, device='cpu')
    out, stats = tde.sharded_merge_step(
        mesh, *shard_docs(mesh, *arrays), num_segments=S, kernel=kernel)
    for k in ('surviving', 'winner', 'seg_max_actor'):
        got = torch.cat(out[k]).numpy()
        want = np.asarray(jout[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k, v in stats.items():
        assert v.dtype == torch.int32 and int(v) == int(jstats[k]), k


def test_pallas_kernel_is_refused():
    with pytest.raises(ValueError, match='single-chip only'):
        tde.ShardedDocSetEngine(make_mesh(2, device='cpu'),
                                options=Options(kernel='pallas'))


def test_default_mesh_follows_the_device():
    eng = tde.ShardedDocSetEngine(options=Options(n_devices=2),
                                  device='cpu')
    assert eng.mesh.devices.size == 2
    docs = _docs(4, 5)
    got, _ = eng.apply_changes_batch(docs)
    assert got == tengine.batch_merge_docs(docs, device='cpu')
