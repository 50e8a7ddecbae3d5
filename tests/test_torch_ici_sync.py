"""Replica sync on one mesh: the PyTorch port's ``parallel/ici_sync.py``
against the JAX package's, the JAX side on the 8 forced host devices of
``tests/conftest.py``, the port's on 8 logical CPU peers. The same
seeded per-peer ops (tests/test_ici_sync.py's workload) go through
both: the all-gather round's union outputs, clocks and stats, the ring
round's outputs, and every delta round — the shipped and accepted
counts round by round and the buffers, counts and clocks after each —
must be equal, bit for bit."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.parallel import ici_sync as tici

torch.set_num_threads(1)

N_PEERS = 8
N_OPS = 16
N_SEGS = 12


def peer_workload(seed=0):
    """Each peer is one actor; its ops are sequential for itself and
    concurrent with every other peer."""
    rng = np.random.default_rng(seed)
    seg_id = rng.integers(0, N_SEGS, size=(N_PEERS, N_OPS)).astype(np.int32)
    actor = np.repeat(np.arange(N_PEERS, dtype=np.int32)[:, None], N_OPS, 1)
    seq = np.tile(np.arange(1, N_OPS + 1, dtype=np.int32), (N_PEERS, 1))
    clock = np.zeros((N_PEERS, N_OPS, N_PEERS), dtype=np.int32)
    p_idx, o_idx = np.indices((N_PEERS, N_OPS))
    clock[p_idx, o_idx, actor] = seq - 1
    is_del = rng.random((N_PEERS, N_OPS)) < 0.05
    valid = np.ones((N_PEERS, N_OPS), dtype=bool)
    peer_clock = np.zeros((N_PEERS, N_PEERS), dtype=np.int32)
    peer_clock[np.arange(N_PEERS), np.arange(N_PEERS)] = N_OPS
    return seg_id, actor, seq, clock, is_del, valid, peer_clock


@pytest.fixture(scope='module')
def meshes():
    import jax
    from automerge_tpu.parallel import ici_sync as jici
    if len(jax.devices()) < N_PEERS:
        pytest.skip('needs 8 host devices')
    return jici.make_peer_mesh(N_PEERS), \
        tici.make_peer_mesh(N_PEERS, device='cpu')


def _host(xs):
    """Per-peer port blocks as one numpy array [P, ...]."""
    return torch.cat(xs).numpy()


def _eq(got, want, what):
    want = np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_sync_step_matches_reference(meshes):
    from automerge_tpu.parallel import ici_sync as jici
    jmesh, mesh = meshes
    args = peer_workload(1)
    jout, jclocks, jstats = jici.sync_step(
        jmesh, *jici.shard_peers(jmesh, *args), num_segments=N_SEGS)
    out, clocks, stats = tici.sync_step(
        mesh, *tici.shard_peers(mesh, *args), num_segments=N_SEGS)
    for k in ('surviving', 'winner', 'seg_max_actor'):
        _eq(_host(out[k]), jout[k], k)
        assert len(out[k]) == N_PEERS and out[k][0].shape[0] == 1
    _eq(_host(clocks), jclocks, 'clocks')
    for k in ('ops_exchanged', 'ops_surviving'):
        assert stats[k].dtype == torch.int32 and int(stats[k]) == \
            int(jstats[k]), k
    assert int(stats['ops_exchanged']) == N_PEERS * N_OPS


def test_ring_sync_step_matches_reference(meshes):
    from automerge_tpu.parallel import ici_sync as jici
    jmesh, mesh = meshes
    args = peer_workload(2)[:6]
    jout = jici.ring_sync_step(jmesh, *jici.shard_peers(jmesh, *args),
                               num_segments=N_SEGS)
    out = tici.ring_sync_step(mesh, *tici.shard_peers(mesh, *args),
                              num_segments=N_SEGS)
    for k in ('surviving', 'winner', 'seg_max_actor'):
        _eq(_host(out[k]), jout[k], k)


def _state_eq(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(_host(g), w, f'{what} state[{i}]')


@pytest.mark.parametrize('ring,window', [(False, 64), (True, 64),
                                         (False, 8), (True, 5),
                                         (False, 1000)])
def test_delta_rounds_match_reference_round_by_round(meshes, ring, window):
    """Every round: equal shipped and accepted counts and equal buffers,
    counts and clocks; the log ends in 0 and each peer's converged
    buffer resolves to the one-shot union's outcome."""
    from automerge_tpu.parallel import ici_sync as jici
    jmesh, mesh = meshes
    seg_id, actor, seq, clock, is_del, valid, _ = peer_workload(3)
    # peers start with different prefixes of their own chains
    valid = np.arange(N_OPS)[None, :] < (4 + 2 * np.arange(N_PEERS))[:, None]
    n_cap = N_PEERS * N_OPS
    jstate = jici.make_delta_state(jmesh, seg_id, actor, seq, clock,
                                   is_del, valid, n_cap=n_cap)
    state = tici.make_delta_state(mesh, seg_id, actor, seq, clock, is_del,
                                  valid, n_cap=n_cap)
    _state_eq(state, jstate, 'initial')
    log = []
    for r in range(200):
        jstate, jshipped, jaccepted = jici.delta_sync_round(
            jmesh, jstate, window=window, ring=ring)
        state, shipped, accepted = tici.delta_sync_round(
            mesh, state, window=window, ring=ring)
        assert (shipped, accepted) == (jshipped, jaccepted), r
        _state_eq(state, jstate, f'round {r}')
        log.append(shipped)
        if shipped == 0:
            break
    assert log[-1] == 0 and log[0] > 0
    assert max(log) <= N_PEERS * window
    got_state, got_log = tici.delta_sync_converge(
        mesh, tici.make_delta_state(mesh, seg_id, actor, seq, clock,
                                    is_del, valid, n_cap=n_cap),
        window=window, ring=ring)
    assert got_log == log
    # every peer's buffer resolves like the union of the held ops
    from automerge_tpu_torch.device.merge import _resolve
    held = valid.reshape(-1)
    ref = _resolve(*(torch.as_tensor(a.reshape((-1,) + a.shape[2:]))
                     for a in (seg_id, actor, seq, clock, is_del)),
                   torch.as_tensor(held), num_segments=N_SEGS)
    for p in range(N_PEERS):
        got = _resolve(*(x[p][0] for x in got_state[:6]),
                       num_segments=N_SEGS)
        assert torch.equal(got['seg_max_actor'], ref['seg_max_actor'])
        assert int(got['surviving'].sum()) == int(ref['surviving'].sum())


def test_delta_round_accepts_a_partial_tail(meshes):
    """A capacity short of the union: rows past it are rejected, the
    clock never runs ahead of the stored ops — as in the reference."""
    from automerge_tpu.parallel import ici_sync as jici
    jmesh, mesh = meshes
    args = peer_workload(4)[:6]
    n_cap = N_OPS * 3
    jstate = jici.make_delta_state(jmesh, *args, n_cap=n_cap)
    state = tici.make_delta_state(mesh, *args, n_cap=n_cap)
    for _ in range(3):
        jstate, js, ja = jici.delta_sync_round(jmesh, jstate, window=32)
        state, s, a = tici.delta_sync_round(mesh, state, window=32)
        assert (s, a) == (js, ja)
        _state_eq(state, jstate, 'capped')


def test_make_delta_state_errors():
    """The same validation errors, with the reference's messages."""
    from automerge_tpu.parallel import ici_sync as jici
    mesh = tici.make_peer_mesh(N_PEERS, device='cpu')
    seg_id, actor, seq, clock, is_del, valid, _ = peer_workload()
    holes = valid.copy()
    holes[2, 3] = False
    gap = seq.copy()
    gap[5, -1] = N_OPS + 3
    for cols, match in (
            ((seg_id, actor, seq, clock, is_del, holes),
             'peer 2: valid rows must form a contiguous prefix'),
            ((seg_id, actor, gap, clock, is_del, valid),
             r'peer 5, actor 5: held seqs must be contiguous from 1 '
             r'\(max seq 19, 16 ops held\)')):
        with pytest.raises(ValueError, match=match) as got:
            tici.make_delta_state(mesh, *cols, n_cap=N_PEERS * N_OPS)
        with pytest.raises(ValueError) as want:
            jici.make_delta_state(None, *cols, n_cap=N_PEERS * N_OPS)
        assert str(got.value) == str(want.value)


def test_one_peer_per_mesh_entry():
    mesh = tici.make_peer_mesh(4, device='cpu')
    args = peer_workload()
    with pytest.raises(ValueError, match='2 peers share one mesh entry'):
        tici.sync_step(mesh, *tici.shard_peers(mesh, *args),
                       num_segments=N_SEGS)
