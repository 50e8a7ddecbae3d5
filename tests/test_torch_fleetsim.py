"""The fleet simulator, the round's digest check: the PyTorch port's
``fleetsim`` (over its serving, control, chaos and general-engine
stack, on the CPU) against the JAX package's.

``build_schedule`` is a pure function: its schedules and digests must
equal the reference's for every scenario at both scales (and a
second seed at the smoke scale). At the ``TINY`` scale of
``tests/test_fleetsim.py`` (zipf, the flash crowd with the controller
on and off, the reconnect storm) the port's run must land the reference's views, per-doc state digests,
verdict, control actions and every scorecard field that reads no clock
(the events compared without their timestamps), and equal its own
dict-path oracle. ``hot_shard`` (one sharded node over a mesh of
logical CPU entries) at the smoke scale must land the reference's
verdicts — green with the controller, red without —, migrations,
settled imbalance, control actions, views and digests."""

import os
import pickle
import subprocess
import sys

import pytest
import torch

from automerge_tpu_torch import fleetsim
from automerge_tpu_torch.utils.metrics import metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_metrics():
    """Each test starts and ends with both packages' registries empty."""
    from automerge_tpu.utils.metrics import metrics as jmetrics
    from automerge_tpu_torch.utils.metrics import metrics as tmetrics
    jmetrics.reset()
    tmetrics.reset()
    yield
    jmetrics.reset()
    tmetrics.reset()

# the scales of tests/test_fleetsim.py TINY
TINY = {
    'zipf': dict(n_nodes=2, n_docs=12, ticks=10, drain=40,
                 ops_per_tick=6, alpha=1.1),
    'flash_crowd': dict(
        n_nodes=2, n_docs=12, ticks=20, drain=24, base_ops=3,
        resident_docs=4, crowd_ops=8, crowd_start=4, crowd_end=18,
        hot_actors=4, budget_factor=1.8,
        slo={'peak_memory_pressure': 1.2, 'non_green_polls_max': 4},
        controller_kwargs=dict(hold=2, cooldown=4, mem_high=0.75,
                               compact_cooldown=6)),
    'reconnect_storm': dict(n_nodes=3, n_docs=12, ticks=20, drain=80,
                            ops_per_tick=5, alpha=1.1,
                            partition_at=5, heal_at=14),
}

# scorecard fields read from a clock (wall time, the convergence
# timer); everything else must match the reference exactly
CLOCKED = ('wall_s', 'ops_per_sec', 'convergence_ms_p99', 'events')

RUNS = (('zipf', True), ('flash_crowd', True), ('flash_crowd', False),
        ('reconnect_storm', True))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('scale', ['smoke', 'full'])
@pytest.mark.parametrize('scenario', sorted(fleetsim.SCENARIOS))
def test_schedules_and_digests_match_reference(scenario, scale):
    from automerge_tpu import fleetsim as jfleetsim
    assert sorted(jfleetsim.SCENARIOS) == sorted(fleetsim.SCENARIOS)
    for seed in (fleetsim.DEFAULT_SEED, 3)[:2 if scale == 'smoke' else 1]:
        want = jfleetsim.build_schedule(scenario, seed=seed, scale=scale)
        got = fleetsim.build_schedule(scenario, seed=seed, scale=scale)
        assert got['digest'] == want['digest']
        assert got == want


def _run(pkg, pkg_metrics, scenario, controller, **kw):
    pkg_metrics.reset()
    sched = pkg.build_schedule(scenario, seed=5, scale=TINY[scenario])
    out = pkg.FleetSim(schedule=sched, controller=controller,
                       collect_views=True, **kw).run()
    counters = dict(pkg_metrics.snapshot())
    pkg_metrics.reset()
    return sched, out, counters


def _unclocked(result):
    out = {k: v for k, v in result.items() if k not in CLOCKED}
    checks = dict(out['checks'])
    conv = dict(checks['convergence_ms_p99'])
    conv.pop('value')
    checks['convergence_ms_p99'] = conv
    out['checks'] = checks
    out['events'] = [{k: v for k, v in e.items() if k not in ('ts', 'mono')}
                     for e in result['events']]
    return out


def _reference_runs():
    """The JAX package's runs of ``RUNS`` (scorecard and counters) and
    its oracle of the zipf schedule."""
    from automerge_tpu import fleetsim as jfleetsim
    from automerge_tpu.utils.metrics import metrics as jmetrics
    out = {run: _run(jfleetsim, jmetrics, *run)[1:] for run in RUNS}
    out['oracle'] = jfleetsim.run_oracle(jfleetsim.build_schedule(
        'zipf', seed=5, scale=TINY['zipf']))
    for controller in (True, False):
        out['hot_shard', controller] = jfleetsim.run_scenario(
            'hot_shard', controller=controller, collect_views=True)
    return out


@pytest.fixture(scope='module')
def reference():
    """:func:`_reference_runs` in a fresh interpreter: the JAX
    package's fleets compile thousands of XLA programs, each holding
    memory maps, and one process may hold 65,530 (vm.max_map_count);
    they leave with the subprocess instead of crowding the worker that
    runs the next test files."""
    code = ('import pickle, sys; sys.path[:0] = sys.argv[1:3]; '
            'import test_torch_fleetsim as t; '
            'sys.stdout.buffer.write(pickle.dumps(t._reference_runs()))')
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               JAX_COMPILATION_CACHE_DIR=os.path.join(ROOT, '.jax_cache'),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS='0.5')
    done = subprocess.run(
        [sys.executable, '-c', code, ROOT, os.path.join(ROOT, 'tests')],
        capture_output=True, env=env, cwd=ROOT, timeout=900)
    assert done.returncode == 0, done.stderr.decode()[-4000:]
    return pickle.loads(done.stdout)


@pytest.mark.parametrize('scenario,controller', RUNS)
def test_tiny_run_matches_reference(reference, scenario, controller):
    want, jcounters = reference[(scenario, controller)]
    sched, got, tcounters = _run(fleetsim, metrics, scenario, controller,
                                 device='cpu')
    assert got['views'] == want['views']
    assert got['state_digests'] == want['state_digests']
    assert got['state_digests']
    assert got['verdict'] == want['verdict']
    assert got['control_actions'] == want['control_actions']
    assert _unclocked(got) == _unclocked(want)
    for name in ('sim_ticks', 'sim_ops_injected', 'sim_actors_spawned',
                 'serving_evictions', 'control_compactions'):
        assert tcounters.get(name) == jcounters.get(name), name
    # every node converged to the port's own clean dict-path oracle
    oracle = fleetsim.run_oracle(sched, device='cpu')
    assert set(got['views']) == set(oracle[:1])
    if scenario == 'flash_crowd':
        assert got['verdict'] == ('green' if controller else 'red')
        assert bool(got['control_actions']) == controller
    else:
        assert got['verdict'] == 'green'


def test_oracle_matches_reference(reference):
    sched = fleetsim.build_schedule('zipf', seed=5, scale=TINY['zipf'])
    assert fleetsim.run_oracle(sched, device='cpu') == reference['oracle']


# the sharded scorecard's fields that read no clock and name no device
SHARDED_FIELDS = ('scenario', 'seed', 'controller', 'verdict', 'checks',
                  'n_ops', 'n_actors', 'peak_resident_bytes',
                  'non_green_polls', 'polls', 'final_health',
                  'shard_imbalance', 'migrations', 'control_actions',
                  'control_action_total', 'schedule_digest',
                  'state_digests', 'views')


@pytest.mark.parametrize('controller', [True, False])
def test_hot_shard_matches_reference(reference, controller):
    want = reference['hot_shard', controller]
    got = fleetsim.run_scenario('hot_shard', controller=controller,
                                collect_views=True, device='cpu')
    for name in SHARDED_FIELDS:
        assert got[name] == want[name], name
    strip = [{k: v for k, v in row.items() if k != 'device'}
             for row in got['per_shard']]
    assert strip == [{k: v for k, v in row.items() if k != 'device'}
                     for row in want['per_shard']]
    assert got['verdict'] == ('green' if controller else 'red')
    if controller:
        assert got['migrations'] >= 1 and got['shard_imbalance'] <= 2.2
        assert got['control_actions'].get('migrate', 0) >= 1
    else:
        assert got['migrations'] == 0 and not got['control_actions']
    sched = fleetsim.build_schedule('hot_shard')
    assert got['views'] == fleetsim.run_oracle(sched, device='cpu')
    assert 'hot_shard' in fleetsim.ADAPTIVE_SCENARIOS


def test_entry_points_resolve_their_device():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    sched = fleetsim.build_schedule('zipf', seed=5, scale=TINY['zipf'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fleetsim.FleetSim(schedule=sched)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fleetsim.run_oracle(sched)
    from automerge_tpu_torch.sync.chaos import replay_schedule_over_sockets
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        replay_schedule_over_sockets(sched)
