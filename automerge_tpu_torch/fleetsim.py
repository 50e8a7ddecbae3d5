"""Fleet workload simulator: named production traffic shapes, scored
by SLO scorecards, driving the closed-loop controller.

The chaos harness (:mod:`~.sync.chaos`) proves correctness under
transport FAULTS; nothing before this module proved behavior under
production TRAFFIC SHAPES — heavy-tailed popularity, diurnal load,
flash crowds, reconnect storms, actor churn. This simulator turns the
ROADMAP's "handles as many scenarios as you can imagine" into a
regression-tested matrix:

- **Deterministic, seeded schedules** — :func:`build_schedule` is a
  pure function of (scenario, seed, scale): every write (actor, seq,
  deps, ops), every partition/heal event, laid out per tick and
  digestible (``schedule_digest``). Two runs from one seed replay the
  byte-identical schedule and land byte-identical per-doc state
  digests — across the numpy and forced-native lanes too
  (tests/test_fleetsim.py).
- **Serving-stack fleets** — each node is a
  :class:`~.sync.serving.ServingDocSet` over a
  :class:`~.sync.general_doc_set.GeneralDocSet`, wired full-mesh
  through :class:`~.sync.chaos.ChaosFleet`'s
  :class:`~.sync.resilient.ResilientConnection` fabric on the
  columnar wire path — the exact production stack, logical time only.
- **SLO scorecards from the telemetry surface ONLY** — every check
  reads what an operator could read: ``fleet_status()`` health/
  latency/memory/convergence blocks, the replication-lag gauges, the
  ``sync_convergence_ms`` histogram, admission debt and backpressure
  depth, quarantine/divergence totals, and the heartbeat digest maps
  (replica-equality proof from the divergence-audit surface). The
  simulator's own bookkeeping (it knows every write it made) is
  deliberately never consulted for a verdict.
- **Closed-loop control** — with ``controller=True`` each node gets a
  :class:`~.sync.control.FleetController`; the acceptance matrix
  (``ADAPTIVE_SCENARIOS``) contains scenarios that demonstrably end
  RED with the controller disabled and GREEN with it enabled: the
  flash crowd (memory pressure the controller relieves by lowering
  the eviction watermark and scheduling compaction) and the diurnal
  peak (admission backpressure the controller relieves by widening
  token rates under sustained busy + low debt utilization).

``bench_fleet_sim`` (bench.py) runs the matrix as perf-gate lanes —
per-scenario ``fleet_sim_*`` JSON keys banded in PERF_BUDGETS.json —
and ``--trace-out`` dumps the load curve, health transitions and
controller actions as one Perfetto track set
(``tools/trace_report.py --scenario`` prints the same artifacts as a
per-scenario table).

The PyTorch port's copy of ``automerge_tpu/fleetsim.py``: the same
schedules and digests; :class:`FleetSim`, :func:`run_scenario` and
:func:`run_oracle` take ``device`` (None is the card, raising without
one); ``hot_shard``'s sharded node lives on a mesh over ``device``.
"""

import hashlib
import json
import os
import shutil
import tempfile
import time
from bisect import bisect_left

from .common import ROOT_ID
from .config import resolve_device
from .sync.chaos import ChaosFleet, canonical, doc_set_view
from .sync.control import FleetController
from .sync.general_doc_set import GeneralDocSet
from .sync.serving import ServingDocSet
from .utils.metrics import metrics

DEFAULT_SEED = 1307
_HEALTH_RANK = {'green': 0, 'degraded': 1, 'critical': 2}

# The scenario catalog. Each entry carries a 'smoke' scale (CI: small
# fleets, seconds per scenario) and a 'full' scale (bench lanes —
# actor churn crosses 100k simulated actors there). 'slo' overrides
# the scorecard defaults per scenario; 'admission' meters every
# node's shared inbound valve; 'budget_factor' arms a serving memory
# budget at that multiple of the post-seed resident bytes.
SCENARIOS = {
    'zipf': {
        'desc': 'heavy-tailed (Zipf) doc popularity, steady load',
        'smoke': dict(n_nodes=2, n_docs=48, ticks=24, drain=60,
                      ops_per_tick=16, alpha=1.1),
        'full': dict(n_nodes=3, n_docs=1024, ticks=40, drain=120,
                     ops_per_tick=256, alpha=1.1,
                     slo={'convergence_ms_p99_max': 600_000.0}),
    },
    'diurnal': {
        'desc': 'diurnal load curve over a metered admission valve; '
                'the peak overruns the configured token rate',
        'smoke': dict(n_nodes=2, n_docs=32, ticks=56, drain=24,
                      base_ops=3, peak_ops=36, peak_start=8,
                      peak_end=48,
                      admission={'changes_per_tick': 8,
                                 'burst_ticks': 2}),
        # the full scale keeps the SMOKE tick structure (verified
        # red-uncontrolled / green-controlled) and scales the op and
        # doc axes: same peak/rate overrun ratio, same backlog-vs-
        # drain shape, so the verdict dynamics carry over
        'full': dict(n_nodes=2, n_docs=512, ticks=56, drain=24,
                     base_ops=18, peak_ops=216, peak_start=8,
                     peak_end=48,
                     admission={'changes_per_tick': 48,
                                'burst_ticks': 2},
                     slo={'convergence_ms_p99_max': 600_000.0}),
    },
    'flash_crowd': {
        'desc': 'one doc goes viral: update-heavy hot writes under a '
                'serving memory budget (background traffic stays on '
                'a small resident working set; the cold tail parks '
                'once and stays parked)',
        'smoke': dict(n_nodes=2, n_docs=24, ticks=36, drain=24,
                      base_ops=4, resident_docs=6, crowd_ops=12,
                      crowd_start=8, crowd_end=32, hot_actors=8,
                      budget_factor=1.8,
                      slo={'peak_memory_pressure': 1.2,
                           'non_green_polls_max': 4},
                      controller_kwargs=dict(
                          hold=2, cooldown=4, mem_high=0.75,
                          compact_cooldown=6)),
        # full scale = the smoke tick structure with the op/doc axes
        # scaled (see diurnal note)
        'full': dict(n_nodes=2, n_docs=256, ticks=36, drain=24,
                     base_ops=16, resident_docs=12, crowd_ops=96,
                     crowd_start=8, crowd_end=32, hot_actors=32,
                     budget_factor=1.8,
                     slo={'peak_memory_pressure': 1.2,
                          'non_green_polls_max': 8,
                          'convergence_ms_p99_max': 600_000.0},
                     controller_kwargs=dict(
                         hold=2, cooldown=4, mem_high=0.75,
                         compact_cooldown=6)),
    },
    'reconnect_storm': {
        'desc': 'a node partitions mid-load and heals: the reconnect '
                'storm must converge through the normal protocol',
        'smoke': dict(n_nodes=3, n_docs=48, ticks=40, drain=120,
                      ops_per_tick=10, alpha=1.1, partition_at=10,
                      heal_at=28),
        'full': dict(n_nodes=3, n_docs=256, ticks=48, drain=160,
                     ops_per_tick=64, alpha=1.1, partition_at=10,
                     heal_at=32,
                     slo={'convergence_ms_p99_max': 600_000.0}),
    },
    'actor_churn': {
        'desc': 'every tick mints fresh actors that write once and '
                'vanish (100k+ actors at full scale)',
        'smoke': dict(n_nodes=2, n_docs=48, ticks=24, drain=60,
                      spawn_per_tick=40),
        # 16 ticks x 6400 spawns + 512 seed actors = 102,912 distinct
        # actors (node choice does NOT multiply the count): big fused
        # batches amortize the per-tick overhead far better than many
        # small ticks at this scale
        'full': dict(n_nodes=2, n_docs=512, ticks=16, drain=80,
                     spawn_per_tick=6400,
                     slo={'convergence_ms_p99_max': 600_000.0}),
    },
    'hot_shard': {
        'desc': 'zipf load over a sharded fleet whose docs all start '
                'pinned on shard 0 (worst-case initial placement): '
                'red without the placement knob, green once the '
                'controller drains hot docs to the cold shards',
        'smoke': dict(n_nodes=1, n_docs=32, ticks=22, drain=4,
                      ops_per_tick=32, alpha=1.1, n_shards=4,
                      slo={'shard_imbalance_max': 2.2,
                           'min_migrations': 1},
                      controller_kwargs=dict(
                          hold=2, cooldown=3, placement_min_ops=16,
                          placement_ratio=1.5, migrate_batch=3)),
        # full scale widens the doc/op axes and the mesh cut; the
        # skew/verdict dynamics are the smoke shape scaled up
        'full': dict(n_nodes=1, n_docs=256, ticks=36, drain=4,
                     ops_per_tick=256, alpha=1.1, n_shards=8,
                     slo={'shard_imbalance_max': 2.2,
                          'min_migrations': 1},
                     controller_kwargs=dict(
                         hold=2, cooldown=3, placement_min_ops=64,
                         placement_ratio=1.5, migrate_batch=8)),
    },
}

# Scenarios whose SLO verdict flips red -> green when the controller
# is enabled (the acceptance matrix bench_fleet_sim gates as
# fleet_sim_adaptive_wins).
ADAPTIVE_SCENARIOS = ('flash_crowd', 'diurnal', 'hot_shard')

# Scorecard defaults; per-scenario 'slo' entries override. Every
# bound grades a value read from the telemetry surface. The
# convergence bound detects STUCK convergence, not wall speed: the
# sim runs logical quanta whose wall cost is dominated by host jit
# dispatch, so the bound is generous (and is also installed as each
# node's convergence health threshold — a healthy simulated fleet
# must not read degraded just because the machine is slow).
DEFAULT_SLO = {
    'quarantined_max': 0,
    'diverged_max': 0,
    'final_health': 'green',
    'critical_polls_max': 0,
    'convergence_ms_p99_max': 120_000.0,
}


def _zipf_cdf(n, alpha):
    acc = 0.0
    out = []
    for i in range(n):
        acc += 1.0 / (i + 1) ** alpha
        out.append(acc)
    return out


def _mk_change(seqs, doc_id, actor, ops):
    seq = seqs.get((doc_id, actor), 0) + 1
    seqs[(doc_id, actor)] = seq
    return {'actor': actor, 'seq': seq,
            'deps': {actor: seq - 1} if seq > 1 else {}, 'ops': ops}


def _seed_changes(spec, seqs):
    """Tick-0 seed: every doc is born at its home node with a small
    list + a meta key (the bench's mixed-doc idiom, scaled down) —
    the fleet converges on this before the measured load starts."""
    writes = {}
    for d in range(spec['n_docs']):
        node = d % spec['n_nodes']
        doc_id = f'doc{d}'
        obj = f'00000000-0000-4000-8000-{d:012x}'
        ops = [{'action': 'makeList', 'obj': obj},
               {'action': 'link', 'obj': ROOT_ID, 'key': 'items',
                'value': obj},
               {'action': 'ins', 'obj': obj, 'key': '_head',
                'elem': 1},
               {'action': 'set', 'obj': obj, 'key': f's{d}:1',
                'value': d},
               {'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                'value': d}]
        writes.setdefault(node, {})[doc_id] = [
            _mk_change(seqs, doc_id, f's{d}', ops)]
    return writes


def build_schedule(scenario, seed=DEFAULT_SEED, scale='smoke'):
    """The full event schedule of one scenario run, as a pure
    function of (scenario, seed, scale): ``{'scenario', 'seed',
    'spec', 'ticks': [{'writes': [[node, doc_id, [change, ...]],
    ...], 'partition': [[a, b], ...], 'heal': [...]}, ...],
    'n_ops', 'n_actors', 'digest'}``. Tick 0 is the seed phase (the
    fleet converges on it before measurement starts); the digest is
    blake2b over the canonical JSON of everything else — the
    determinism comparand."""
    import random
    if scenario not in SCENARIOS:
        raise ValueError(f'unknown scenario {scenario!r} (have: '
                         f'{", ".join(sorted(SCENARIOS))})')
    spec = dict(SCENARIOS[scenario][scale]) if isinstance(scale, str) \
        else dict(scale)
    spec.setdefault('heartbeat_every', 8)
    # seeding from a string is PYTHONHASHSEED-independent (random
    # hashes the bytes), so the schedule is identical across processes
    rng = random.Random(f'{seed}:{scenario}')
    seqs = {}
    actors = set()
    n_ops = 0
    n_docs, n_nodes = spec['n_docs'], spec['n_nodes']
    cdf = _zipf_cdf(n_docs, spec.get('alpha', 1.1))

    def zipf_doc():
        return bisect_left(cdf, rng.random() * cdf[-1])

    ticks = [{'writes': _seed_changes(spec, seqs)}]
    for a in range(n_docs):
        actors.add(f's{a}')

    def add_write(tick, node, doc_id, actor, ops):
        nonlocal n_ops
        tick['writes'].setdefault(node, {}).setdefault(
            doc_id, []).append(_mk_change(seqs, doc_id, actor, ops))
        actors.add(actor)
        n_ops += len(ops)

    for t in range(1, spec['ticks'] + 1):
        tick = {'writes': {}}
        if scenario in ('zipf', 'reconnect_storm', 'hot_shard'):
            if scenario == 'reconnect_storm':
                if t == spec['partition_at']:
                    # sever node 0 from everyone: an isolated writer
                    tick['partition'] = [[0, b]
                                         for b in range(1, n_nodes)]
                if t == spec['heal_at']:
                    tick['heal'] = [[0, b] for b in range(1, n_nodes)]
            for i in range(spec['ops_per_tick']):
                d = zipf_doc()
                node = d % n_nodes
                add_write(tick, node, f'doc{d}', f'w{node}d{d}',
                          [{'action': 'set', 'obj': ROOT_ID,
                            'key': f'k{rng.randrange(8)}',
                            'value': f'v{t}x{i}'}])
        elif scenario == 'diurnal':
            lo, hi = spec['peak_start'], spec['peak_end']
            base, peak = spec['base_ops'], spec['peak_ops']
            if lo <= t < hi:
                mid = (lo + hi) / 2
                frac = 1.0 - abs(t - mid) / (mid - lo)
                ops = base + int((peak - base) * frac)
            else:
                ops = base
            for i in range(ops):
                d = rng.randrange(n_docs)
                node = d % n_nodes
                add_write(tick, node, f'doc{d}', f'w{node}d{d}',
                          [{'action': 'set', 'obj': ROOT_ID,
                            'key': f'k{rng.randrange(8)}',
                            'value': f'v{t}x{i}'}])
        elif scenario == 'flash_crowd':
            # background traffic cycles a SMALL resident working set
            # (docs 1..resident_docs stay hot and pinned); the seeded
            # cold tail beyond it is written once and never again, so
            # the budget squeeze parks it exactly once — the pressure
            # that remains is the viral doc itself, which only
            # compaction can shrink
            for i in range(spec['base_ops']):
                d = 1 + (t * spec['base_ops'] + i) % \
                    spec['resident_docs']
                node = d % n_nodes
                add_write(tick, node, f'doc{d}', f'w{node}d{d}',
                          [{'action': 'set', 'obj': ROOT_ID,
                            'key': f'k{rng.randrange(8)}',
                            'value': f'v{t}x{i}'}])
            if spec['crowd_start'] <= t < spec['crowd_end']:
                # the viral doc: update-heavy hot writes from a small
                # rotating actor set — history grows per tick while
                # the surviving state stays bounded (the compaction-
                # friendly shape the controller exploits)
                for i in range(spec['crowd_ops']):
                    j = (t * spec['crowd_ops'] + i) % \
                        spec['hot_actors']
                    add_write(tick, 0, 'doc0', f'h{j}',
                              [{'action': 'set', 'obj': ROOT_ID,
                                'key': f'c{i % 6}',
                                'value': f'{"pay" * 12}-{t}-{i}'}])
        elif scenario == 'actor_churn':
            for i in range(spec['spawn_per_tick']):
                d = rng.randrange(n_docs)
                node = rng.randrange(n_nodes)
                add_write(tick, node, f'doc{d}', f'c{t}x{i}',
                          [{'action': 'set', 'obj': ROOT_ID,
                            'key': f'u{i % 16}',
                            'value': f'{t}.{i}'}])
        ticks.append(tick)

    # canonical form: writes as sorted lists, not dicts keyed by int
    out_ticks = []
    for tick in ticks:
        rec = {'writes': [
            [node, doc_id, changes]
            for node in sorted(tick['writes'])
            for doc_id, changes in sorted(
                tick['writes'][node].items())]}
        for k in ('partition', 'heal'):
            if tick.get(k):
                rec[k] = tick[k]
        out_ticks.append(rec)
    body = {'scenario': scenario, 'seed': seed, 'spec': spec,
            'ticks': out_ticks}
    digest = hashlib.blake2b(
        json.dumps(body, sort_keys=True).encode(),
        digest_size=16).hexdigest()
    body['n_ops'] = n_ops
    body['n_actors'] = len(actors)
    body['digest'] = digest
    return body


class FleetSim:
    """One scenario run over the production serving stack.

    ``schedule`` — a :func:`build_schedule` result (or pass
    ``scenario``/``seed``/``scale`` to build one).
    ``controller`` — attach a :class:`FleetController` per node.
    ``collect_views`` — include each node's canonical materialized
    views in the result (the regression tests' comparand; never part
    of the SLO verdict).
    ``device`` — where every node's store lives (None is the card).
    """

    def __init__(self, scenario=None, seed=DEFAULT_SEED,
                 scale='smoke', controller=True, schedule=None,
                 collect_views=False, controller_kwargs=None,
                 device=None):
        self.device = resolve_device(device)
        self.schedule = schedule if schedule is not None else \
            build_schedule(scenario, seed, scale)
        self.controller = controller
        self.collect_views = collect_views
        self.controller_kwargs = dict(controller_kwargs or {})
        self._events = []              # health/control event collector

    # -- telemetry event collection ------------------------------------------

    def _collect(self, event):
        if event.get('event') in ('health_transition',
                                  'control_action'):
            self._events.append(dict(event))

    # -- the run -------------------------------------------------------------

    def run(self):
        spec = self.schedule['spec']
        scenario = self.schedule['scenario']
        if spec.get('n_shards'):
            return self._run_sharded(spec, scenario)
        n_nodes = spec['n_nodes']
        hb = spec['heartbeat_every']
        # per-link counter slices of earlier fleets in this process
        # would bleed into health deltas under the same node names —
        # the peer-churn hook wipes them; the convergence series is
        # scoped to this run like the bench lanes scope theirs
        metrics.drop_scope('node/')
        metrics.reset_series('sync_convergence_ms')
        metrics.bump('sim_scenario_runs')
        metrics.bump('sim_actors_spawned', self.schedule['n_actors'])
        tmp = tempfile.mkdtemp(prefix=f'amtpu-fleetsim-{scenario}-')
        capacity = spec['n_docs'] + 8
        doc_sets = [
            ServingDocSet(GeneralDocSet(capacity, device=self.device),
                          os.path.join(tmp, f'node{i}'))
            for i in range(n_nodes)]
        admission = spec.get('admission')
        fleet = ChaosFleet(
            doc_sets, seed=self.schedule['seed'] + 1, batching=True,
            wire=True, heartbeat_every=hb,
            admission=dict(admission) if admission else None)
        conv_bound = spec.get('slo', {}).get(
            'convergence_ms_p99_max',
            DEFAULT_SLO['convergence_ms_p99_max'])
        for ds in doc_sets:
            ds.inner.health_thresholds['convergence_ms_p99'] = \
                (conv_bound, None)
        metrics.subscribe(self._collect)
        try:
            return self._run_traced(spec, scenario, doc_sets, fleet)
        finally:
            metrics.unsubscribe(self._collect)
            fleet.close()
            for ds in doc_sets:
                ds.close()
            shutil.rmtree(tmp, ignore_errors=True)

    def _apply_tick(self, tick, doc_sets, fleet):
        for pair in tick.get('partition', ()):
            fleet.partition(*pair)
        for pair in tick.get('heal', ()):
            fleet.heal(*pair)
        load = 0
        by_node = {}
        for node, doc_id, changes in tick['writes']:
            by_node.setdefault(node, {})[doc_id] = changes
            load += sum(len(c['ops']) for c in changes)
        for node, batch in by_node.items():
            doc_sets[node].apply_changes_batch(batch)
        metrics.bump('sim_ticks')
        if load:
            metrics.bump('sim_ops_injected', load)
        if metrics.active:
            # the load curve as a Perfetto counter track: one sample
            # per scheduling quantum
            metrics.emit('counter', sim_load_ops=load)
        fleet.tick()
        return load

    def _run_traced(self, spec, scenario, doc_sets, fleet):
        ticks = self.schedule['ticks']
        if metrics.active:
            metrics.emit('sim_scenario_start', scenario=scenario,
                         seed=self.schedule['seed'],
                         n_nodes=spec['n_nodes'],
                         n_docs=spec['n_docs'],
                         controller=self.controller)
        # seed phase: converge tick 0 before anything is measured
        self._apply_tick(ticks[0], doc_sets, fleet)
        fleet.run(max_ticks=4000)
        metrics.reset_series('sync_convergence_ms')
        self._events.clear()
        # arm the memory budgets off the POST-SEED resident estimate
        # (a telemetry read, deterministic from the schedule)
        factor = spec.get('budget_factor')
        if factor:
            for ds in doc_sets:
                resident = ds.fleet_status(
                    docs=False)['memory']['resident_bytes']
                ds.memory_budget_bytes = max(1, int(resident * factor))
        if self.controller:
            # per-scenario controller tuning from the spec; explicit
            # constructor kwargs win. Each controller attaches itself
            # to its serving node (ds.controller), which is where the
            # scorecard reads the action tallies back.
            kwargs = dict(spec.get('controller_kwargs', {}))
            kwargs.update(self.controller_kwargs)
            for ds in doc_sets:
                FleetController(ds, **kwargs)

        peak_resident = 0
        peak_pressure = 0.0
        non_green_polls = 0
        critical_polls = 0
        polls = 0
        t0 = time.perf_counter()

        def poll():
            nonlocal peak_resident, peak_pressure, non_green_polls, \
                critical_polls, polls
            polls += 1
            worst = 'green'
            for ds in doc_sets:
                st = ds.fleet_status(docs=False)
                peak_resident = max(peak_resident,
                                    st['memory']['resident_bytes'])
                p = st['health']['signals'].get('memory_pressure')
                if p:
                    peak_pressure = max(peak_pressure, p)
                if _HEALTH_RANK[st['health']['state']] > \
                        _HEALTH_RANK[worst]:
                    worst = st['health']['state']
            if worst != 'green':
                non_green_polls += 1
            if worst == 'critical':
                critical_polls += 1

        for i, tick in enumerate(ticks[1:]):
            self._apply_tick(tick, doc_sets, fleet)
            if i % 2 == 1:
                poll()
        # drain: logical time keeps running with zero load until no
        # DATA envelope is unacked anywhere for a few quanta and at
        # least two heartbeat periods have passed (the periodic beats
        # themselves never go quiet, so raw fabric silence is not the
        # signal) — or the scenario's drain budget runs out: an
        # unconverged end is a legitimate RED outcome, not a harness
        # failure
        quiet = 0
        hb = spec['heartbeat_every']
        empty = {'writes': []}
        for i in range(spec['drain']):
            self._apply_tick(empty, doc_sets, fleet)
            quiet = 0 if any(c.in_flight
                             for c in fleet.conns.values()) \
                else quiet + 1
            if i >= 2 * hb and quiet >= 4:
                break
        poll()
        dt = time.perf_counter() - t0
        return self._score(spec, scenario, doc_sets, dt,
                           dict(peak_resident=peak_resident,
                                peak_pressure=peak_pressure,
                                non_green_polls=non_green_polls,
                                critical_polls=critical_polls,
                                polls=polls))

    # -- the sharded-fleet lane (hot_shard) ----------------------------------

    def _run_sharded(self, spec, scenario):
        """A sharded-fleet scenario: one
        :class:`~.sync.sharded.ShardedGeneralDocSet` node whose docs
        all start PINNED on shard 0 (the deliberate worst-case
        placement), driven tick-by-tick with the controller's
        placement knob attached (or not — the red lane). The verdict
        reads only the telemetry surface: the placement block's
        imbalance, the migration tallies, quarantine/divergence totals
        and the health rollup."""
        from .parallel.mesh import make_mesh
        from .sync.sharded import ShardedGeneralDocSet
        metrics.drop_scope('node/')
        metrics.reset_series('sync_convergence_ms')
        metrics.bump('sim_scenario_runs')
        metrics.bump('sim_actors_spawned', self.schedule['n_actors'])
        sharded = ShardedGeneralDocSet(spec['n_docs'] + 8,
                                       n_shards=spec['n_shards'],
                                       mesh=make_mesh(device=self.device))
        for d in range(spec['n_docs']):
            sharded.placement.pin(f'doc{d}', 0)
        if self.controller:
            kwargs = dict(spec.get('controller_kwargs', {}))
            kwargs.update(self.controller_kwargs)
            FleetController(sharded, **kwargs)
        metrics.subscribe(self._collect)
        try:
            ticks = self.schedule['ticks']
            if metrics.active:
                metrics.emit('sim_scenario_start', scenario=scenario,
                             seed=self.schedule['seed'],
                             n_shards=spec['n_shards'],
                             n_docs=spec['n_docs'],
                             controller=self.controller)

            def apply_tick(tick):
                by_doc = {}
                load = 0
                for _, doc_id, changes in tick['writes']:
                    by_doc.setdefault(doc_id, []).extend(changes)
                    load += sum(len(c['ops']) for c in changes)
                if by_doc:
                    sharded.apply_changes_batch(by_doc)
                metrics.bump('sim_ticks')
                if load:
                    metrics.bump('sim_ops_injected', load)
                if metrics.active:
                    metrics.emit('counter', sim_load_ops=load)
                sharded.tick()

            apply_tick(ticks[0])       # seed phase
            self._events.clear()
            imbalances = []            # per loaded tick, from telemetry
            non_green_polls = 0
            critical_polls = 0
            polls = 0
            peak_resident = 0
            t0 = time.perf_counter()
            for i, tick in enumerate(ticks[1:]):
                apply_tick(tick)
                load = sharded.shard_load()
                if sum(load['apply_ops']):
                    imbalances.append(load['imbalance'])
                if i % 2 == 1:
                    polls += 1
                    st = sharded.fleet_status(docs=False)
                    peak_resident = max(
                        peak_resident,
                        st['memory']['device_plane_bytes'])
                    state = st['health']['state']
                    if state != 'green':
                        non_green_polls += 1
                    if state == 'critical':
                        critical_polls += 1
            for _ in range(spec.get('drain', 0)):
                apply_tick({'writes': []})
            dt = time.perf_counter() - t0
            return self._score_sharded(
                spec, scenario, sharded, dt, imbalances,
                dict(non_green_polls=non_green_polls,
                     critical_polls=critical_polls, polls=polls,
                     peak_resident=peak_resident))
        finally:
            metrics.unsubscribe(self._collect)

    def _score_sharded(self, spec, scenario, sharded, dt, imbalances,
                       polled):
        slo = dict(DEFAULT_SLO)
        slo.update(spec.get('slo', {}))
        status = sharded.fleet_status(docs=False)
        placement = status['placement']
        # the settled operating point: mean imbalance over the last
        # few LOADED quanta (the gauge the dashboards graph)
        tail = imbalances[-5:] if imbalances else [1.0]
        settled = sum(tail) / len(tail)
        final_health = status['health']['state']

        checks = {}

        def check(name, value, ok, bound):
            checks[name] = {'value': value, 'bound': bound,
                            'ok': bool(ok)}

        check('quarantined', status['totals']['quarantined'],
              status['totals']['quarantined'] <=
              slo['quarantined_max'], slo['quarantined_max'])
        check('diverged', status['totals']['diverged'],
              status['totals']['diverged'] <= slo['diverged_max'],
              slo['diverged_max'])
        check('final_health', final_health,
              _HEALTH_RANK[final_health] <=
              _HEALTH_RANK[slo['final_health']], slo['final_health'])
        check('critical_polls', polled['critical_polls'],
              polled['critical_polls'] <= slo['critical_polls_max'],
              slo['critical_polls_max'])
        check('shard_imbalance', round(settled, 3),
              settled <= slo['shard_imbalance_max'],
              slo['shard_imbalance_max'])
        if 'min_migrations' in slo:
            check('migrations', placement['migrations'],
                  placement['migrations'] >= slo['min_migrations'],
                  slo['min_migrations'])

        verdict = 'green' if all(c['ok'] for c in checks.values()) \
            else 'red'
        actions = dict(sharded.controller.actions) \
            if sharded.controller is not None else {}
        result = {
            'scenario': scenario,
            'seed': self.schedule['seed'],
            'controller': self.controller,
            'verdict': verdict,
            'checks': checks,
            'n_ops': self.schedule['n_ops'],
            'n_actors': self.schedule['n_actors'],
            'ops_per_sec': round(self.schedule['n_ops'] /
                                 max(dt, 1e-9), 1),
            'wall_s': round(dt, 3),
            'convergence_ms_p99': None,
            'peak_resident_bytes': polled['peak_resident'],
            'peak_memory_pressure': 0.0,
            'non_green_polls': polled['non_green_polls'],
            'polls': polled['polls'],
            'final_health': final_health,
            'shard_imbalance': round(settled, 3),
            'migrations': placement['migrations'],
            'per_shard': placement['per_shard'],
            'control_actions': actions,
            'control_action_total': sum(actions.values()),
            'schedule_digest': self.schedule['digest'],
            'state_digests': sharded.heartbeat_digests(),
            'events': list(self._events),
        }
        if self.collect_views:
            result['views'] = [canonical(doc_set_view(sharded))]
        if metrics.active:
            metrics.emit(
                'sim_scenario', scenario=scenario, verdict=verdict,
                controller=self.controller,
                ops_per_sec=result['ops_per_sec'],
                shard_imbalance=result['shard_imbalance'],
                migrations=result['migrations'],
                control_action_total=result['control_action_total'],
                failed=[n for n, c in checks.items()
                        if not c['ok']])
        return result

    # -- the SLO scorecard (telemetry surface only) --------------------------

    def _score(self, spec, scenario, doc_sets, dt, polled):
        slo = dict(DEFAULT_SLO)
        slo.update(spec.get('slo', {}))
        statuses = [ds.fleet_status(docs=False) for ds in doc_sets]
        quarantined = sum(s['totals']['quarantined']
                          for s in statuses)
        diverged = sum(s['totals']['diverged'] for s in statuses)
        lag = sum(s['convergence']['replication_lag_ops']
                  for s in statuses)
        births = sum(s['convergence']['pending_births']
                     for s in statuses)
        backpressure = sum(s['health']['signals']
                           .get('backpressure_depth', 0)
                           for s in statuses)
        final_health = max((s['health']['state'] for s in statuses),
                           key=lambda h: _HEALTH_RANK[h])
        conv_p99 = metrics.quantile('sync_convergence_ms', 0.99)
        # replica equality straight off the divergence-audit surface:
        # every node's heartbeat digest map must be PRESENT and
        # identical — a fleet whose digests are unavailable has not
        # proved anything, so None maps fail the check rather than
        # comparing vacuously equal
        digest_maps = [ds.heartbeat_digests() for ds in doc_sets]
        digests_ok = all(m is not None for m in digest_maps) and \
            all(m == digest_maps[0] for m in digest_maps[1:])

        checks = {}

        def check(name, value, ok, bound):
            checks[name] = {'value': value, 'bound': bound,
                            'ok': bool(ok)}

        check('quarantined', quarantined,
              quarantined <= slo['quarantined_max'],
              slo['quarantined_max'])
        check('diverged', diverged,
              diverged <= slo['diverged_max'], slo['diverged_max'])
        check('replicas_digest_equal', digests_ok, digests_ok, True)
        check('replication_lag_ops', lag, lag == 0, 0)
        check('pending_births', births, births == 0, 0)
        check('backpressure_depth', backpressure, backpressure == 0,
              0)
        check('final_health', final_health,
              _HEALTH_RANK[final_health] <=
              _HEALTH_RANK[slo['final_health']], slo['final_health'])
        check('critical_polls', polled['critical_polls'],
              polled['critical_polls'] <= slo['critical_polls_max'],
              slo['critical_polls_max'])
        if conv_p99 is not None:
            check('convergence_ms_p99', round(conv_p99, 2),
                  conv_p99 <= slo['convergence_ms_p99_max'],
                  slo['convergence_ms_p99_max'])
        if 'peak_memory_pressure' in slo:
            check('peak_memory_pressure',
                  round(polled['peak_pressure'], 4),
                  polled['peak_pressure'] <=
                  slo['peak_memory_pressure'],
                  slo['peak_memory_pressure'])
        if 'non_green_polls_max' in slo:
            check('non_green_polls', polled['non_green_polls'],
                  polled['non_green_polls'] <=
                  slo['non_green_polls_max'],
                  slo['non_green_polls_max'])

        verdict = 'green' if all(c['ok'] for c in checks.values()) \
            else 'red'
        actions = {}
        for ds in doc_sets:
            if ds.controller is not None:
                for name, n in ds.controller.actions.items():
                    actions[name] = actions.get(name, 0) + n
        result = {
            'scenario': scenario,
            'seed': self.schedule['seed'],
            'controller': self.controller,
            'verdict': verdict,
            'checks': checks,
            'n_ops': self.schedule['n_ops'],
            'n_actors': self.schedule['n_actors'],
            'ops_per_sec': round(self.schedule['n_ops'] /
                                 max(dt, 1e-9), 1),
            'wall_s': round(dt, 3),
            'convergence_ms_p99': round(conv_p99, 2)
            if conv_p99 is not None else None,
            'peak_resident_bytes': polled['peak_resident'],
            'peak_memory_pressure': round(polled['peak_pressure'], 4),
            'non_green_polls': polled['non_green_polls'],
            'polls': polled['polls'],
            'final_health': final_health,
            'control_actions': actions,
            'control_action_total': sum(actions.values()),
            'schedule_digest': self.schedule['digest'],
            # node-0's digest map: the determinism comparand of the
            # replay tests (all nodes' maps are equal when
            # replicas_digest_equal holds)
            'state_digests': digest_maps[0],
            'events': list(self._events),
        }
        if self.collect_views:
            result['views'] = [canonical(doc_set_view(ds))
                               for ds in doc_sets]
        if metrics.active:
            metrics.emit(
                'sim_scenario', scenario=scenario, verdict=verdict,
                controller=self.controller,
                ops_per_sec=result['ops_per_sec'],
                convergence_ms_p99=result['convergence_ms_p99'],
                peak_resident_bytes=result['peak_resident_bytes'],
                control_action_total=result['control_action_total'],
                failed=[n for n, c in checks.items()
                        if not c['ok']])
        return result


def run_scenario(scenario, seed=DEFAULT_SEED, scale='smoke',
                 controller=True, collect_views=False,
                 controller_kwargs=None, device=None):
    """Build the schedule and run it once on ``device``; returns the
    scorecard."""
    return FleetSim(scenario, seed=seed, scale=scale,
                    controller=controller,
                    collect_views=collect_views,
                    controller_kwargs=controller_kwargs,
                    device=device).run()


def run_oracle(schedule, device=None):
    """The clean dict-path oracle: the SAME schedule replayed over
    plain :class:`GeneralDocSet` nodes on a fault-free
    dict-protocol fabric (no serving layer, no wire format, no
    admission, no partitions) — the byte-identity comparand of the
    scenario regression tests. Returns each node's canonical
    materialized views. The nodes' stores live on ``device`` (None is
    the card)."""
    spec = schedule['spec']
    doc_sets = [GeneralDocSet(spec['n_docs'] + 8, device=device)
                for _ in range(spec['n_nodes'])]
    fleet = ChaosFleet(doc_sets, seed=schedule['seed'] + 1,
                       batching=True,
                       heartbeat_every=spec['heartbeat_every'])
    try:
        for tick in schedule['ticks']:
            by_node = {}
            for node, doc_id, changes in tick['writes']:
                by_node.setdefault(node, {})[doc_id] = changes
            for node, batch in by_node.items():
                doc_sets[node].apply_changes_batch(batch)
            fleet.tick()
        fleet.run(max_ticks=8000)
        return [canonical(doc_set_view(ds)) for ds in doc_sets]
    finally:
        fleet.close()
