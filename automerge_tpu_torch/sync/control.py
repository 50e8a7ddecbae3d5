"""FleetController: the closed-loop adaptive-control tick.

PRs 7, 8 and 10 built the fleet's sensors — the health/SLO rollup,
replication-lag gauges, admission-debt and backpressure surfaces, the
``memory_pressure`` signal of the serving layer's memory accounting.
Until this module nothing CONSUMED those signals: an operator had to
watch ``fleet_status()`` and retune the admission token rates, the
eviction watermark and the compaction schedule by hand. This
controller closes the loop (Okapi's availability-under-adversity
framing, PAPERS.md: defend availability and bounded staleness under
pressure, cheaply): once per serving quantum it reads the SAME
exported telemetry surface the dashboards read — the
:meth:`~.general_doc_set.GeneralDocSet.evaluate_health` signal set and
the per-link ``peer/<id>/`` counter slices — and actuates exactly
four knobs:

- **Admission token rates** — sustained ``busy`` replies while the
  debt buckets show LOW utilization (the valve is bouncing off its
  threshold, not deeply indebted) mean the configured rate undershoots
  real demand: the rates widen geometrically up to a cap, and narrow
  back toward the configured base after a long quiet spell. Deep debt
  is real overload and is never widened into.
- **Eviction watermark + compaction trigger** — sustained
  ``memory_pressure`` at the high bound lowers the serving layer's
  ``low_watermark`` a step (deeper hysteresis headroom per eviction
  pass) AND schedules :func:`~automerge_tpu_torch.compaction.compact_docset`
  (fold the retained history the pinned hot set keeps growing — the
  background-compaction policy seeded as a PR 12 follow-up). Pressure
  sustained at the low bound raises the watermark back toward its
  base, never past it.
- **Load shedding** — entry to ``critical`` health cuts the token
  rates to a shed fraction (overload degrades to explicit ``busy``
  latency at the edge, never to corruption) and dumps a
  ``load_shed`` flight-recorder incident; sustained green restores
  the previous rates.
- **Doc placement** — on a sharded fleet
  (:class:`~.sharded.ShardedGeneralDocSet`), sustained per-shard
  apply-rate skew drains the hottest docs to the coldest shard via
  live migration (``control.migrate`` span, ``control_migrations``);
  a balanced fleet never migrates.

Every rule is hysteretic by construction — a signal must breach for
``hold`` consecutive quanta before an action fires, each action arm
has a ``cooldown``, and the raise/lower bounds leave a dead band — so
a signal sitting AT a threshold can never flap the knob. A green
fleet costs nothing: the quantum hook reads the already-computed
health signals, finds no sustained breach, and returns without
bumping a counter, emitting an event or opening a span (the
do-nothing guarantee, asserted in tests/test_control.py).

Every action that DOES fire is a traced ``control.*`` span, a
``control_action`` event and a ``CONTROL_COUNTERS`` bump — the
controller is as observable as the signals it consumes.

The PyTorch port's copy of ``automerge_tpu/sync/control.py``. The
placement knob acts on a sharded fleet
(:class:`~.sharded.ShardedGeneralDocSet`, the ``hot_shard`` scenario).
"""

from ..utils.metrics import metrics


class FleetController:
    """One serving node's policy loop. Construct over a
    :class:`~.serving.ServingDocSet` (``attach=True`` wires
    ``serving.controller`` so the serving tick drives
    :meth:`on_quantum` with the health evaluation it already
    performs); for admission-only fleets any doc-set-like object with
    a ``connections`` registry works.

    Tunables (all logical-time, in serving quanta):

    ``hold`` — consecutive quanta a signal must breach before acting.
    ``cooldown`` — minimum quanta between actions on the same knob.
    ``mem_high`` / ``mem_low`` — the memory_pressure dead band:
    sustained >= high lowers the watermark (and triggers compaction),
    sustained <= low raises it back toward base. The defaults keep
    the post-eviction operating point (== the watermark) strictly
    inside the band, so an action can never push the signal straight
    into the opposite threshold.
    ``watermark_step`` / ``watermark_min`` — eviction-watermark
    actuation range (never raised past its configured base).
    ``compact_cooldown`` — quanta between compaction triggers (a fold
    is O(retained log), far too heavy to fire per quantum).
    ``widen_factor`` / ``max_widen`` — geometric token-rate widening
    and its cap (a multiple of the configured base rates).
    ``util_widen_max`` — widen only while max bucket debt/burst is at
    or below this (low utilization = demand bounce, not overload).
    ``narrow_after`` — quanta with zero fresh busy replies before the
    rates narrow one step back toward base.
    ``shed_factor`` — the rate multiple a critical fleet sheds to.
    ``placement_ratio`` — per-shard apply-rate skew (hottest shard's
    share over the mean) that counts as imbalance for the placement
    knob; sustained breach for ``hold`` quanta drains hot docs.
    ``placement_min_ops`` — window op floor below which the placement
    rule never evaluates (an idle fleet has no meaningful skew).
    ``migrate_batch`` — docs drained per placement action (each batch
    is one source-store rebuild — keep it small and let hysteresis
    spread the drain over quanta).
    """

    def __init__(self, serving, hold=3, cooldown=8,
                 mem_high=0.9, mem_low=0.5,
                 watermark_step=0.1, watermark_min=0.6,
                 compact_cooldown=32,
                 widen_factor=1.5, max_widen=8.0,
                 util_widen_max=1.0, narrow_after=12,
                 shed_factor=0.25, placement_ratio=2.0,
                 placement_min_ops=16, migrate_batch=4, attach=True):
        self.serving = serving
        self.inner = getattr(serving, 'inner', serving)
        self.hold = hold
        self.cooldown = cooldown
        self.mem_high = mem_high
        self.mem_low = mem_low
        self.watermark_step = watermark_step
        self.watermark_min = watermark_min
        self.compact_cooldown = compact_cooldown
        self.widen_factor = widen_factor
        self.max_widen = max_widen
        self.util_widen_max = util_widen_max
        self.narrow_after = narrow_after
        self.shed_factor = shed_factor
        self.placement_ratio = placement_ratio
        self.placement_min_ops = placement_min_ops
        self.migrate_batch = migrate_batch
        self._imbalance_run = 0
        # the configured operating point the controller steers around
        # (and never raises past)
        self._watermark_base = getattr(serving, 'low_watermark', None)
        self._rate_factor = 1.0
        self._base_rates = {}          # id(bucket) -> (bucket, rate, burst)
        self._quantum = 0
        self._last_action = {}         # knob -> quantum of last action
        self._mem_high_run = 0
        self._mem_low_run = 0
        self._busy_run = 0
        self._quiet_run = 0
        self._busy_seen = None         # last per-link busy_sent sum
        self._shed = False
        self._pre_shed_factor = 1.0
        self._green_run = 0
        self.actions = {}              # action name -> count (status())
        if attach and hasattr(serving, 'tick'):
            serving.controller = self

    # -- knob plumbing -------------------------------------------------------

    def _buckets(self):
        """Every live admission bucket of this node's registered
        links, deduplicated (a node-shared AdmissionControl appears
        once, not once per link), with its base (rate, burst) recorded
        on first sight."""
        out = []
        seen = set()
        for conn in getattr(self.inner, 'connections', {}).values():
            for ctrl in (getattr(conn, 'admission', None),
                         getattr(conn, 'shared_admission', None)):
                if ctrl is None:
                    continue
                for bucket in (ctrl.change_bucket, ctrl.byte_bucket):
                    if bucket is None or id(bucket) in seen:
                        continue
                    seen.add(id(bucket))
                    rec = self._base_rates.get(id(bucket))
                    if rec is None:
                        rec = self._base_rates[id(bucket)] = (
                            bucket, bucket.rate, bucket.burst)
                    out.append(rec)
        return out

    def _apply_rate_factor(self, buckets):
        for bucket, rate, burst in buckets:
            bucket.rate = max(1, int(rate * self._rate_factor))
            bucket.burst = max(bucket.rate,
                               int(burst * self._rate_factor))

    def _busy_sent(self):
        """This node's own busy replies: the sum over its registered
        links' ``peer/<id>/`` counter slices — NEVER the process-wide
        counter, which would bleed a co-resident fleet's backpressure
        into this node's policy (the chaos/sim harnesses host every
        node in one process)."""
        counters = metrics.counters
        total = 0
        for conn in getattr(self.inner, 'connections', {}).values():
            prefix = getattr(getattr(conn, 'metrics', None),
                             'prefix', '')
            total += counters.get(prefix + 'sync_busy_sent', 0)
        return total

    def _cooled(self, knob, cooldown=None):
        last = self._last_action.get(knob)
        span = self.cooldown if cooldown is None else cooldown
        return last is None or self._quantum - last >= span

    def _act(self, name, counter, knob, mutate, **fields):
        """One control action: the mutation runs inside a traced
        ``control.<name>`` span, is counted under its
        ``CONTROL_COUNTERS`` name (plus the ``control_actions``
        total), emits a ``control_action`` event, and arms the knob's
        cooldown."""
        with metrics.trace_span('control.' + name, **fields):
            mutate()
        self._last_action[knob] = self._quantum
        self.actions[name] = self.actions.get(name, 0) + 1
        metrics.bump('control_actions')
        metrics.bump(counter)
        if metrics.active:
            metrics.emit('control_action', action=name, **fields)

    # -- the policy tick -----------------------------------------------------

    def on_quantum(self, health):
        """One policy evaluation, driven by the serving tick with the
        health rollup it just computed (``evaluate_health()``'s return
        value — state, reasons, signals). Reads only that signal set
        plus the per-link counter slices; actuates at most one action
        per knob per quantum."""
        self._quantum += 1
        state = health.get('state', 'green')
        signals = health.get('signals', {})
        self._shed_rule(state)
        self._memory_rule(signals)
        self._admission_rule(signals)
        self._placement_rule()

    def tick(self):
        """Standalone driver (no serving tick): evaluate health and
        run the policy quantum in one call."""
        self.on_quantum(self.inner.evaluate_health())

    # -- rules ---------------------------------------------------------------

    def _shed_rule(self, state):
        if state == 'critical' and not self._shed:
            buckets = self._buckets()
            if not buckets:
                return                 # nothing to shed with

            def shed():
                self._pre_shed_factor = self._rate_factor
                self._rate_factor = self.shed_factor
                self._apply_rate_factor(buckets)
                self._shed = True
                recorder = getattr(self.serving, 'flight_recorder',
                                   None)
                dir_path = getattr(self.serving, 'dir_path', None)
                if recorder is not None and dir_path is not None:
                    from ..durability import dump_incident
                    dump_incident(recorder, dir_path, 'load_shed',
                                  factor=self.shed_factor)

            self._act('shed', 'control_load_sheds', 'shed', shed,
                      factor=self.shed_factor)
            self._green_run = 0
            return
        if self._shed:
            self._green_run = self._green_run + 1 \
                if state == 'green' else 0
            if self._green_run >= self.hold and self._cooled('shed'):
                buckets = self._buckets()

                def restore():
                    self._rate_factor = self._pre_shed_factor
                    self._apply_rate_factor(buckets)
                    self._shed = False

                self._act('shed_restore', 'control_shed_restores',
                          'shed', restore,
                          factor=self._pre_shed_factor)

    def _memory_rule(self, signals):
        pressure = signals.get('memory_pressure')
        if pressure is None or \
                getattr(self.serving, 'memory_budget_bytes', None) \
                is None or self._watermark_base is None:
            return
        if pressure >= self.mem_high:
            self._mem_high_run += 1
            self._mem_low_run = 0
        elif pressure <= self.mem_low:
            self._mem_low_run += 1
            self._mem_high_run = 0
        else:
            self._mem_high_run = 0
            self._mem_low_run = 0
        serving = self.serving
        if self._mem_high_run >= self.hold:
            acted = False
            if serving.low_watermark - self.watermark_step >= \
                    self.watermark_min - 1e-9 and \
                    self._cooled('watermark'):
                new = round(serving.low_watermark -
                            self.watermark_step, 4)

                def lower():
                    serving.low_watermark = new

                self._act('watermark_lower',
                          'control_watermark_lowered', 'watermark',
                          lower, low_watermark=new,
                          memory_pressure=pressure)
                acted = True
            store = getattr(self.inner, 'store', None)
            foldable = store is not None and (
                getattr(store, 'log_truncated', False) or
                any(len(docs) for _, _, docs in
                    getattr(store, 'retained', ())))
            if foldable and self._cooled('compact',
                                         self.compact_cooldown):
                def compact():
                    from ..compaction import compact_docset
                    compact_docset(self.serving)

                self._act('compact', 'control_compactions', 'compact',
                          compact, memory_pressure=pressure)
                acted = True
            if acted:
                # each action needs a FRESH `hold` quanta of sustained
                # breach — paired with the cooldown this is what keeps
                # a signal glued to the threshold from machine-gunning
                # the knob
                self._mem_high_run = 0
        elif self._mem_low_run >= self.hold and \
                serving.low_watermark < self._watermark_base - 1e-9 \
                and self._cooled('watermark'):
            new = round(min(self._watermark_base,
                            serving.low_watermark +
                            self.watermark_step), 4)

            def raise_():
                serving.low_watermark = new

            self._act('watermark_raise', 'control_watermark_raised',
                      'watermark', raise_, low_watermark=new,
                      memory_pressure=pressure)
            self._mem_low_run = 0

    def _admission_rule(self, signals):
        buckets = self._buckets()
        if not buckets:
            return
        busy = self._busy_sent()
        fresh = 0 if self._busy_seen is None \
            else busy - self._busy_seen
        self._busy_seen = busy
        if fresh > 0:
            self._busy_run += 1
            self._quiet_run = 0
        else:
            self._busy_run = 0
            self._quiet_run += 1
        if self._shed:
            return                     # the shed rule owns the rates
        debt = max((max(0, -bucket.tokens) / max(bucket.burst, 1)
                    for bucket, _, _ in buckets), default=0.0)
        if self._busy_run >= self.hold and \
                debt <= self.util_widen_max and \
                self._rate_factor < self.max_widen and \
                self._cooled('tokens'):
            new = min(self.max_widen,
                      self._rate_factor * self.widen_factor)

            def widen():
                self._rate_factor = new
                self._apply_rate_factor(buckets)

            self._act('tokens_widen', 'control_tokens_widened',
                      'tokens', widen, rate_factor=round(new, 3),
                      debt_utilization=round(debt, 3))
            self._busy_run = 0
        elif self._quiet_run >= self.narrow_after and \
                self._rate_factor > 1.0 and self._cooled('tokens'):
            new = max(1.0, self._rate_factor / self.widen_factor)

            def narrow():
                self._rate_factor = new
                self._apply_rate_factor(buckets)

            self._act('tokens_narrow', 'control_tokens_narrowed',
                      'tokens', narrow, rate_factor=round(new, 3))
            self._quiet_run = 0

    def _placement_rule(self):
        """The placement knob (ROADMAP "placement knob", ISSUE 17): a
        sharded fleet whose hottest shard sustains more than
        ``placement_ratio`` times the mean apply rate drains its
        hottest docs to the COLDEST shard — live migration
        (:meth:`~.sharded.ShardedGeneralDocSet.migrate_docs`) under
        the standard hysteresis: ``hold`` consecutive breached quanta
        to arm, the ``placement`` knob's cooldown between drains. A
        balanced (or idle) fleet evaluates to a couple of numpy
        reductions and returns without touching anything — the
        do-nothing guarantee extends to this knob."""
        sharded = self.serving if hasattr(self.serving, 'placement') \
            else getattr(self.serving, 'sharded', None)
        if sharded is None or getattr(sharded, 'n_shards', 1) < 2:
            return
        load = sharded.shard_load()
        rates = load['apply_ops']
        total = sum(rates)
        if total < self.placement_min_ops:
            self._imbalance_run = 0
            return
        mean = total / len(rates)
        hot = max(range(len(rates)), key=lambda s: rates[s])
        ratio = rates[hot] / mean
        if ratio < self.placement_ratio:
            self._imbalance_run = 0
            return
        self._imbalance_run += 1
        if self._imbalance_run < self.hold or \
                not self._cooled('placement'):
            return
        # cold shards by apply rate, resident bytes breaking ties
        resident = load['resident_bytes']
        cold = sorted((s for s in range(len(rates)) if s != hot),
                      key=lambda s: (rates[s], resident[s]))
        docs = sharded.hottest_docs(hot, self.migrate_batch)
        if not docs or not cold:
            return
        # spread the batch coldest-first so the hot clique splits up
        # instead of re-forming on a single destination
        plan = {doc: cold[i % len(cold)]
                for i, doc in enumerate(docs)}

        def migrate():
            sharded.migrate_docs(plan)

        self._act('migrate', 'control_migrations', 'placement',
                  migrate, docs=len(plan), src=hot, dst=cold[0],
                  ratio=round(ratio, 2))
        self._imbalance_run = 0

    # -- operator surface ----------------------------------------------------

    def status(self):
        """The controller's slice of ``fleet_status()``: live knob
        positions and per-action totals."""
        return {'rate_factor': round(self._rate_factor, 3),
                'low_watermark': getattr(self.serving,
                                         'low_watermark', None),
                'watermark_base': self._watermark_base,
                'shed': self._shed,
                'actions': dict(self.actions)}
