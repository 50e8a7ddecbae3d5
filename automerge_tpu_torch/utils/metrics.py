"""Observability: counters, histograms, spans, a structured event stream.

The reference has no tracing/metrics at all (SURVEY.md §5: zero logging
calls; its only introspection is getHistory/inspect and DocSet handler
callbacks). This module is the observability layer the TPU build is
specified to carry:

- **Counters / gauges** — cheap process-wide counts (ops applied,
  changes applied, conflicts detected, queue depth, every fault and
  serving counter in the registries below).
- **Histograms** — :meth:`Metrics.observe` series keep fixed log-spaced
  buckets alongside count/sum/max, so :meth:`Metrics.quantile` serves
  p50/p99 for apply, flush, fault-in, busy-wait and journal-fsync
  latencies OUTSIDE of bench runs — ``fleet_status()`` and ``bench_*``
  report from the SAME series.
- **Spans** — :meth:`Metrics.trace_span` is a context manager emitting
  one ``span`` event per exit (name, trace/span/parent ids, duration
  from ``perf_counter``). Spans nest per thread; a remote parent adopts
  via :meth:`Metrics.trace_context` — the cross-peer causal correlation
  the sync envelopes carry (``sync/resilient.py``).
- **Event stream** — :meth:`Metrics.emit` calls every subscriber
  synchronously; :class:`FlightRecorder` is the bounded ring-buffer
  subscriber the serving layer dumps on incidents (crash recovery,
  first quarantine of a doc).
- **Scoped views** — :meth:`Metrics.scoped` returns a labeled child
  whose writes land BOTH process-wide and under ``peer/<id>/<name>`` —
  the per-connection metrics surface ``fleet_status()`` reports.

Everything is no-op-cheap when nothing subscribes: counter bumps are one
dict add; events are only materialized if a subscriber is registered;
``trace_span`` returns a shared null context manager.
"""

import math
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

# Fault-path counters (the degraded-operation observability contract —
# asserted in tests/test_metrics.py, printed in the bench summary).
# Counters are created on first bump like any other, but these names
# are the STABLE surface dashboards and tests key on:
#   sync_retransmits           unacked envelopes re-sent (backoff timer)
#   sync_retry_exhausted       envelopes dropped after the retry budget
#   sync_msgs_rejected         malformed envelopes/messages refused
#                              before any state mutation
#   sync_msgs_duplicate        envelope-level duplicates suppressed
#   sync_checksum_failures     payload CRC mismatches (corrupt in
#                              flight; dropped unacked -> retransmitted)
#   sync_heartbeats_sent/_received   anti-entropy clock re-adverts
#   sync_apply_failures        deliveries whose apply raised (seq left
#                              unacked -> retransmit/anti-entropy heal)
#   sync_docs_quarantined      docs isolated out of a tick because
#                              their changes raised (store rolled back)
#   apply_rollbacks            engine applies undone by the _Txn
#                              store-intact-on-error path
#   snapshot_checksum_failures snapshot-container/journal CRC
#                              mismatches caught at load
FAULT_COUNTERS = (
    'sync_retransmits', 'sync_retransmit_wire_bytes',
    'sync_retry_exhausted', 'sync_retry_exhausted_backpressure',
    'sync_msgs_rejected',
    'sync_msgs_duplicate', 'sync_checksum_failures',
    'sync_heartbeats_sent', 'sync_heartbeats_received',
    'sync_apply_failures', 'sync_docs_quarantined', 'apply_rollbacks',
    'snapshot_checksum_failures')

# Serving/overload counters (the overload-degradation observability
# contract — the serving layer must shed load VISIBLY, never silently):
#   sync_busy_sent/_received   admission-control `busy` replies (the
#                              explicit overload signal, with a
#                              retry-after hint — never a silent drop)
#   sync_backpressure_depth    gauge: unacked envelopes currently
#                              deferred by a peer's busy replies
#   sync_flow_deferred_docs    data spans carried to the next tick by
#                              the per-message outgoing byte cap
#   sync_flow_backlog_docs     gauge: sender-side docs still pending
#                              after a capped flush
#   sync_wire_cache_bytes      gauge: resident bytes of the per-change
#                              encode cache (drops on doc eviction)
#   sync_busy_wait_ms          observe series: wall time an envelope
#                              spent deferred by busy replies before
#                              its eventual ack
#   serving_evictions          cold docs evicted to durable parked
#                              snapshots (memory-budget enforcement)
#   serving_faultins           evicted docs transparently faulted back
#                              in by a touch
#   serving_faultin_ms         observe series: fault-in latency
#   serving_resident_bytes     gauge: estimated resident fleet bytes
#   serving_docs_parked        ALERT: stuck quarantined docs aged out
#                              of the in-memory hold to a parked
#                              snapshot
#   serving_evictions_blocked_truncated  eviction skipped because the
#                              store's change log is snapshot-truncated
#                              (a parked doc could not be rebuilt)
SERVING_COUNTERS = (
    'sync_busy_sent', 'sync_busy_received', 'sync_backpressure_depth',
    'sync_flow_deferred_docs', 'sync_flow_backlog_docs',
    'sync_wire_cache_bytes', 'sync_busy_wait_ms',
    'serving_evictions', 'serving_faultins', 'serving_faultin_ms',
    'serving_resident_bytes',
    'serving_docs_parked', 'serving_evictions_blocked_truncated')

# Sync traffic counters + latency series (the steady-state half of the
# sync_/serving_ namespace — everything that is neither a fault nor an
# overload signal lives here, so the registry-drift guard in
# tests/test_metrics.py can assert the THREE registries together cover
# every literal sync_/serving_ name bumped anywhere in the package):
#   sync_msgs_sent/_received         logical protocol messages
#   sync_changes_sent/_received      change payloads inside them
#   sync_snapshots_sent/_received    snapshot fallbacks for truncated
#                                    logs
#   sync_wire_msgs_sent/_received    multi-doc columnar data messages
#   sync_wire_v2_msgs_sent/_received the columnar-binary (v2) subset —
#                                    a mixed fleet's format mix is the
#                                    gap between the two pairs
#   sync_wire_bytes_sent             their payload bytes (blob + v2
#                                    literal tab)
#   sync_wire_parse_ms               observe series: wire-blob ->
#                                    ChangeBlock codec latency (the
#                                    bench parse p50/p99 keys)
#   sync_apply_ms                    observe series: doc-set fused
#                                    apply latency (dict + wire paths)
#   sync_flush_ms                    observe series: connection flush
#                                    latency (apply + outgoing send)
#   sync_wire_v3_msgs_*              v3 (session-table) data messages
#   sync_wire_table_entries          gauge: sender session-table size
#   sync_wire_table_bytes            gauge: sender session-table bytes
#   sync_wire_table_hits             literal occurrences sent as BARE
#                                    session refs (acked entries)
#   sync_wire_table_misses           occurrences that still shipped a
#                                    def (new or not-yet-acked)
#   sync_wire_table_evictions        LRU ref recyclings under budget
#   sync_wire_table_stale_refs       receive-side unknown session ref
#                                    (table state lost) — the envelope
#                                    goes unacked and retransmit
#                                    repairs it
#   sync_wire_session_resumes        reconnects that resumed a peer's
#                                    recorded session (O(divergence))
#   sync_wire_session_resets         sessions started/reset clean
#   sync_wire_session_warmups        session string tables pre-seeded
#                                    from a 'state' bootstrap (both
#                                    sides derive the SAME literal
#                                    order from the snapshot, so the
#                                    first warm flush ships bare refs)
#   sync_wire_warm_literals          literals interned by those
#                                    warm-ups (definition bytes the
#                                    first warm flush did NOT ship)
#   sync_wire_def_bytes_sent         v3 per-message tab bytes (session
#                                    defs) — the warm-up bench reads
#                                    post-bootstrap definition savings
#                                    off this
SYNC_COUNTERS = (
    'sync_msgs_sent', 'sync_msgs_received',
    'sync_changes_sent', 'sync_changes_received',
    'sync_snapshots_sent', 'sync_snapshots_received',
    'sync_wire_msgs_sent', 'sync_wire_msgs_received',
    'sync_wire_v2_msgs_sent', 'sync_wire_v2_msgs_received',
    'sync_wire_v3_msgs_sent', 'sync_wire_v3_msgs_received',
    'sync_wire_table_entries', 'sync_wire_table_bytes',
    'sync_wire_table_hits', 'sync_wire_table_misses',
    'sync_wire_table_evictions', 'sync_wire_table_stale_refs',
    'sync_wire_session_resumes', 'sync_wire_session_resets',
    'sync_wire_session_warmups', 'sync_wire_warm_literals',
    'sync_wire_def_bytes_sent',
    'sync_wire_clock_entries_elided',
    'sync_wire_bytes_sent', 'sync_wire_parse_ms',
    'sync_apply_ms', 'sync_flush_ms')

# Convergence/health counters (the replication-observability contract:
# how far behind is each peer, are any replicas silently diverged, and
# is the fleet healthy right now):
#   sync_replication_lag_ops   gauge (per heartbeat, per link): change
#                              seqs the peer has not acked yet
#   sync_lagging_docs          gauge: docs where the peer is behind
#   sync_convergence_ms        observe series: change birth (local
#                              apply) -> every registered peer's acked
#                              clock covers it (full-fleet ack)
#   sync_divergence_detected   equal clocks, unequal state digests on
#                              a heartbeat — a silently diverged
#                              replica (reported, never quarantined)
#   fleet_health_state         gauge: 0 green / 1 degraded / 2 critical
#   fleet_health_transitions   health-state changes recorded (each one
#                              also emits a `health_transition` event)
CONVERGENCE_COUNTERS = (
    'sync_replication_lag_ops', 'sync_lagging_docs',
    'sync_convergence_ms', 'sync_divergence_detected',
    'fleet_health_state', 'fleet_health_transitions')

# Device-path performance counters (the performance-observability
# contract — device/profiler.py, device/general.py, device/engine.py;
# the registry-drift guard covers the device_*/mem_* families in both
# directions exactly like sync_/serving_/fleet_):
#   device_batches / device_ops / device_batch_occupancy
#                              the dense merge path's batch stats
#   device_backend_*           the auto-routed facade's fused-apply
#                              stats
#   device_dispatches_total    tracked entry-point dispatches (jit
#                              programs AND the size-bucketed host
#                              view gathers)
#   device_compiles_total      distinct (fn, shape signature) pairs
#                              over the JIT entries only — each one
#                              is an XLA compile (host view gathers
#                              grow per-fn signature gauges but never
#                              this total)
#   device_retraces_total      compiles BEYOND the first per function
#                              (the recompile-storm signal's source)
#   device_dispatch_rows       observe series: padded rows per
#                              dispatch — the shape-bucket
#                              distribution
#   device_admit_ms/_pack_ms/_dispatch_ms/_run_ms
#                              observe series: the sampled per-phase
#                              device-time attribution (every Nth
#                              apply fences and splits its wall time)
#   device_patch_read_ms       observe series: device fetch + patch
#                              column build (the read side)
#   device_idx_incremental_applies / device_idx_rebuild_applies
#                              applies that merged the tick's delta
#                              into the persistent sequence index vs
#                              ones that re-derived dirty objects'
#                              order from scratch (first sight,
#                              invalidation, ineligible delta)
#   device_idx_invalidations   index-validity drops / eligibility
#                              rejections (stale tp plane, non-front
#                              insert, cols downgrade)
#   device_idx_delta_nodes     total delta nodes merged by the
#                              incremental path
#   device_idx_update_ms       observe series: fenced run time of
#                              SAMPLED incremental-index applies (the
#                              merge pass's own phase attribution)
#   device_idx_window_applies  incremental dispatches that engaged the
#                              suffix-bounded visibility renumber (a
#                              strictly smaller plane than the mirror)
#   device_stage_cache_hits/_misses
#                              staging-cache consults per dirty object:
#                              hit = the persistent elemId index was
#                              resident, miss = built cold this tick
#   device_utilization         gauge: device ms / wall ms of the last
#                              sampled apply
#   mem_device_plane_bytes     gauge: resident device mirror bytes
#   mem_device_packed_bytes/_wide_bytes/_cols_bytes
#                              the same, split by mirror format (the
#                              non-active formats read 0)
#   mem_device_plane_peak_bytes   high-water mark of the plane gauge
#   mem_journal_bytes          gauge: change-journal file bytes
#   mem_journal_peak_bytes     high-water mark of the journal gauge
#   mem_park_shard_bytes       gauge: on-disk bytes of live park
#                              shards (serving-layer eviction store)
#   mem_resident_peak_bytes    high-water mark of the serving layer's
#                              resident-byte estimate
DEVICE_COUNTERS = (
    'device_batches', 'device_ops', 'device_batch_occupancy',
    'device_backend_fused_calls', 'device_backend_batches',
    'device_backend_ops', 'device_backend_seq_objects',
    'device_dispatches_total', 'device_compiles_total',
    'device_retraces_total', 'device_dispatch_rows',
    'device_admit_ms', 'device_pack_ms', 'device_dispatch_ms',
    'device_run_ms', 'device_patch_read_ms',
    'device_idx_incremental_applies', 'device_idx_rebuild_applies',
    'device_idx_invalidations', 'device_idx_delta_nodes',
    'device_idx_update_ms', 'device_idx_window_applies',
    'device_stage_cache_hits', 'device_stage_cache_misses',
    'device_utilization',
    'mem_device_plane_bytes', 'mem_device_packed_bytes',
    'mem_device_wide_bytes', 'mem_device_cols_bytes',
    'mem_device_plane_peak_bytes', 'mem_journal_bytes',
    'mem_journal_peak_bytes', 'mem_park_shard_bytes',
    'mem_resident_peak_bytes')

# Tiered-doc-storage counters (the compaction observability contract
# — automerge_tpu/compaction.py and the 'state' sync message kind):
#   compaction_runs            horizon advances (compact_docset calls)
#   compaction_ops_folded      retained-log ops folded into per-doc
#                              state snapshots (the bodies released)
#   compaction_ms              observe series: wall time per fold
#   mem_state_snapshot_bytes   gauge: resident bytes of the per-doc
#                              horizon state snapshots
#   sync_state_msgs_sent/_received  'state' bootstrap messages (the
#                              O(state) answer to a peer whose clock
#                              predates the horizon)
#   sync_state_bootstraps      docs absorbed from a state snapshot
#                              (cold-peer bootstraps, park fault-ins,
#                              journal-replayed absorbs)
COMPACTION_COUNTERS = (
    'compaction_runs', 'compaction_ops_folded', 'compaction_ms',
    'mem_state_snapshot_bytes', 'sync_state_msgs_sent',
    'sync_state_msgs_received', 'sync_state_bootstraps')

# Closed-loop control counters (the adaptive-control observability
# contract — sync/control.py: every knob the controller turns is
# counted, so a fleet being actively steered is never mistaken for
# one that tuned itself; a green fleet bumps NONE of these, which is
# the do-nothing guarantee tests/test_control.py asserts):
#   control_actions            total actions fired (sum of the rest)
#   control_tokens_widened     admission token rates widened under
#                              sustained busy + low debt utilization
#   control_tokens_narrowed    rates stepped back toward base after a
#                              quiet spell
#   control_watermark_lowered  eviction low_watermark stepped down
#                              under sustained memory_pressure
#   control_watermark_raised   watermark stepped back toward its base
#   control_compactions        compact_docset folds the controller
#                              scheduled under memory pressure
#   control_load_sheds         critical health: rates cut to the shed
#                              fraction (+ a load_shed incident dump)
#   control_shed_restores      sustained green: pre-shed rates restored
#   control_migrations         hot-doc drains the placement knob fired
#                              (sync/sharded.py migrations ride the
#                              placement_* family below; this counts
#                              the CONTROLLER deciding to move docs)
CONTROL_COUNTERS = (
    'control_actions', 'control_tokens_widened',
    'control_tokens_narrowed', 'control_watermark_lowered',
    'control_watermark_raised', 'control_compactions',
    'control_load_sheds', 'control_shed_restores',
    'control_migrations')

# Doc-placement counters (sync/sharded.py — the sharded fleet's
# placement map and live doc migration observability):
#   placement_migrations       docs migrated between shards
#   placement_migrated_bytes   checksummed migration-unit bytes shipped
#   placement_migrate_ms       end-to-end per-batch migration latency
#   placement_fenced_changes   changes buffered behind an in-flight
#                              migration fence (re-routed after the
#                              placement flip, never dropped)
#   placement_overrides        explicit placement pins currently
#                              installed over the consistent-hash ring
#   shard_apply_ops            ops admitted through shard-routed applies
#   shard_imbalance_ratio      gauge: hottest shard's apply share over
#                              the mean (1.0 = perfectly balanced)
PLACEMENT_COUNTERS = (
    'placement_migrations', 'placement_migrated_bytes',
    'placement_migrate_ms', 'placement_fenced_changes',
    'placement_overrides', 'shard_apply_ops',
    'shard_imbalance_ratio')

# Fleet-simulator counters (automerge_tpu/fleetsim.py — the workload
# generator's own telemetry, so a scenario run is auditable from the
# same registry everything else exports through):
#   sim_scenario_runs          scenarios executed
#   sim_ticks                  scheduling quanta driven
#   sim_ops_injected           ops generated into the fleet
#   sim_actors_spawned         distinct simulated actors minted
SIM_COUNTERS = (
    'sim_scenario_runs', 'sim_ticks', 'sim_ops_injected',
    'sim_actors_spawned')

# Socket-transport counters (sync/transport.py — the real-TCP binding
# around the envelope protocol; every frame that crosses a socket is
# accounted here, so the wire-level health of a link is auditable
# without tcpdump):
#   transport_frames_sent/_received    CRC-framed envelopes written to /
#                              decoded off a socket
#   transport_bytes_sent/_received     raw socket bytes (framing
#                              overhead included — this is the number
#                              the reconnect byte-accounting gates)
#   transport_frame_errors     frames rejected by the codec (bad magic,
#                              out-of-bounds length prefix, CRC
#                              mismatch, malformed header) — each one
#                              resets the stream and re-dials; the
#                              envelope layer repairs by retransmit
#   transport_partial_frames   torn tails: a connection died mid-frame
#                              (the partial bytes are discarded, never
#                              parsed)
#   transport_frames_dropped   outgoing frames collapsed out of a
#                              bounded per-peer queue (oldest-advert
#                              first) or inbound frames for an unknown
#                              doc set / pre-handshake peer
#   transport_connects         sockets dialed successfully (first dial
#                              per link)
#   transport_accepts          inbound sockets adopted after a HELLO
#   transport_reconnects       successful re-dials of a previously
#                              connected link
#   transport_disconnects      sockets lost (EOF, reset, frame error)
#   transport_eager_flushes    eager fast path: flusher tasks kicked
#                              by a staged envelope or received batch
#                              (the drains that did NOT wait for a
#                              tick quantum)
#   transport_coalesced_batches  kicks that landed while a drain was
#                              in flight and folded into its next
#                              batch — the micro-coalescing window
#                              engaging under load
#   transport_frames_per_syscall  observe series: frames drained per
#                              writelines/drain cycle (batching
#                              efficiency of the zero-copy write loop)
TRANSPORT_COUNTERS = (
    'transport_frames_sent', 'transport_frames_received',
    'transport_bytes_sent', 'transport_bytes_received',
    'transport_frame_errors', 'transport_partial_frames',
    'transport_frames_dropped', 'transport_connects',
    'transport_accepts', 'transport_reconnects',
    'transport_disconnects', 'transport_eager_flushes',
    'transport_coalesced_batches', 'transport_frames_per_syscall')

# Liveness/membership counters (sync/transport.py failure detector +
# the membership hooks in general_doc_set.py / resilient.py — the
# fleet noticing a dead peer instead of retrying forever):
#   membership_transitions     up/suspect/down state changes on any
#                              peer link
#   membership_peer_down_total peers declared dead (each first
#                              detection also emits a `peer_down`
#                              event and, on a serving node, dumps a
#                              flight-recorder incident)
#   membership_peers_up/_suspect/_down   gauges: current peer-link
#                              states as seen by this endpoint
#   membership_retries_parked  retransmit passes skipped because the
#                              peer is `down` (the retry budget is
#                              parked, not burned)
#   membership_births_parked   pending convergence births parked
#                              against a down peer (restored on heal,
#                              never leaked)
MEMBERSHIP_COUNTERS = (
    'membership_transitions', 'membership_peer_down_total',
    'membership_peers_up', 'membership_peers_suspect',
    'membership_peers_down', 'membership_retries_parked',
    'membership_births_parked')

# Every registered counter/gauge/series name, in one tuple — the
# telemetry exporter (automerge_tpu/telemetry.py) renders ALL of these
# even when never bumped, and tests/test_metrics.py asserts none is
# silently unexported.
ALL_COUNTER_REGISTRIES = (FAULT_COUNTERS + SERVING_COUNTERS +
                          SYNC_COUNTERS + CONVERGENCE_COUNTERS +
                          DEVICE_COUNTERS + COMPACTION_COUNTERS +
                          CONTROL_COUNTERS + PLACEMENT_COUNTERS +
                          SIM_COUNTERS + TRANSPORT_COUNTERS +
                          MEMBERSHIP_COUNTERS)

# Observe-series name suffixes: a registered name ending in one of
# these is a histogram series (count/sum/max + buckets), not a scalar
# — the exporter zero-fills it as an empty histogram.
HIST_SUFFIXES = ('_ms', '_rows', '_per_syscall')


# -- histogram geometry --------------------------------------------------------
#
# Fixed log-spaced buckets shared by every observe series: bucket b
# covers (LO * R^(b-1), LO * R^b], b=0 holds everything <= LO. With
# LO=1e-3 and R=1.25 the 96 buckets span 1 microsecond to ~27 minutes
# on a millisecond-unit series at +-12% quantile resolution — plenty
# for latency reporting, and one int list per series (created lazily)
# keeps observe at O(1) memory.
HIST_LO = 1e-3
HIST_RATIO = 1.25
HIST_BUCKETS = 96
_LOG_RATIO = math.log(HIST_RATIO)


def _bucket_of(value):
    if value <= HIST_LO:
        return 0
    return min(int(math.log(value / HIST_LO) / _LOG_RATIO) + 1,
               HIST_BUCKETS - 1)


def _bucket_value(b):
    """Representative value of bucket ``b`` (geometric midpoint)."""
    if b <= 0:
        return HIST_LO
    return HIST_LO * HIST_RATIO ** (b - 0.5)


class _NullSpan:
    """The shared no-subscriber span: enter/exit are attribute-free
    no-ops, so an idle observer costs one truthiness check per
    ``trace_span`` call site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """No-op twin of :meth:`_Span.set`."""


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: ids minted at ``__enter__``, duration from
    ``perf_counter`` (monotonic — wall clocks are for event
    timestamps, never durations), emitted as one ``span`` event at
    ``__exit__``. Spans nest per THREAD (the async applier thread gets
    its own stack); a root span's trace id is its own span id."""

    __slots__ = ('_m', 'name', 'trace', 'span', 'parent', '_attrs',
                 '_links', '_t0')

    def __init__(self, m, name, links, attrs):
        self._m = m
        self.name = name
        self._links = links
        self._attrs = attrs

    def __enter__(self):
        m = self._m
        with m._lock:
            m._span_seq += 1
            sid = m._span_seq
        stack = m._span_stack()
        if stack:
            self.trace, self.parent = stack[-1]
        else:
            self.trace, self.parent = sid, 0
        self.span = sid
        stack.append((self.trace, sid))
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. the byte count
        a ``wire.serve`` only knows after the serve) — folded into the
        single ``span`` event at exit."""
        self._attrs.update(attrs)

    def __exit__(self, etype, err, tb):
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        stack = self._m._span_stack()
        if stack and stack[-1][1] == self.span:
            stack.pop()
        fields = dict(self._attrs)
        if self._links:
            fields['links'] = [list(ln) for ln in self._links]
        if err is not None:
            fields['error'] = repr(err)
        self._m.emit('span', name=self.name, trace=self.trace,
                     span=self.span, parent=self.parent,
                     dur_ms=dur_ms, **fields)
        return False


class Metrics:
    """One counter registry + histogram store + span source + event bus
    (a process-wide default lives at module level; tests can construct
    private instances)."""

    def __init__(self):
        self.counters = defaultdict(int)
        self._hists = {}               # series name -> [bucket counts]
        self._subscribers = []
        # counter updates are read-modify-write; the async applier
        # thread (device.general) and the main thread share this
        # registry, so the updates take a (cheap, per-batch) lock.
        # The subscriber list mutates ONLY under this lock too, by
        # swap-on-write — emit iterates a snapshot reference, so a
        # concurrent subscribe/unsubscribe can never corrupt the walk
        self._lock = threading.Lock()
        # span/trace ids are minted by incrementing from a random
        # 48-bit-aligned base, NOT from 0: two hosts exchanging trace
        # context through envelopes (cross-peer correlation) must not
        # collide on ids minted independently — sequential-from-zero
        # ids would merge unrelated trees the moment a second process
        # joins the fleet
        self._span_seq = int.from_bytes(os.urandom(6), 'big') << 16
        self._tls = threading.local()

    # -- counters ----------------------------------------------------------

    def bump(self, name, value=1):
        with self._lock:
            self.counters[name] += value

    def set_gauge(self, name, value):
        with self._lock:
            self.counters[name] = value

    def ratchet(self, name, value):
        """Raise gauge ``name`` to ``value`` if higher — the peak-
        watermark write (device plane / journal / resident bytes),
        atomic under the registry lock so concurrent writers can
        never record a lower peak than observed."""
        with self._lock:
            if value > self.counters[name]:
                self.counters[name] = value

    def observe(self, name, value):
        """Record one sample of a duration/size series: keeps count,
        sum and max under ``<name>.count`` / ``.sum`` / ``.max`` (the
        staging-time counters of the general engine ride this) PLUS a
        fixed log-spaced bucket histogram serving
        :meth:`quantile` — ``fleet_status()`` p50/p99s and the bench's
        ``*_p50``/``*_p99`` JSON keys read the same series. Cheap:
        three dict writes, one log, one list add; no sample history
        retained."""
        with self._lock:
            self._observe_locked(name, value)

    def _observe_locked(self, name, value):
        self.counters[name + '.count'] += 1
        self.counters[name + '.sum'] += value
        if value > self.counters[name + '.max']:
            self.counters[name + '.max'] = value
        hist = self._hists.get(name)
        if hist is None:
            hist = self._hists[name] = [0] * HIST_BUCKETS
        hist[_bucket_of(value)] += 1

    def mean(self, name):
        """Mean of an :meth:`observe` series (0.0 when empty)."""
        n = self.counters.get(name + '.count', 0)
        return self.counters.get(name + '.sum', 0) / n if n else 0.0

    def quantile(self, name, q):
        """Quantile ``q`` (0..1) of an :meth:`observe` series from its
        log-spaced buckets (+-12% bucket resolution). An empty or
        never-observed series returns ``None`` — never raises, and
        never a fake 0.0 a dashboard would read as "zero latency"
        (callers that need a number spell the default:
        ``quantile(...) or 0``). ``quantile('sync_apply_ms', 0.99)``
        is the live p99 the bench and ``fleet_status()`` both
        report."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                return None
            total = sum(hist)
            if not total:
                return None
            target = max(1, math.ceil(q * total))
            acc = 0
            for b, n in enumerate(hist):
                acc += n
                if acc >= target:
                    return _bucket_value(b)
            return _bucket_value(HIST_BUCKETS - 1)

    def snapshot(self):
        # same lock as bump(): dict(d) iterates, and the async applier
        # thread may insert a first-time counter mid-iteration
        with self._lock:
            return dict(self.counters)

    def group(self, prefix):
        """{suffix: value} of every counter under ``prefix`` — the
        bench-summary view of counter families like the general
        engine's per-variant apply counts (`general_variant_*_applies`)
        and mirror format conversions (`general_mirror_convert_*`),
        which make a fleet silently running a slow fallback visible.
        Also the per-peer read: ``group('peer/<id>/')`` is one
        connection's counters (see :meth:`scoped`)."""
        with self._lock:
            return {name[len(prefix):]: value
                    for name, value in self.counters.items()
                    if name.startswith(prefix)}

    def groups(self, prefixes):
        """``{prefix: {suffix: value}}`` for many prefixes in ONE
        registry pass — a caller polling every per-connection scope
        (``fleet_status()``) must not pay a full-registry scan per
        link, which goes quadratic in fleet size as each link's scan
        walks every other link's counters."""
        buckets = {p: {} for p in prefixes}
        by_len = defaultdict(set)
        for p in buckets:
            by_len[len(p)].add(p)
        with self._lock:
            for name, value in self.counters.items():
                for ln, heads in by_len.items():
                    head = name[:ln]
                    if head in heads:
                        buckets[head][name[ln:]] = value
        return buckets

    def reset(self):
        with self._lock:
            self.counters.clear()
            self._hists.clear()

    def reset_series(self, name):
        """Clear ONE observe series (histogram + count/sum/max) — the
        bench uses this to scope a measured phase without wiping the
        whole registry."""
        with self._lock:
            self._hists.pop(name, None)
            for suffix in ('.count', '.sum', '.max'):
                self.counters.pop(name + suffix, None)

    # -- scoped child views ------------------------------------------------

    def scoped(self, **labels):
        """A labeled child view: every ``bump``/``set_gauge``/
        ``observe`` lands BOTH process-wide and under the label prefix
        (``metrics.scoped(peer='p1').bump('sync_retransmits')`` writes
        ``sync_retransmits`` AND ``peer/p1/sync_retransmits``), and
        every ``emit`` carries the labels as event fields. This is the
        per-connection surface: the aggregate dashboards keep working,
        and ``fleet_status()`` reads one peer's slice via
        ``group('peer/<id>/')``."""
        prefix = ''.join(f'{k}/{v}/' for k, v in sorted(labels.items()))
        return _ScopedMetrics(self, prefix, labels)

    def drop_scope(self, prefix):
        """Delete every counter under a scope prefix (``peer/<id>/``).
        Scoped slices are plain registry keys, so they outlive their
        connection by design (post-mortem reads after ``close()``);
        a long-lived process whose peers churn under FRESH ids calls
        this (usually via ``ResilientConnection.close(
        drop_scope=True)``) so dead slices cannot grow the registry
        without bound. Aggregate counters are untouched."""
        if not prefix:
            return
        with self._lock:
            for name in [n for n in self.counters
                         if n.startswith(prefix)]:
                del self.counters[name]

    # -- event stream ------------------------------------------------------

    def subscribe(self, handler):
        """handler(event: dict) — called synchronously on every emit.
        Thread-safe: the list swaps under the registry lock, so a
        subscribe racing an emit on another thread sees either the old
        or the new list, never a half-mutated one."""
        with self._lock:
            if handler not in self._subscribers:
                self._subscribers = self._subscribers + [handler]

    def unsubscribe(self, handler):
        with self._lock:
            self._subscribers = [h for h in self._subscribers
                                 if h != handler]

    @property
    def active(self):
        return bool(self._subscribers)

    def emit(self, event, **fields):
        subscribers = self._subscribers    # swap-on-write snapshot
        if not subscribers:
            return
        # ts (wall clock) is the event TIMESTAMP; mono (perf_counter)
        # is for durations/ordering — wall clocks step under NTP, so
        # subtracting two ts values is never a duration
        record = {'event': event, 'ts': time.time(),
                  'mono': time.perf_counter(), **fields}
        for handler in subscribers:
            handler(record)

    # -- spans -------------------------------------------------------------

    def _span_stack(self):
        stack = getattr(self._tls, 'spans', None)
        if stack is None:
            stack = self._tls.spans = []
        return stack

    def trace_span(self, name, links=None, **attrs):
        """Context manager tracing one tick-path stage. Same contract
        as :meth:`emit`: with no subscriber this returns a shared
        null span (one truthiness check, no allocation beyond the
        caller's kwargs). With a subscriber, entering mints a span id,
        nests under the thread's current span (or starts a new trace),
        and exiting emits ONE ``span`` event carrying name,
        trace/span/parent ids, ``dur_ms`` (monotonic), optional
        ``links`` (cross-trace references, e.g. the envelopes a batched
        flush merged) and the given attrs."""
        if not self._subscribers:
            return _NULL_SPAN
        return _Span(self, name, links, attrs)

    def current_trace(self):
        """(trace_id, span_id) of the calling thread's innermost open
        span, or None — what an envelope stamps into its ``trace``
        field at send time."""
        stack = getattr(self._tls, 'spans', None)
        return stack[-1] if stack else None

    def span_event(self, name, dur_ms, **attrs):
        """Emit one COMPLETED span with an explicitly measured
        duration, parented under the calling thread's current span —
        for phases whose timing is already captured in-line (the
        device stage/dispatch split inside the fused apply) where
        wrapping hundreds of lines in a context manager would obscure
        the code. No-op without subscribers."""
        if not self._subscribers:
            return
        with self._lock:
            self._span_seq += 1
            sid = self._span_seq
        cur = self.current_trace()
        trace, parent = cur if cur is not None else (sid, 0)
        self.emit('span', name=name, trace=trace, span=sid,
                  parent=parent, dur_ms=dur_ms, **attrs)

    @contextmanager
    def trace_context(self, trace_id, span_id):
        """Adopt a REMOTE parent: spans opened inside become children
        of ``(trace_id, span_id)`` — the receive half of cross-peer
        causal correlation (the sender's flush span id arrives in the
        envelope's ``trace`` field). No-op without subscribers."""
        if not self._subscribers:
            yield
            return
        stack = self._span_stack()
        frame = (trace_id, span_id)
        stack.append(frame)
        try:
            yield
        finally:
            if stack and stack[-1] == frame:
                stack.pop()


class _ScopedMetrics:
    """See :meth:`Metrics.scoped`. Shares the parent's lock, span
    stack and subscriber list — a scope is a WRITE prefix, not a
    separate registry."""

    __slots__ = ('_parent', 'prefix', 'labels')

    def __init__(self, parent, prefix, labels):
        self._parent = parent
        self.prefix = prefix
        self.labels = labels

    @property
    def active(self):
        return self._parent.active

    @property
    def counters(self):
        return self._parent.counters

    def bump(self, name, value=1):
        parent = self._parent
        with parent._lock:
            parent.counters[name] += value
            parent.counters[self.prefix + name] += value

    def set_gauge(self, name, value):
        parent = self._parent
        with parent._lock:
            parent.counters[name] = value
            parent.counters[self.prefix + name] = value

    def observe(self, name, value):
        """Aggregate series gets the full histogram treatment; the
        scoped copy keeps count/sum/max only (per-peer quantiles would
        cost a bucket list per peer per series — the per-peer mean/max
        is the operator signal, the aggregate holds the tails)."""
        parent = self._parent
        with parent._lock:
            parent._observe_locked(name, value)
            scoped = self.prefix + name
            parent.counters[scoped + '.count'] += 1
            parent.counters[scoped + '.sum'] += value
            if value > parent.counters[scoped + '.max']:
                parent.counters[scoped + '.max'] = value

    def emit(self, event, **fields):
        self._parent.emit(event, **self.labels, **fields)

    def trace_span(self, name, links=None, **attrs):
        if not self._parent._subscribers:
            return _NULL_SPAN
        return _Span(self._parent, name, links,
                     {**self.labels, **attrs})

    def span_event(self, name, dur_ms, **attrs):
        self._parent.span_event(name, dur_ms, **self.labels, **attrs)

    def current_trace(self):
        return self._parent.current_trace()

    def trace_context(self, trace_id, span_id):
        return self._parent.trace_context(trace_id, span_id)

    def group(self, prefix=None):
        """This scope's counters (``prefix=None``), or the parent's
        ``group(prefix)``."""
        return self._parent.group(self.prefix if prefix is None
                                  else prefix)

    def mean(self, name):
        parent = self._parent
        scoped = self.prefix + name
        n = parent.counters.get(scoped + '.count', 0)
        return parent.counters.get(scoped + '.sum', 0) / n if n \
            else 0.0

    def quantile(self, name, q):
        return self._parent.quantile(name, q)

    def snapshot(self):
        return self._parent.snapshot()

    def drop(self):
        """Remove this scope's counter slice from the shared registry
        (see :meth:`Metrics.drop_scope`) — the peer-churn hook."""
        self._parent.drop_scope(self.prefix)


class FlightRecorder:
    """Bounded ring-buffer event subscriber: retains the last
    ``capacity`` events (spans included) and dumps them as JSON-lines
    — the black box the serving layer writes out on an incident
    (crash recovery, first quarantine of a doc), one file per
    incident, atomically like a snapshot.

    Subscribe it like any handler (``metrics.subscribe(recorder)``);
    it is itself callable. Thread-safe: the applier thread and the
    main thread both emit."""

    def __init__(self, capacity=4096):
        self.capacity = capacity
        self._buf = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def __call__(self, event):
        with self._lock:
            self._buf.append(event)

    def events(self):
        with self._lock:
            return list(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()

    def dump(self, path, trigger=None):
        """Write the retained events (oldest first) to ``path`` as
        JSON-lines via the snapshot layer's atomic write (tmp + fsync
        + rename) — an incident file is never torn. ``trigger`` (if
        given) is appended to the snapshot LOCALLY, so it is the
        file's last line even while another thread keeps emitting
        into the ring. Returns the event count. Non-JSON values
        serialize via ``repr``."""
        import json
        events = self.events()
        if trigger is not None:
            events.append(trigger)
        lines = '\n'.join(json.dumps(e, sort_keys=True, default=repr)
                          for e in events)
        atomic_write_bytes(path, (lines + '\n').encode()
                           if events else b'')
        return len(events)


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` atomically: tmp file in the same
    directory + fsync + rename + directory fsync. Readers see either
    the previous complete file or the new complete file."""
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


metrics = Metrics()

# Module-level conveniences bound to the default registry.
counters = metrics.snapshot
reset = metrics.reset
subscribe = metrics.subscribe
unsubscribe = metrics.unsubscribe
emit = metrics.emit
bump = metrics.bump
set_gauge = metrics.set_gauge
observe = metrics.observe
ratchet = metrics.ratchet
mean = metrics.mean
quantile = metrics.quantile
trace_span = metrics.trace_span
trace_context = metrics.trace_context
current_trace = metrics.current_trace
span_event = metrics.span_event
scoped = metrics.scoped


@contextmanager
def profile_trace(log_dir=None, name='automerge_tpu_torch'):
    """Bridge to the PyTorch profiler: wraps a block in a host+device
    trace exported as a Chrome trace under ``log_dir`` when one is
    given, else a cheap named range (``torch.profiler.record_function``,
    visible in any enclosing profiler trace)."""
    import torch
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(name):
                yield
        prof.export_chrome_trace(
            os.path.join(log_dir, f'{name}.{os.getpid()}.trace.json'))
    else:
        with torch.profiler.record_function(name):
            yield
