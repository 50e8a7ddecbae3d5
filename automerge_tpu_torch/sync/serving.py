"""ServingDocSet: the overload-safe serving layer over a general fleet.

The fleet survives lossy links (ResilientConnection) and syncs at
wire speed (WireConnection), but until this module it assumed a
cooperative, bounded world: every document stayed resident in device
arrays forever, any peer could flood a connection with arbitrarily
large blobs, and a quarantined doc sat poisoned in memory with no
lifecycle. This wrapper turns residency into a CACHE, not a capacity
bound (Okapi's availability-under-pressure framing, PAPERS.md: under
overload shed load predictably, never corrupt, converge once pressure
lifts):

- **Cold-doc eviction with transparent fault-in** — per-doc last-touch
  ticks and resident-byte estimates drive an LRU eviction policy under
  a configurable ``memory_budget_bytes``: cold docs park to durable
  checksummed shards (:func:`~automerge_tpu_torch.durability.
  write_park_shard` — full retained history, buffered queue, clock)
  and their store rows, pool nodes, mirror words, view-cache trees and
  encode-cache entries are all released. The next touch — an apply, a
  materialize, a sync advertisement that needs serving, a quarantine
  retry — faults the doc back in byte-identically (replaying the
  parked history through the normal fused apply). Quarantined docs and
  docs touched in the current tick are pinned.
- **Quarantine lifecycle** — ``park_quarantined_after`` /
  ``park_quarantined_bytes`` age/size caps move a STUCK quarantined
  doc's in-memory hold (clean state + poisoned changes) to a parked
  shard, counted under the ``serving_docs_parked`` alert counter and
  surfaced by :meth:`fleet_status`; a later corrected delivery faults
  it in and clears through the normal supersession rule.
- **Admission control / backpressure** — the connection-side valves
  (:class:`~.resilient.AdmissionControl` token buckets with explicit
  ``busy`` replies, :class:`~.connection.WireConnection`
  ``max_msg_bytes`` flow control) pair with this doc set;
  :meth:`fleet_status` folds their counters into one operator surface.

Wrap a :class:`~.general_doc_set.GeneralDocSet` directly, or a
:class:`~automerge_tpu_torch.durability.DurableDocSet` around one for the
crash-consistent stack — parked shards live next to the snapshot and
journal, and :meth:`recover` reconciles all three after a crash (a
parked doc's shard is its only durable copy once a checkpoint
snapshots the fleet without it, so shards are only garbage-collected
at checkpoint time).

Time is logical: call :meth:`tick` once per scheduling quantum (a
:class:`~.chaos.ChaosFleet` does this automatically); maintenance also
piggybacks every ``check_every`` applies so an un-ticked writer still
respects its budget.

The PyTorch port's copy of ``automerge_tpu/sync/serving.py``: fault-in
runs on the inner doc set's device; :meth:`ServingDocSet.recover`
takes ``device``.
"""

import json
import os
import time

from ..config import resolve_device
from ..device import general as _general
from ..durability import (dump_incident, read_park_shard,
                          write_park_shard)
from ..utils.metrics import metrics
from .general_doc_set import (GeneralDocHandle, _GeneralState,
                              GeneralDocSet, _latency_quantiles)


def _covers(have, clock):
    """True when clock ``have`` covers every (actor, seq) of
    ``clock``."""
    return all(have.get(a, 0) >= s for a, s in clock.items())


class _ServingState(_GeneralState):
    """Backend-state stand-in whose clock stays truthful for EVICTED
    docs (the recorded park clock, not the store's empty rows) — the
    dict protocol's stale-state guard and advertisement logic keep
    working without faulting anything in."""

    __slots__ = ()

    @property
    def clock(self):
        return self.doc_set.clock_of_id(self.doc_set.ids[self.index])


class _ServingBackendShim:
    """Connection-protocol backend surface: serving a peer that is
    behind the recorded clock is a TOUCH (faults the doc in); a peer
    already caught up is served the empty answer without a fault-in."""

    @staticmethod
    def get_missing_changes(state, have_deps):
        serving = state.doc_set
        doc_id = serving.ids[state.index]
        rec = serving._evicted.get(doc_id)
        if rec is not None and not _covers(have_deps, rec['clock']):
            serving.ensure_resident([doc_id])
        return serving.store.get_missing_changes(state.index,
                                                 have_deps)

    getMissingChanges = get_missing_changes


class ServingDocSet:
    """Overload-safe facade over a (possibly durable) GeneralDocSet.

    ``doc_set`` — a :class:`GeneralDocSet`, or a
    :class:`~automerge_tpu_torch.durability.DurableDocSet` wrapping one.
    ``dir_path`` — the durable directory; parked shards go under
    ``<dir_path>/parked/``.
    ``memory_budget_bytes`` — resident-byte ceiling (None = unbounded);
    when exceeded, cold unpinned docs evict LRU-first down to
    ``low_watermark * budget`` (hysteresis: headroom absorbs fault-ins
    between eviction passes, so a hot working set never thrashes).
    ``park_quarantined_after`` / ``park_quarantined_bytes`` — age (in
    ticks) and stored-changes size caps that park a stuck quarantined
    doc (None = keep the unbounded in-memory hold).
    ``flight_recorder`` — a :class:`~automerge_tpu_torch.utils.metrics.
    FlightRecorder`; when given, it is subscribed to the metrics bus
    and its retained events dump as an incident file (under
    ``<dir_path>/incidents/``) the FIRST time each doc quarantines —
    the black box of the seconds before the poison landed.
    """

    def __init__(self, doc_set, dir_path, memory_budget_bytes=None,
                 low_watermark=0.75, check_every=32, shard_docs=64,
                 park_quarantined_after=None,
                 park_quarantined_bytes=None, flight_recorder=None,
                 auto_compact=True):
        inner = getattr(doc_set, 'doc_set', doc_set)
        if not isinstance(inner, GeneralDocSet):
            raise TypeError(
                'ServingDocSet wraps a GeneralDocSet (optionally '
                'inside a DurableDocSet); got '
                f'{type(inner).__name__}')
        self.doc_set = doc_set
        self.inner = inner
        self.dir_path = dir_path
        self.park_dir = os.path.join(dir_path, 'parked')
        os.makedirs(self.park_dir, exist_ok=True)
        self.memory_budget_bytes = memory_budget_bytes
        self.low_watermark = low_watermark
        self.check_every = check_every
        self.shard_docs = shard_docs
        self.park_quarantined_after = park_quarantined_after
        self.park_quarantined_bytes = park_quarantined_bytes
        # tiered doc storage: with auto_compact, a snapshot-resumed
        # (truncated-log) store compacts on the first eviction need —
        # per-doc state snapshots + horizon replace the full log, so
        # eviction parks `state + tail` shards instead of refusing.
        # auto_compact=False keeps the PR 6 loud refusal
        # (serving_evictions_blocked_truncated).
        self.auto_compact = auto_compact
        self._tick = 0
        self._last_touch = {}          # doc_id -> last-touch tick
        self._evicted = {}             # doc_id -> {'clock', 'error'}
        self._park_files = {}          # doc_id -> newest shard path
        self._park_bytes = {}          # shard path -> on-disk bytes
        self._park_seq = 0
        self._quarantine_since = {}    # doc_id -> tick first seen held
        self._handles = {}
        self._ops_since_check = 0
        self._n_evictions = 0
        self._n_faultins = 0
        self._n_parked = 0
        self.resident_bytes = 0
        self.flight_recorder = flight_recorder
        if flight_recorder is not None:
            metrics.subscribe(flight_recorder)   # idempotent
        self._incident_seen = set()    # docs whose quarantine dumped
        # closed-loop adaptive control (sync/control.py): when a
        # FleetController attaches itself here, every serving quantum
        # hands it the health evaluation maintenance() already
        # performs — the controller adds no second status poll
        self.controller = None
        # health rollup wiring: the inner doc set owns the state
        # machine; this layer contributes the serving signals (parked
        # docs) and captures incidents on first entry to critical
        self.inner.health_extra = self._serving_health_signals
        self.inner.health_incident = self._health_incident
        self._reconcile_park_dir()

    # -- recovery ------------------------------------------------------------

    def _reconcile_park_dir(self):
        """Fold pre-existing parked shards (a recovery, or re-wrapping
        a directory) into the residency map. Later shards win per doc.
        A doc whose store clock already covers its park clock is
        resident (stale shard, GC'd at the next checkpoint); a doc the
        store knows nothing of is lazily evicted; the rare in-between —
        journal replay landed PARTIAL post-eviction state before this
        wrapper existed — faults in eagerly so the park history merges
        now and nothing under-advertises."""
        names = sorted(n for n in os.listdir(self.park_dir)
                       if n.startswith('park-'))
        if not names:
            self._refresh_park_gauge()
            return
        inner = self.inner
        merge_now = []
        for name in names:
            path = os.path.join(self.park_dir, name)
            self._park_bytes[path] = os.path.getsize(path)
            try:
                self._park_seq = max(self._park_seq,
                                     int(name[5:13]))
            except ValueError:
                pass
            for doc_id, payload in read_park_shard(path).items():
                self._park_files[doc_id] = path
                idx = inner._index(doc_id, create=True)
                have = inner.store.clock_of(idx)
                park_clock = payload.get('clock') or {}
                if _covers(have, park_clock):
                    self._evicted.pop(doc_id, None)
                    continue           # resident; shard is stale
                q = payload.get('quarantine')
                self._evicted[doc_id] = {
                    'clock': dict(park_clock),
                    'digest': payload.get('digest'),
                    'error': q['error'] if q else None}
                if have:
                    merge_now.append(doc_id)
        if merge_now:
            self._fault_in(merge_now)
        self._refresh_park_gauge()

    def _refresh_park_gauge(self):
        """Publish the live parked-shard disk footprint (the cold half
        of the memory accounting: evicted docs are not free, they
        moved to disk)."""
        metrics.set_gauge('mem_park_shard_bytes',
                          sum(self._park_bytes.values()))

    @classmethod
    def recover(cls, dir_path, capacity=1024, options=None,
                fsync=True, device=None, **serving_kwargs):
        """Rebuild the full durable serving stack after a crash:
        checkpoint snapshot + journal-tail replay
        (:meth:`DurableDocSet.recover <automerge_tpu_torch.durability.
        DurableDocSet.recover>`), then the parked-shard
        reconciliation. Journal records for docs evicted at crash time
        replay onto the empty store (causally buffering what needs the
        parked history) and complete on the doc's first fault-in — no
        acknowledged change is ever lost. With a ``flight_recorder``
        in ``serving_kwargs``, the recorder is subscribed up front (so
        the replay's own events are retained) and dumped as ONE
        recovery incident file once the stack is reconciled. The
        rebuilt doc set and its snapshot load land on ``device`` (None
        is the card, raising without one)."""
        from ..durability import DurableDocSet
        device = resolve_device(device)
        recorder = serving_kwargs.get('flight_recorder')
        if recorder is not None:
            metrics.subscribe(recorder)
        durable = DurableDocSet.recover(
            dir_path,
            lambda: GeneralDocSet(capacity, options=options,
                                  device=device),
            load_snapshot=lambda data: GeneralDocSet.load_snapshot(
                data, device=device),
            fsync=fsync)
        out = cls(durable, dir_path, **serving_kwargs)
        if recorder is not None:
            dump_incident(recorder, dir_path, 'recovery',
                          evicted=len(out._evicted),
                          quarantined=len(out.inner.quarantined))
            # a recovered quarantine hold is not a FRESH incident —
            # only a new poisoning after this point dumps again
            out._incident_seen.update(out.inner.quarantined)
        return out

    # -- proxy surface -------------------------------------------------------

    def __getattr__(self, name):
        if name == 'doc_set':
            raise AttributeError(name)   # guard pre-__init__ lookups
        return getattr(self.doc_set, name)

    @property
    def store(self):
        return self.inner.store

    @property
    def ids(self):
        return self.inner.ids

    @property
    def id_of(self):
        return self.inner.id_of

    @property
    def doc_ids(self):
        return list(self.inner.ids)

    docIds = doc_ids

    # -- touch bookkeeping ---------------------------------------------------

    def _touch(self, doc_ids):
        t = self._tick
        lt = self._last_touch
        for doc_id in doc_ids:
            lt[doc_id] = t

    def _after_write(self):
        if self.flight_recorder is not None:
            self._check_incidents()
        self._ops_since_check += 1
        if self.memory_budget_bytes is not None and \
                self._ops_since_check >= self.check_every:
            self._ops_since_check = 0
            self._enforce_budget()

    def _check_incidents(self):
        """Dump the flight recorder on the FIRST quarantine of each
        doc — one incident file per doc, ever (a retry loop on a
        poisoned doc must not fill the disk with identical dumps)."""
        for doc_id in self.inner.quarantined:
            if doc_id not in self._incident_seen:
                self._incident_seen.add(doc_id)
                dump_incident(
                    self.flight_recorder, self.dir_path, 'quarantine',
                    doc_id=doc_id,
                    error=self.inner.quarantined[doc_id].get('error'))

    # -- residency -----------------------------------------------------------

    def ensure_resident(self, doc_ids, peer_clocks=None):
        """Fault the evicted/parked docs among ``doc_ids`` back in (a
        TOUCH). With ``peer_clocks`` (the sync serve path), docs whose
        peer clock already covers the recorded park clock stay evicted
        — there is nothing to serve them — and come back as ``{doc_id:
        recorded clock}`` so the caller can advertise truthfully. A
        doc whose peer clock is UNKNOWN also stays evicted: the serve
        path only ships data to docs the peer has advertised, so all
        this flush can send is the recorded-clock advertisement — the
        peer's reply carries its clock, and the next flush faults in
        exactly the docs that are truly behind (a fresh connection to
        a mostly-evicted fleet must not fault the whole tail in just
        to say hello)."""
        if not self._evicted:
            return {}
        need, skipped, seen = [], {}, set()
        for doc_id in doc_ids:
            if doc_id in seen:
                continue
            seen.add(doc_id)
            rec = self._evicted.get(doc_id)
            if rec is None:
                continue
            if peer_clocks is not None:
                peer = peer_clocks.get(doc_id)
                if peer is None or _covers(peer, rec['clock']):
                    skipped[doc_id] = dict(rec['clock'])
                    continue
            need.append(doc_id)
        if need:
            self._fault_in(need)
            self._touch(need)
        return skipped

    def _fault_in(self, doc_ids):
        """Replay the parked shards of ``doc_ids`` through one fused
        apply: full history + buffered queue restore byte-identically
        (the apply path is deterministic on the change set), parked
        quarantine records return to the in-memory registry."""
        t0 = time.perf_counter()
        span = metrics.trace_span('serving.fault_in',
                                  docs=len(doc_ids))
        with span:
            self._fault_in_traced(doc_ids)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._n_faultins += len(doc_ids)
        metrics.bump('serving_faultins', len(doc_ids))
        metrics.observe('serving_faultin_ms', dt_ms)
        if metrics.active:
            metrics.emit('serving_faultin', n=len(doc_ids),
                         docs=list(doc_ids[:64]))

    def _fault_in_traced(self, doc_ids):
        import base64
        inner = self.inner
        store = inner.store
        by_shard = {}
        for doc_id in doc_ids:
            by_shard.setdefault(self._park_files[doc_id],
                                []).append(doc_id)
        payloads = {}
        for path, ids in by_shard.items():
            shard = read_park_shard(path)
            for doc_id in ids:
                payloads[doc_id] = shard[doc_id]
        per_doc = [[] for _ in
                   range(max(inner.id_of[d] for d in doc_ids) + 1)]
        queued = []
        quarantines = {}
        absorb = []                    # tiered (state-form) payloads
        merge_states = {}              # state payloads over partial docs
        for doc_id, payload in payloads.items():
            idx = inner.id_of[doc_id]
            state_b64 = payload.get('state')
            if state_b64 is not None:
                raw = base64.b64decode(state_b64)
                if store.clock_of(idx):
                    # journal replay landed partial post-eviction
                    # state before this fault-in: the absorb-or-
                    # replace logic of apply_states reconciles
                    merge_states[doc_id] = raw
                else:
                    absorb.append((idx, raw, None))
            else:
                per_doc[idx] = list(payload.get('changes') or ())
            queued.extend((idx, ch)
                          for ch in payload.get('queued') or ())
            if payload.get('quarantine'):
                quarantines[doc_id] = payload['quarantine']
        if absorb:
            from ..compaction import absorb_doc_states
            absorb_doc_states(store, absorb)
        if merge_states:
            inner.apply_states(merge_states)
        if any(per_doc):
            block = store.encode_changes(per_doc,
                                         n_docs=inner.capacity)
            _general.apply_general_block(store, block,
                                         options=inner._options)
        store.queue.extend(queued)
        for doc_id, held in quarantines.items():
            inner.quarantined[doc_id] = {
                'error': held['error'],
                'changes': list(held.get('changes') or ())}
            self._quarantine_since[doc_id] = self._tick
        for doc_id in doc_ids:
            self._evicted.pop(doc_id, None)
            self._last_touch[doc_id] = self._tick

    def _evict(self, doc_ids, parked=False):
        """Park ``doc_ids`` to durable shards, then release their
        store state. The shard write lands (atomic, fsync'd) BEFORE
        the drop — a crash anywhere leaves either the old in-memory
        truth (disk state unchanged) or a complete shard."""
        with metrics.trace_span('serving.evict', docs=len(doc_ids),
                                parked=parked):
            self._evict_traced(doc_ids, parked)
        if metrics.active:
            metrics.emit('serving_evict', n=len(doc_ids),
                         parked=parked, docs=list(doc_ids[:64]))

    def _evict_traced(self, doc_ids, parked):
        inner = self.inner
        payloads = inner.extract_doc_state(doc_ids)
        for doc_id in doc_ids:
            held = inner.quarantined.pop(doc_id, None)
            self._quarantine_since.pop(doc_id, None)
            if held is not None:
                payloads[doc_id]['quarantine'] = {
                    'error': held['error'],
                    'changes': held['changes']}
        for start in range(0, len(doc_ids), self.shard_docs):
            group = doc_ids[start:start + self.shard_docs]
            self._park_seq += 1
            path = os.path.join(self.park_dir,
                                f'park-{self._park_seq:08d}.amtpu')
            write_park_shard(path,
                             {d: payloads[d] for d in group})
            self._park_bytes[path] = os.path.getsize(path)
            for doc_id in group:
                self._park_files[doc_id] = path
        inner.drop_doc_state(doc_ids)
        for doc_id in doc_ids:
            q = payloads[doc_id].get('quarantine')
            self._evicted[doc_id] = {
                'clock': payloads[doc_id]['clock'],
                'digest': payloads[doc_id].get('digest'),
                'error': q['error'] if q else None}
        self._n_evictions += len(doc_ids)
        metrics.bump('serving_evictions', len(doc_ids))
        self._refresh_park_gauge()
        if parked:
            self._n_parked += len(doc_ids)
            metrics.bump('serving_docs_parked', len(doc_ids))
            if metrics.active:
                for doc_id in doc_ids:
                    metrics.emit('doc_parked', doc_id=doc_id)

    def _enforce_budget(self):
        if self.memory_budget_bytes is None:
            return
        inner = self.inner
        est = inner.store.doc_byte_estimates()
        n = len(inner.ids)
        total = int(est[:n].sum())
        self.resident_bytes = total
        metrics.set_gauge('serving_resident_bytes', total)
        metrics.ratchet('mem_resident_peak_bytes', total)
        if total <= self.memory_budget_bytes:
            return
        if inner.store.log_truncated:
            if self.auto_compact:
                # fold the truncated history into per-doc state
                # snapshots: the horizon + (empty) tail make every doc
                # parkable as `state + tail`, and the store comes out
                # fully servable — eviction proceeds below
                from ..compaction import compact_docset
                compact_docset(self)
            else:
                # a snapshot-resumed store cannot rebuild a parked
                # doc's history — eviction is off until the log is
                # whole again
                metrics.bump('serving_evictions_blocked_truncated')
                return
        target = int(self.memory_budget_bytes * self.low_watermark)
        quarantined = set(inner.quarantined)
        cands = []
        for idx, doc_id in enumerate(inner.ids):
            if doc_id in self._evicted or doc_id in quarantined:
                continue               # quarantined docs are PINNED
            lt = self._last_touch.get(doc_id, -1)
            if lt >= self._tick - 1:
                # pinned: touched this quantum — including the one
                # the end-of-quantum tick() just closed (tick()
                # advances _tick BEFORE maintenance, so a doc written
                # every quantum would otherwise evict at each quantum
                # boundary and fault straight back in on its next
                # write: pure park/fault-in thrash, surfaced by the
                # fleet simulator's flash-crowd scenario)
                continue
            cands.append((lt, idx, doc_id))
        cands.sort()
        victims = []
        for lt, idx, doc_id in cands:
            if total <= target:
                break
            total -= int(est[idx])
            victims.append(doc_id)
        if victims:
            self._evict(victims)
            self.resident_bytes = total

    def _park_stuck_quarantine(self):
        if self.park_quarantined_after is None and \
                self.park_quarantined_bytes is None:
            return
        inner = self.inner
        if not inner.quarantined or inner.store.log_truncated:
            return
        for doc_id in list(self._quarantine_since):
            if doc_id not in inner.quarantined:
                del self._quarantine_since[doc_id]
        to_park = []
        for doc_id, held in inner.quarantined.items():
            since = self._quarantine_since.setdefault(doc_id,
                                                      self._tick)
            aged = self.park_quarantined_after is not None and \
                self._tick - since >= self.park_quarantined_after
            big = self.park_quarantined_bytes is not None and \
                len(json.dumps(held['changes'],
                               separators=(',', ':'))) > \
                self.park_quarantined_bytes
            if aged or big:
                to_park.append(doc_id)
        if to_park:
            self._evict(to_park, parked=True)

    # -- logical time --------------------------------------------------------

    def tick(self):
        """Advance one serving quantum: age the quarantine hold, then
        enforce the memory budget."""
        self._tick += 1
        self._ops_since_check = 0
        self.maintenance()

    def maintenance(self):
        if self.flight_recorder is not None:
            self._check_incidents()
        self._park_stuck_quarantine()
        self._enforce_budget()
        # health transitions are recorded per quantum, not only when
        # an operator happens to poll fleet_status() — O(connections)
        health = self.inner.evaluate_health()
        # the adaptive-control policy tick rides the SAME evaluation
        # (one health computation per quantum, consumed twice)
        if self.controller is not None:
            self.controller.on_quantum(health)

    # -- DocSet surface (every public entry is a touch) ----------------------

    def get_doc(self, doc_id):
        idx = self.inner.id_of.get(doc_id)
        if idx is None:
            return None
        handle = self._handles.get(doc_id)
        if handle is None:
            handle = GeneralDocHandle(self, doc_id, idx)
            handle._state = {
                'backendState': _ServingState(self, idx)}
            handle._options = {'backend': _ServingBackendShim}
            self._handles[doc_id] = handle
        return handle

    getDoc = get_doc

    def set_doc(self, doc_id, doc):
        self.ensure_resident([doc_id])
        self._touch([doc_id])
        out = self.doc_set.set_doc(doc_id, doc)
        self._after_write()
        return out

    setDoc = set_doc

    def apply_changes(self, doc_id, changes):
        self.ensure_resident([doc_id])
        self._touch([doc_id])
        out = self.doc_set.apply_changes(doc_id, changes)
        self._after_write()
        return out

    applyChanges = apply_changes

    def apply_changes_batch(self, changes_by_doc, **kwargs):
        doc_ids = list(changes_by_doc)
        self.ensure_resident(doc_ids)
        self._touch(doc_ids)
        out = self.doc_set.apply_changes_batch(changes_by_doc,
                                               **kwargs)
        self._after_write()
        return out

    applyChangesBatch = apply_changes_batch

    def apply_wire(self, data, doc_ids=None):
        if doc_ids is not None:
            self.ensure_resident(doc_ids)
            self._touch(doc_ids)
        elif self._evicted:
            raise ValueError(
                'apply_wire on a serving doc set needs explicit '
                'doc_ids once docs are evicted (positional ids '
                'cannot be faulted in)')
        out = self.doc_set.apply_wire(data, doc_ids=doc_ids)
        self._after_write()
        return out

    applyWire = apply_wire

    def apply_states(self, payload_by_doc):
        """State-bootstrap absorb is a touch: evicted targets fault in
        first (the absorb-or-replace logic needs the doc's real local
        state to reconcile against), then the write path runs under
        the usual budget bookkeeping."""
        doc_ids = list(payload_by_doc)
        self.ensure_resident(doc_ids)
        self._touch(doc_ids)
        out = self.doc_set.apply_states(payload_by_doc)
        self._after_write()
        return out

    applyStates = apply_states

    def apply_state(self, doc_id, payload):
        return self.apply_states({doc_id: payload}).get(doc_id)

    applyState = apply_state

    def retry_quarantined(self, doc_ids=None):
        parked = [d for d in (doc_ids if doc_ids is not None
                              else list(self._evicted))
                  if d in self._evicted and
                  self._evicted[d].get('error')]
        if parked:
            self._fault_in(parked)
            self._touch(parked)
        return self.doc_set.retry_quarantined(doc_ids)

    retryQuarantined = retry_quarantined

    def materialize(self, doc_id):
        self.ensure_resident([doc_id])
        self._touch([doc_id])
        return self.doc_set.materialize(doc_id)

    def materialize_many(self, doc_ids):
        self.ensure_resident(doc_ids)
        self._touch(doc_ids)
        return self.doc_set.materialize_many(doc_ids)

    def materialize_all(self):
        return dict(zip(list(self.inner.ids),
                        self.materialize_many(list(self.inner.ids))))

    # -- sync support --------------------------------------------------------

    def note_peer_ack(self, doc_ids):
        """Convergence closure with eviction-aware clocks: the inner
        logic against the store clock would leave a PARKED doc's
        pending birth open forever (empty rows never compare covered)
        and ``pending_births`` would report the fleet unconverged.
        :meth:`clock_of_id` serves the recorded park clock for
        evicted docs and the store clock otherwise — an evicted doc
        every live peer has acked IS converged."""
        self.inner.note_peer_ack(doc_ids, clock_of=self.clock_of_id)

    notePeerAck = note_peer_ack

    def heartbeat_clocks(self):
        """Every doc's truthful clock for the anti-entropy beat, one
        store pass + the recorded clocks of the evicted tail — never a
        fault-in."""
        by_idx = self.inner.store.clocks_all()
        clocks = {}
        for idx, doc_id in enumerate(self.inner.ids):
            rec = self._evicted.get(doc_id)
            clocks[doc_id] = dict(rec['clock']) if rec is not None \
                else dict(by_idx.get(idx, {}))
        return clocks

    def digest_of_id(self, doc_id):
        """The doc's state digest WITHOUT faulting it in: the digest
        recorded at eviction for parked docs, the incremental store
        digest otherwise (None when unavailable — the divergence audit
        then skips the doc rather than comparing a stale zero)."""
        rec = self._evicted.get(doc_id)
        if rec is not None:
            return rec.get('digest')
        return self.inner.digest_of_id(doc_id)

    def clock_of_id(self, doc_id):
        """The doc's clock WITHOUT faulting it in (evicted docs serve
        their recorded eviction-time clock) — the divergence audit's
        compare key, so a parked doc still gets audited against the
        state it was parked with."""
        rec = self._evicted.get(doc_id)
        if rec is not None:
            return dict(rec['clock'])
        return self.inner.clock_of_id(doc_id)

    def heartbeat_digests(self):
        """The divergence-audit twin of :meth:`heartbeat_clocks`:
        resident docs serve the incremental store digests, evicted
        docs their RECORDED eviction-time digest — never a
        fault-in."""
        store = self.inner.store
        if not getattr(store, '_digest_valid', False):
            return None
        digs = store.digests_all()
        out = {}
        for idx, doc_id in enumerate(self.inner.ids):
            rec = self._evicted.get(doc_id)
            if rec is not None:
                dig = rec.get('digest')
            else:
                dig = int(digs[idx])
            if dig:
                out[doc_id] = dig
        return out

    def note_divergence(self, doc_id, **meta):
        """Record a heartbeat-detected silent divergence (see
        :meth:`GeneralDocSet.note_divergence <automerge_tpu_torch.sync.
        general_doc_set.GeneralDocSet.note_divergence>`) and dump the
        flight recorder as a divergence incident the first time each
        (doc, peer) pair reports — the black box of the beats before
        the replicas disagreed. Neither side quarantines."""
        fresh = self.inner.note_divergence(doc_id, **meta)
        if fresh and self.flight_recorder is not None:
            dump_incident(
                self.flight_recorder, self.dir_path, 'divergence',
                doc_id=doc_id, peer=meta.get('peer'),
                local_digest=meta.get('local_digest'),
                remote_digest=meta.get('remote_digest'))
        return fresh

    noteDivergence = note_divergence

    def note_peer_down(self, peer_id):
        """Membership hook with a black box: park the inner doc set's
        pending births, then dump a ``peer_down`` incident — the
        retained events of the beats before the failure detector
        declared the peer dead (the first thing an operator wants
        when a node vanishes mid-schedule)."""
        self.inner.note_peer_down(peer_id)
        if self.flight_recorder is not None:
            dump_incident(self.flight_recorder, self.dir_path,
                          'peer_down', peer=peer_id)

    notePeerDown = note_peer_down

    # -- health --------------------------------------------------------------

    def _serving_health_signals(self):
        """The serving layer's contribution to the health rollup:
        parked (stuck-quarantine) docs, and the eviction-pressure
        ratio (resident bytes over the memory budget, from the byte
        estimate the LAST enforcement pass recorded — >1 means the
        budget is breached right now and eviction is not keeping up).
        O(evicted), never O(fleet)."""
        pressure = 0.0
        if self.memory_budget_bytes:
            pressure = round(
                self.resident_bytes / self.memory_budget_bytes, 4)
        return {'parked': sum(1 for rec in self._evicted.values()
                              if rec.get('error')),
                'memory_pressure': pressure}

    def _health_incident(self, previous, state, signals, reasons):
        """First entry to critical dumps the flight recorder — the
        seconds of events that led the fleet over the line."""
        if state == 'critical' and self.flight_recorder is not None:
            dump_incident(self.flight_recorder, self.dir_path,
                          'critical', previous=previous,
                          reasons=reasons,
                          signals={k: v for k, v in signals.items()})

    # -- durability ----------------------------------------------------------

    def checkpoint(self):
        """Durable stacks only: checkpoint the wrapped DurableDocSet
        (snapshot covers every RESIDENT doc, journal truncates), then
        garbage-collect park shards no evicted doc references — an
        evicted doc's newest shard remains its durable copy."""
        checkpoint = getattr(self.doc_set, 'checkpoint', None)
        if checkpoint is None:
            raise TypeError(
                'checkpoint requires a DurableDocSet-wrapped serving '
                'set')
        checkpoint()
        live = {self._park_files[d] for d in self._evicted
                if d in self._park_files}
        for doc_id in list(self._park_files):
            if doc_id not in self._evicted:
                del self._park_files[doc_id]
        for name in os.listdir(self.park_dir):
            path = os.path.join(self.park_dir, name)
            if path not in live:
                os.unlink(path)
                self._park_bytes.pop(path, None)
        self._refresh_park_gauge()

    # -- operator surface ----------------------------------------------------

    def fleet_status(self, docs=True):
        """The serving-layer operator surface: the inner status plus
        residency totals (resident/evicted/parked counts,
        eviction/fault-in tallies, resident and encode-cache bytes,
        budget, backpressure depth) — and, with ``docs=True``, the
        per-doc decoration (``resident``/``evicted``/``parked`` state,
        last-touch tick, estimated resident bytes). Totals come from
        incrementally-maintained state and vectorized estimates:
        ``fleet_status(docs=False)`` never loops over clean resident
        docs."""
        status = self.inner.fleet_status(docs=docs)
        est = self.inner.store.doc_byte_estimates()
        n_parked = sum(1 for rec in self._evicted.values()
                       if rec.get('error'))
        if docs:
            for idx, doc_id in enumerate(self.inner.ids):
                doc = status['docs'][doc_id]
                rec = self._evicted.get(doc_id)
                if rec is None:
                    doc['state'] = 'resident'
                    doc['resident_bytes'] = int(est[idx])
                else:
                    doc['state'] = 'parked' if rec.get('error') \
                        else 'evicted'
                    doc['clock'] = dict(rec['clock'])
                    doc['quarantined'] = rec.get('error')
                    doc['resident_bytes'] = 0
                doc['last_touch'] = self._last_touch.get(doc_id, -1)
        counters = metrics.counters
        status['totals'].update({
            'resident': len(self.inner.ids) - len(self._evicted),
            'evicted': len(self._evicted) - n_parked,
            'parked': n_parked,
            'evictions': self._n_evictions,
            'fault_ins': self._n_faultins,
            'resident_bytes': int(est[:len(self.inner.ids)].sum()),
            'memory_budget_bytes': self.memory_budget_bytes,
            'wire_cache_bytes': self.inner.store._wire_cache_bytes,
            'backpressure_depth':
                counters.get('sync_backpressure_depth', 0)})
        # the serving-side latency series join the inner sync ones —
        # all read from the SAME histograms the bench's p50/p99 keys
        # report (no private timers anywhere on this surface)
        status['latency'].update(_latency_quantiles(
            ('serving_faultin_ms', 'sync_busy_wait_ms',
             'journal_fsync_ms')))
        # residency overlay on the memory block: the inner set
        # reported the device/host plane estimates; this layer owns
        # the resident/evicted split, the budget and the park shards
        status['memory'].update({
            'resident_bytes': status['totals']['resident_bytes'],
            'resident_peak_bytes':
                counters.get('mem_resident_peak_bytes', 0),
            'memory_budget_bytes': self.memory_budget_bytes,
            'park_shard_bytes': sum(self._park_bytes.values())})
        if self.controller is not None:
            # the adaptive-control knob positions + per-action totals
            # join the operator surface next to the signals that drive
            # them
            status['control'] = self.controller.status()
        return status

    fleetStatus = fleet_status

    def close(self):
        """Detach from the process-wide metrics bus (unsubscribe this
        set's flight recorder so a discarded serving stack does not
        keep the no-subscriber fast path off, nor the recorder alive,
        for the rest of the process) AND close the wrapped doc set —
        this override would otherwise shadow the durable stack's
        journal-handle close behind ``__getattr__``. Idempotent."""
        if self.flight_recorder is not None:
            metrics.unsubscribe(self.flight_recorder)
        inner_close = getattr(self.doc_set, 'close', None)
        if inner_close is not None:
            inner_close()
