"""GeneralDocSet: a Connection-compatible DocSet over the general bulk
engine — FULL documents (nested maps, lists, text, links) at batch
scale.

The reference DocSet applies changes one document at a time
(src/doc_set.js:25-33). :class:`~.dense_doc_set.DenseDocSet` batches
flat root-map fleets; this module gives the same DocSet surface to the
:class:`~automerge_tpu.device.general.GeneralStore`, so thousands of
REAL documents replicate through a :class:`~.connection.Connection` /
:class:`~.connection.BatchingConnection` with ONE fused device apply
per network tick — same messages, same clocks, same protocol
(src/connection.js).

Documents hand out as lightweight :class:`GeneralDocHandle` objects:
enough backend surface for the Connection protocol (``clock``,
``get_missing_changes`` — both served by the store's admission state
and retained log), with ``materialize()`` building the nested JSON
view from the entry columns and the insertion-tree pool on demand.

This is the PyTorch port's copy. A doc set lives on one ``device``
(CUDA by default; the constructor raises without a card unless
``device='cpu'`` is asked for).
"""

import time as _time

import numpy as np

from .. import frontend as Frontend
from ..config import resolve_device
from ..device import general as _general
from ..utils.metrics import metrics as _metrics

_ELEM_BIT = _general._ELEM_BIT
_TYPE_MAP = _general._TYPE_MAP
_TYPE_TEXT = _general._TYPE_TEXT


def _covers(have, clock):
    """True when clock ``have`` covers every (actor, seq) of
    ``clock``."""
    return all(have.get(a, 0) >= s for a, s in clock.items())


# Health thresholds: {signal: (degraded_at, critical_at)} — a signal
# at or above a bound pushes the fleet into that state (None disables
# the bound). Every signal is a CURRENT value (gauges, live counts,
# per-evaluation deltas), so health RECOVERS when pressure lifts;
# `diverged` is the exception by design — a silently diverged replica
# stays critical until an operator resolves it (`clear_divergence`).
DEFAULT_HEALTH_THRESHOLDS = {
    'replication_lag_ops': (10_000, 1_000_000),
    'lagging_docs': (1_000, 100_000),
    'convergence_ms_p99': (30_000.0, None),
    'quarantined': (1, 64),
    'diverged': (1, 1),
    'retry_exhausted': (1, 64),      # delta since the last evaluation
    'admission_debt': (64, 65_536),
    'backpressure_depth': (16, 4_096),
    'parked': (1, 64),
    # jit retraces since the last evaluation (device/profiler.py
    # shape-signature registry, process-wide): a workload that keeps
    # crossing shape buckets recompiles instead of serving — the
    # classic silent perf killer in a jit-heavy stack. A handful per
    # quantum is a warm-up; a steady stream is a storm.
    'recompile_storm': (8, 512),
    # serving layer only (health_extra): resident bytes / memory
    # budget. >1 = the budget is breached RIGHT NOW — eviction cannot
    # keep up (e.g. blocked on a truncated log) or the working set is
    # pinned hot; well past it, the process is headed for the OOM
    # killer.
    'memory_pressure': (1.0, 2.0),
    # membership: registered links whose peer the transport failure
    # detector has declared dead (`link_state == 'down'`). One dead
    # peer degrades the fleet (writes keep applying locally, its
    # traffic parks); the signal is a live count, so a healed peer
    # clears it on the next evaluation.
    'membership': (1, None),
}
_HEALTH_RANK = {'green': 0, 'degraded': 1, 'critical': 2}


def _latency_quantiles(series):
    """{series: {'p50': ms, 'p99': ms, 'count': n}} for the observe
    series that have samples — the fleet_status() latency block, read
    from the very histogram series the bench JSON keys report."""
    out = {}
    for name in series:
        count = _metrics.counters.get(name + '.count', 0)
        if count:
            out[name] = {'p50': _metrics.quantile(name, 0.5),
                         'p99': _metrics.quantile(name, 0.99),
                         'count': count}
    return out


class _GeneralBackendShim:
    """The backend-module surface Connection resolves via
    `doc._options['backend']` (connection.py _backend_of)."""

    @staticmethod
    def get_missing_changes(state, have_deps):
        return state.doc_set.store.get_missing_changes(
            state.index, have_deps)

    getMissingChanges = get_missing_changes


class _GeneralState:
    """Backend-state stand-in for one general-store document."""

    __slots__ = ('doc_set', 'index')

    def __init__(self, doc_set, index):
        self.doc_set = doc_set
        self.index = index

    @property
    def clock(self):
        return self.doc_set.store.clock_of(self.index)


class GeneralDocHandle:
    """Lazy view of one document in a GeneralDocSet."""

    def __init__(self, doc_set, doc_id, index):
        self._doc_set = doc_set
        self._doc_id = doc_id
        self._index = index
        self._state = {'backendState': _GeneralState(doc_set, index)}
        self._options = {'backend': _GeneralBackendShim}

    def materialize(self):
        return self._doc_set.materialize(self._doc_id)

    def __getitem__(self, key):
        return self.materialize()[key]

    def __contains__(self, key):
        return key in self.materialize()

    def items(self):
        return self.materialize().items()

    def keys(self):
        return self.materialize().keys()


class GeneralDocSet:
    """A DocSet whose documents live in one general bulk store.

    ``capacity`` documents at most (the store's document axis);
    document ids map to store doc indexes on first touch. The full op
    set is in scope — nested objects, lists, text, links, causal
    buffering, conflicts. ``device`` holds the store's device mirror
    and runs every fused apply (None: CUDA).
    """

    def __init__(self, capacity, options=None, auto_grow=True,
                 device=None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.auto_grow = auto_grow
        self.store = _general.init_store(capacity, device=self.device)
        self._options = options
        self.ids = []                  # index -> doc_id
        self.id_of = {}                # doc_id -> index
        self.handlers = []
        self._handles = {}
        self._entry_csr = (None, None, None)   # (e_doc ref, order, starts)
        # dirty-doc view cache: idx -> (applied version, tree). The
        # store bumps a per-doc version for exactly the docs an apply
        # touched; clean docs re-serve the SAME tree object (treat
        # materialized views as immutable), so a sparse tick
        # re-materializes O(dirty), not O(fleet).
        self._views = {}
        # poisoned-doc registry: doc_id -> {'error': repr(exc),
        # 'changes': [...]} for docs whose changes raised under
        # isolation (apply_changes_batch(isolate=True)). The doc
        # itself rolled back (store state as if the changes never
        # arrived); entries are retriable via retry_quarantined() and
        # clear on any later successful apply for that doc.
        self.quarantined = {}
        # peer_id -> ResilientConnection: links that identify
        # themselves (peer_id=...) register here so fleet_status()
        # can report per-CONNECTION backpressure/admission state
        # instead of only process-wide counters
        self.connections = {}
        # wire-v3 session records, one per peer id: {'acked': doc_id ->
        # clock}, written live by the registered ResilientConnection.
        # A NEW connection to a known peer resumes its record — the
        # O(divergence) reconnect seed; a replaced doc set starts empty
        # (crash recovery: nothing to resume against)
        self.wire_sessions = {}
        # vectorized twin of the view cache's versions: _view_ver[i]
        # is the applied version the cached view of doc i was built at
        # (-1 = no view) — fleet_status() derives the dirty TOTAL from
        # one numpy compare against the store's _doc_version instead
        # of a per-doc Python loop over clean docs
        self._view_ver = np.full(capacity, -1, np.int64)
        # divergence audit registry: doc_id -> {'peer', 'local_digest',
        # 'remote_digest', 'clock'} — silently diverged replicas a
        # heartbeat digest compare reported (sync_divergence_detected).
        # Deliberately sticky: health stays critical until an operator
        # resolves the divergence and calls clear_divergence()
        self.diverged = {}
        # convergence-latency tracking: doc_id -> perf_counter of its
        # latest local apply while peers were registered; cleared (and
        # observed into sync_convergence_ms) once every registered
        # peer's acked clock covers the doc's clock
        self._births = {}
        # membership: peers the transport failure detector declared
        # dead (note_peer_down/note_peer_up), and the convergence
        # births PARKED against them — a birth can never close while
        # a registered peer is down, so it moves aside (not leaked,
        # not reported as a forever-growing pending figure) and is
        # restored when the last down peer heals. Convergence latency
        # stays truthful: the original birth stamp survives the park,
        # so downtime counts.
        self._down_peers = set()
        self._parked_births = {}
        # health/SLO rollup state (fleet_status()['health']);
        # health_extra (callable -> dict) merges wrapper-layer signals
        # (the serving layer's parked count), health_incident fires on
        # every state transition (the serving layer dumps the flight
        # recorder on first entry to critical)
        self.health_thresholds = dict(DEFAULT_HEALTH_THRESHOLDS)
        self.health_extra = None
        self.health_incident = None
        self._health_state = 'green'
        # baseline for the retry_exhausted delta signal: the sum over
        # THIS doc set's registered links' scoped slices (none yet)
        self._health_last_exhausted = 0
        # baseline for the recompile_storm delta signal — None until
        # the FIRST evaluation records it: the retrace counter is
        # process-wide, so a doc set created late in a process must
        # not inherit every compile that ever happened as its first
        # "storm"
        self._health_last_retraces = None
        # the GeneralPatch of the latest fused apply: the reference drops
        # it, and so does the sync protocol; a caller that feeds
        # frontends reads its diffs (the first read runs the patch-read
        # edit stream for the whole tick). Replaced every apply, so at
        # most one tick's device outputs stay referenced.
        self.last_patch = None

    # -- DocSet surface ------------------------------------------------------

    @property
    def doc_ids(self):
        return list(self.ids)

    docIds = doc_ids

    def _index(self, doc_id, create=False):
        idx = self.id_of.get(doc_id)
        if idx is None and create:
            if len(self.ids) >= self.capacity:
                if not self.auto_grow:
                    raise ValueError(
                        f'GeneralDocSet is full: document '
                        f'{len(self.ids) + 1} exceeds the configured '
                        f'capacity of {self.capacity}. Construct with '
                        f'a larger capacity, or auto_grow=True to let '
                        f'the store widen on demand (document growth '
                        f'is O(new docs); existing indexes and the '
                        f'device mirror are kept).')
                # doubling clamps to the store's 4M-document key space
                # (growth to any legal size must not raise early)
                self.grow(min(max(2 * self.capacity,
                                  len(self.ids) + 1), (1 << 22) - 1))
                if len(self.ids) >= self.capacity:
                    raise ValueError(
                        f'{len(self.ids) + 1} documents exceed the '
                        f'4M-document key space')
            idx = len(self.ids)
            self.id_of[doc_id] = idx
            self.ids.append(doc_id)
        return idx

    def grow(self, new_capacity):
        """Widen the document axis to ``new_capacity`` (no-op when
        already at least that wide). Existing documents keep their
        indexes; the store's sparse per-doc state and the resident
        mirror are untouched."""
        if new_capacity <= self.capacity:
            return
        self.store.grow_docs(new_capacity)
        self._view_ver = np.concatenate(
            [self._view_ver,
             np.full(new_capacity - self.capacity, -1, np.int64)])
        self.capacity = new_capacity

    def get_doc(self, doc_id):
        idx = self.id_of.get(doc_id)
        if idx is None:
            return None
        handle = self._handles.get(doc_id)
        if handle is None:
            handle = self._handles[doc_id] = GeneralDocHandle(
                self, doc_id, idx)
        return handle

    getDoc = get_doc

    def set_doc(self, doc_id, doc):
        """Adopt a frontend document by replaying ONLY the changes the
        store lacks: the document's log is filtered by the store's
        clock for this doc index, so a live-edit loop (edit -> adopt ->
        edit ...) pays O(new changes) per adoption, independent of
        history length — not an O(history) full replay."""
        if isinstance(doc, GeneralDocHandle):
            if doc._doc_set is self:
                return doc
            raise ValueError(
                'handle belongs to a different GeneralDocSet')
        from .doc_set import backend_of as _backend_of
        state = Frontend.get_backend_state(doc)
        idx = self.id_of.get(doc_id)
        have = self.store.clock_of(idx) if idx is not None else {}
        changes = _backend_of(doc).get_missing_changes(state, have)
        return self.apply_changes(doc_id, changes)

    setDoc = set_doc

    def apply_changes(self, doc_id, changes):
        return self.apply_changes_batch({doc_id: changes})[doc_id]

    applyChanges = apply_changes

    def apply_changes_batch(self, changes_by_doc, isolate=False):
        """ONE fused device apply for the whole batch; handlers fire
        per requested document afterwards.

        With ``isolate=True`` (the :meth:`BatchingConnection.flush
        <automerge_tpu.sync.connection.BatchingConnection.flush>`
        route) a fault in ANY doc's changes no longer aborts the tick:
        the fused attempt rolls back (store-intact-on-error via the
        engine's ``_Txn``) and each doc re-applies individually — docs
        whose changes raise are quarantined (:attr:`quarantined`,
        counted under ``sync_docs_quarantined``) while every other doc
        applies normally. Returns only the docs that applied. With the
        default ``isolate=False`` the first fault raises after
        rollback, unchanged."""
        if isolate:
            # fleet-level failures are NOT per-doc poison: register
            # every doc index up front so a capacity/key-space error
            # raises its actionable sizing message instead of silently
            # quarantining the whole tick
            for doc_id in changes_by_doc:
                self._index(doc_id, create=True)
            try:
                out = self._apply_batch_fused(changes_by_doc)
            except Exception:
                out = {}
                for doc_id, changes in changes_by_doc.items():
                    try:
                        out.update(self._apply_batch_fused(
                            {doc_id: changes}))
                    except Exception as err:
                        self.quarantined[doc_id] = {
                            'error': repr(err),
                            'changes': list(changes)}
                        _metrics.bump('sync_docs_quarantined')
                        if _metrics.active:
                            _metrics.emit('doc_quarantined',
                                          doc_id=doc_id,
                                          error=repr(err))
        else:
            out = self._apply_batch_fused(changes_by_doc)
        # a successful delivery for a quarantined doc clears the entry
        # only if its STORED changes now apply too (a corrected
        # redelivery makes them duplicates -> no-op -> cleared; a
        # transiently-failed batch re-applies for real; still-poisoned
        # changes stay quarantined rather than being silently dropped)
        self.retry_quarantined([d for d in out if d in self.quarantined])
        return out

    def _apply_batch_fused(self, changes_by_doc):
        t0 = _time.perf_counter()
        idxs = {self._index(doc_id, create=True): changes
                for doc_id, changes in changes_by_doc.items()}
        # size to the touched prefix, not the capacity — a sparse tick
        # must not pay O(capacity) host work
        per_doc = [[] for _ in range(max(idxs, default=-1) + 1)]
        for idx, changes in idxs.items():
            per_doc[idx] = list(changes)
        with _metrics.trace_span('doc_set.apply',
                                 docs=len(changes_by_doc)):
            with _metrics.trace_span('admit.encode'):
                block = self.store.encode_changes(per_doc,
                                                  n_docs=self.capacity)
            self.last_patch = _general.apply_general_block(
                self.store, block, options=self._options)
        _metrics.observe('sync_apply_ms',
                         (_time.perf_counter() - t0) * 1e3)
        self._note_births(changes_by_doc)
        out = {}
        for doc_id in changes_by_doc:
            doc = self.get_doc(doc_id)
            out[doc_id] = doc
            for handler in list(self.handlers):
                handler(doc_id, doc)
        return out

    def retry_quarantined(self, doc_ids=None):
        """Re-attempt the stored changes of quarantined docs (all of
        them, or just ``doc_ids``) — e.g. after the fault's cause was
        fixed. Stored changes whose ``(actor, seq)`` the doc's clock
        already covers are SUPERSEDED (a corrected redelivery landed)
        and drop; the rest re-apply. Docs that come clean leave
        quarantine and are returned; docs that fail again stay
        quarantined with the fresh error."""
        targets = list(self.quarantined) if doc_ids is None \
            else [d for d in doc_ids if d in self.quarantined]
        out = {}
        for doc_id in targets:
            held_state = self.quarantined[doc_id].get('state')
            if held_state is not None:
                # a state-bootstrap hold: re-attempt the absorb (a
                # truly corrupt payload fails again and stays held
                # with the fresh error — never a trivial clear over a
                # still-empty doc)
                self.quarantined.pop(doc_id, None)
                got = self.apply_states({doc_id: held_state})
                if doc_id in got:
                    out[doc_id] = got[doc_id]
                    if _metrics.active:
                        _metrics.emit('doc_quarantine_cleared',
                                      doc_id=doc_id,
                                      superseded=False)
                continue
            idx = self.id_of.get(doc_id)
            clock = self.store.clock_of(idx) if idx is not None else {}
            pending = [c for c in self.quarantined[doc_id]['changes']
                       if not isinstance(c, dict) or c.get('seq', 0) >
                       clock.get(c.get('actor'), 0)]
            if not pending:
                self.quarantined.pop(doc_id, None)
                out[doc_id] = self.get_doc(doc_id)
                if _metrics.active:
                    _metrics.emit('doc_quarantine_cleared',
                                  doc_id=doc_id, superseded=True)
                continue
            try:
                out.update(self._apply_batch_fused({doc_id: pending}))
                self.quarantined.pop(doc_id, None)
                if _metrics.active:
                    _metrics.emit('doc_quarantine_cleared',
                                  doc_id=doc_id, superseded=False)
            except Exception as err:
                self.quarantined[doc_id]['error'] = repr(err)
        return out

    applyChangesBatch = apply_changes_batch

    # -- convergence / divergence observability ------------------------------

    def _note_births(self, doc_ids):
        """Stamp the convergence birth of a local apply: the
        ``sync_convergence_ms`` series measures from here to the tick
        every registered peer's acked clock covers the doc. Free when
        no peer-identified connection is registered (the bench's raw
        Connection fleets, standalone doc sets). Assumes the
        full-replication topology every fleet here uses: a doc some
        registered peer never replicates keeps its birth pending —
        truthfully, the fleet has not converged it — and shows up in
        ``pending_births``; births drop when the last connection
        unregisters."""
        if not self.connections:
            return
        t = _time.perf_counter()
        if self._down_peers:
            # with a peer down the fleet provably cannot cover new
            # writes: park the birth directly (restored on heal,
            # earliest stamp kept) instead of letting pending_births
            # grow for the whole outage
            parked = self._parked_births
            for doc_id in doc_ids:
                parked.setdefault(doc_id, t)
            if doc_ids:
                _metrics.bump('membership_births_parked',
                              len(doc_ids))
            return
        births = self._births
        for doc_id in doc_ids:
            births[doc_id] = t

    def note_peer_down(self, peer_id):
        """Membership hook — the transport failure detector declared
        ``peer_id`` dead. Park every pending convergence birth: none
        of them can close while a registered peer acks nothing, and
        leaking them as an ever-growing ``pending_births`` would read
        as a convergence bug instead of the outage it is. The original
        birth stamps survive, so convergence latency keeps counting
        the downtime when the births are restored on heal."""
        self._down_peers.add(peer_id)
        if self._births:
            moved = 0
            parked = self._parked_births
            for doc_id, t0 in self._births.items():
                prev = parked.get(doc_id)
                parked[doc_id] = t0 if prev is None \
                    else min(prev, t0)
                moved += 1
            self._births.clear()
            _metrics.bump('membership_births_parked', moved)

    notePeerDown = note_peer_down

    def note_peer_up(self, peer_id):
        """Membership hook — a down peer healed. Once NO registered
        peer remains down, restore the parked births (earliest stamp
        wins, so re-parked docs never shorten their own latency) and
        let the normal ack flow close them."""
        self._down_peers.discard(peer_id)
        if self._down_peers or not self._parked_births:
            return
        births = self._births
        for doc_id, t0 in self._parked_births.items():
            prev = births.get(doc_id)
            births[doc_id] = t0 if prev is None else min(prev, t0)
        self._parked_births.clear()

    notePeerUp = note_peer_up

    def note_peer_ack(self, doc_ids, clock_of=None):
        """A registered link folded new acked clocks for ``doc_ids``:
        close out any birth the whole fleet now covers. O(notified
        docs x peers); called by :class:`~.resilient.
        ResilientConnection` on acks, data clocks and heartbeats.
        ``clock_of`` overrides the per-doc clock source (the serving
        wrapper passes its eviction-aware reader, so a PARKED doc's
        birth still closes against its recorded park clock instead of
        the store's empty rows)."""
        births = self._births
        if not births or not self.connections:
            return
        conns = list(self.connections.values())
        store = self.store
        now = _time.perf_counter()
        for doc_id in doc_ids:
            t0 = births.get(doc_id)
            if t0 is None:
                continue
            if clock_of is not None:
                clock = clock_of(doc_id)
            else:
                idx = self.id_of.get(doc_id)
                if idx is None:
                    continue
                clock = store.clock_of(idx)
            if not clock:
                continue
            if all(_covers(c.acked_clock(doc_id), clock)
                   for c in conns):
                del births[doc_id]
                _metrics.observe('sync_convergence_ms',
                                 (now - t0) * 1e3)

    notePeerAck = note_peer_ack

    def convergence_watermark(self, doc_ids=None):
        """``{doc_id: clock}`` — per doc, the minimum clock EVERY
        registered live peer has acked (the fleet convergence
        watermark: everything at or below it is fully replicated).
        Empty clocks mean some peer has acked nothing for the doc.
        O(docs x peers) — an operator read, not a tick-path one."""
        conns = list(self.connections.values())
        out = {}
        for doc_id in (self.ids if doc_ids is None else doc_ids):
            if not conns:
                out[doc_id] = {}
                continue
            acked = [c.acked_clock(doc_id) for c in conns]
            floor = {}
            for actor in acked[0]:
                lo = min(a.get(actor, 0) for a in acked)
                if lo:
                    floor[actor] = lo
            out[doc_id] = floor
        return out

    convergenceWatermark = convergence_watermark

    def clock_of_id(self, doc_id):
        """The doc's clock by id (the divergence audit's compare
        key)."""
        idx = self.id_of.get(doc_id)
        return self.store.clock_of(idx) if idx is not None else {}

    def digest_of_id(self, doc_id):
        """The doc's incremental state digest, or None when digests
        are unavailable (unknown doc, a pre-digest snapshot
        resume)."""
        if not getattr(self.store, '_digest_valid', False):
            return None
        idx = self.id_of.get(doc_id)
        return self.store.digest_of(idx) if idx is not None else None

    def heartbeat_digests(self):
        """``{doc_id: digest}`` for the anti-entropy beat (non-zero
        digests only — a doc with no admitted changes has nothing to
        audit), or None when this store's digest history is
        unreconstructable (then heartbeats stay wire-identical v1)."""
        store = self.store
        if not getattr(store, '_digest_valid', False):
            return None
        digs = store.digests_all()
        return {doc_id: int(digs[i])
                for i, doc_id in enumerate(self.ids) if digs[i]}

    def note_divergence(self, doc_id, peer=None, local_digest=None,
                        remote_digest=None, clock=None):
        """Record one silently diverged doc (report, don't guess:
        neither side quarantines — the digest proves disagreement, not
        which replica is right). Returns True when the record is NEW
        for this (doc, peer) pair — the held record accumulates every
        reporting peer, so two auditing peers alternating heartbeats
        count once EACH, never once per beat."""
        held = self.diverged.get(doc_id)
        if held is not None:
            if peer in held['peers']:
                return False
            held['peers'].append(peer)
            return True
        self.diverged[doc_id] = {
            'peer': peer, 'peers': [peer],
            'local_digest': local_digest,
            'remote_digest': remote_digest, 'clock': clock}
        return True

    noteDivergence = note_divergence

    def clear_divergence(self, doc_id=None):
        """Operator hook: drop the sticky divergence record(s) after
        resolving them (e.g. resyncing one side from a snapshot)."""
        if doc_id is None:
            self.diverged.clear()
        else:
            self.diverged.pop(doc_id, None)

    clearDivergence = clear_divergence

    # -- tiered doc storage: state-snapshot bootstrap ------------------------

    def serve_state_payload(self, doc_id):
        """``(state_payload_bytes, horizon_clock)`` for a compacted
        doc — what the sync layer ships to a peer whose clock predates
        the horizon — or None when the doc has no horizon record (its
        full history is servable). The payload is the snapshot
        recorded at the fold point, served to any number of cold peers
        with zero re-extraction (the state twin of the per-change
        encode cache)."""
        idx = self.id_of.get(doc_id)
        if idx is None:
            return None
        rec = self.store.horizon.get(idx)
        if rec is None or rec.get('state') is None:
            return None
        return rec['state'], dict(rec['clock'])

    serveStatePayload = serve_state_payload

    def apply_state(self, doc_id, payload):
        """Absorb one doc's state-snapshot payload (see
        :meth:`apply_states`)."""
        return self.apply_states({doc_id: payload}).get(doc_id)

    applyState = apply_state

    def apply_states(self, payload_by_doc):
        """Bootstrap documents from encoded state snapshots (the
        receive side of the ``'state'`` sync message, and the park-
        shard/journal restore path): each payload absorbs into the
        store in one bulk pass — columnar planes, insertion trees,
        clock, causal-closure rows and the recorded digest — and the
        doc's horizon record is installed so this replica can serve
        further cold peers from the same snapshot.

        An empty local doc absorbs directly. A doc whose clock the
        snapshot already covers keeps its (superset) state — the stale
        ship drops. A doc holding changes CONCURRENT with the snapshot
        replays like the dict path's snapshot resume: local-only
        changes are collected, the doc's state drops, the snapshot
        absorbs, and the local changes re-apply on top. Faults
        isolate per document (a corrupt payload quarantines the doc,
        never the tick); returns ``{doc_id: handle}`` for the docs
        touched."""
        from .. import compaction as _compaction
        store = self.store
        absorb = []                    # (idx, payload, decoded)
        replace = []                   # (idx, payload, decoded, local)
        out = {}
        for doc_id, payload in payload_by_doc.items():
            idx = self._index(doc_id, create=True)
            try:
                decoded = _compaction.decode_state_snapshot(payload)
                have = store.clock_of(idx)
                sclock = decoded['clock']
                if have and _covers(have, sclock):
                    out[doc_id] = self.get_doc(doc_id)
                    continue           # stale ship: local is a superset
                if not have:
                    absorb.append((idx, payload, decoded))
                else:
                    # concurrent local state: keep what the snapshot
                    # does not cover, replace the rest (raises the
                    # clear both-truncated error when local history
                    # below the snapshot clock is itself gone)
                    local_only = store.get_missing_changes(idx, sclock)
                    replace.append((idx, payload, decoded, local_only))
            except Exception as err:
                # keep the PAYLOAD in the hold (the change path keeps
                # its changes): retry_quarantined re-attempts the
                # absorb for real instead of trivially clearing an
                # empty change list over a still-empty doc
                self.quarantined[doc_id] = {'error': repr(err),
                                            'changes': [],
                                            'state': bytes(payload)}
                _metrics.bump('sync_docs_quarantined')
                if _metrics.active:
                    _metrics.emit('doc_quarantined', doc_id=doc_id,
                                  error=repr(err))
        if replace:
            self.drop_doc_state([self.ids[i]
                                 for i, _, _, _ in replace])
        items = absorb + [(i, p, dec) for i, p, dec, _ in replace]
        if items:
            # drop_doc_state REBUILDS the store object: absorb into
            # the current one, not the pre-drop reference
            _compaction.absorb_doc_states(self.store, items)
            _metrics.bump('sync_state_bootstraps', len(items))
        local_re = {self.ids[i]: ch
                    for i, _, _, ch in replace if ch}
        if local_re:
            self.apply_changes_batch(local_re, isolate=True)
        if items and self.store.queue:
            # causally-buffered tail changes that raced ahead of the
            # state ship merge now instead of waiting for unrelated
            # traffic
            queued_docs = {d for d, _ in self.store.queue}
            kick = {self.ids[i]: [] for i, _, _ in items
                    if i in queued_docs}
            if kick:
                self.apply_changes_batch(kick)
        for idx, _, _ in items:
            doc_id = self.ids[idx]
            doc = out[doc_id] = self.get_doc(doc_id)
            for handler in list(self.handlers):
                handler(doc_id, doc)
        return out

    applyStates = apply_states

    # -- cold-doc eviction mechanism (policy lives in ServingDocSet) --------

    def extract_doc_state(self, doc_ids):
        """The parkable state of each doc in ``doc_ids``: any
        causally-buffered queued changes, the clock/digest, and either
        its FULL retained change history (admission order —
        re-applying it deterministically reproduces the doc,
        byte-identical) or, when the history is not fully servable (a
        compacted doc, or a snapshot-resumed truncated log with
        compaction available), a freshly-extracted STATE snapshot
        (``'state'``, base64-armored for the JSON shard container) —
        the ``state + tail`` park tier. Raises the store's
        retention ValueError only when neither tier can represent the
        doc."""
        import base64
        store = self.store
        store._commit_pending()
        store.pool.sync()
        queued = {}                    # idx -> buffered changes
        want = {self.id_of[d] for d in doc_ids}
        for d, ch in store.queue:
            if d in want:
                queued.setdefault(d, []).append(ch)
        digests_ok = getattr(store, '_digest_valid', False)
        out = {}
        state_docs = []
        for doc_id in doc_ids:
            idx = self.id_of[doc_id]
            rec = {
                'doc_id': doc_id,
                'clock': store.clock_of(idx),
                'queued': queued.get(idx, []),
                # the recorded digest keeps the divergence audit (and
                # its heartbeat advertisement) truthful while the doc
                # is parked; fault-in refolds it from the replay
                'digest': store.digest_of(idx) if digests_ok else None}
            if idx in store.horizon or store.log_truncated:
                state_docs.append((doc_id, idx))
            else:
                rec['changes'] = store.get_missing_changes(idx, {})
            out[doc_id] = rec
        if state_docs:
            from .. import compaction as _compaction
            states = _compaction.extract_doc_states(
                store, [idx for _, idx in state_docs])
            for doc_id, idx in state_docs:
                out[doc_id]['state'] = base64.b64encode(
                    states[idx]['state']).decode('ascii')
        return out

    def drop_doc_state(self, doc_ids, chunk_docs=512):
        """Release the store state of ``doc_ids`` (call
        :meth:`extract_doc_state` FIRST — this drops their history).
        The shared columnar store cannot excise one doc's rows in
        place, so the store REBUILDS: every other doc's retained log
        re-applies (in ``chunk_docs`` fused batches) into a fresh store
        at its existing index — doc ids, indexes and live handles all
        stay valid; entry rows, pool nodes, retained bodies, mirror
        words and encode-cache entries of the dropped docs are
        released wholesale. Per-doc applied versions carry over, so
        cached views of the surviving docs keep serving."""
        drop = {self.id_of[d] for d in doc_ids}
        old = self.store
        old._commit_pending()
        old.pool.sync()
        new_store = _general.init_store(self.capacity,
                                        device=self.device)
        resident = [i for i in range(len(self.ids)) if i not in drop]
        # compacted survivors restore tiered: their state-at-horizon
        # absorbs wholesale (no pre-horizon bodies exist to replay),
        # then the retained TAIL re-applies on top like any other log
        compacted = [i for i in resident if i in old.horizon]
        if compacted:
            from .. import compaction as _compaction
            _compaction.absorb_doc_states(
                new_store,
                [(i, old.horizon[i]['state'], None)
                 for i in compacted])
        horizon_clock = {i: old.horizon[i]['clock'] for i in compacted}
        for start in range(0, len(resident), chunk_docs):
            batch = resident[start:start + chunk_docs]
            per_doc = [[] for _ in range(max(batch) + 1)]
            any_changes = False
            for i in batch:
                changes = old.get_missing_changes(
                    i, horizon_clock.get(i, {}))
                if changes:
                    per_doc[i] = changes
                    any_changes = True
            if any_changes:
                block = new_store.encode_changes(per_doc,
                                                 n_docs=self.capacity)
                _general.apply_general_block(new_store, block,
                                             options=self._options)
        # causally-buffered changes of surviving docs ride along (they
        # merge into the next apply, exactly as they would have)
        new_store.queue = [(d, ch) for d, ch in old.queue
                           if d not in drop]
        # applied versions carry over so the dirty-doc view cache stays
        # keyed correctly: surviving docs' cached views remain valid
        # (identical state), and the NEXT real apply still bumps past
        # every carried version
        new_store._doc_version = old._doc_version.copy()
        new_store._apply_seq = max(old._apply_seq,
                                   new_store._apply_seq)
        # the rebuild refolded surviving docs' digests from their
        # replayed logs (and absorbed horizon digests); an invalid
        # source history stays invalid either way
        new_store._digest_valid = (old._digest_valid and
                                   new_store._digest_valid)
        new_store.adopt_wire_cache(old, drop_docs=drop)
        self.store = new_store
        for i in drop:
            self._views.pop(i, None)
            self._view_ver[i] = -1
        self._entry_csr = (None, None, None)

    def fleet_status(self, docs=True):
        """Operator surface over the whole fleet (ROADMAP "Quarantine
        operator surface"): fleet totals, per-connection state, live
        latency quantiles, the convergence summary and the health
        rollup — plus, with ``docs=True``, the per-doc ``{'clock':
        {actor: seq}, 'quarantined': error-repr-or-None, 'dirty':
        bool}`` map (``dirty`` = the cached materialized view is
        stale). The TOTALS are served from incrementally-maintained
        state (registry counters, one vectorized view-version compare)
        — ``fleet_status(docs=False)`` does no per-doc Python work at
        all, so a monitoring loop polling a 10240-doc fleet stays
        O(connections), not O(fleet)."""
        store = self.store
        n = len(self.ids)
        # dirty total: ONE numpy compare of the cached-view versions
        # against the store's applied versions (no per-doc probes)
        n_dirty = int((self._view_ver[:n] !=
                       store._doc_version[:n]).sum()) if n else 0
        connections = self._connection_statuses()
        out = {'totals': {'docs': n,
                          'capacity': self.capacity,
                          'quarantined': len(self.quarantined),
                          'diverged': len(self.diverged),
                          'dirty': n_dirty},
               # per-CONNECTION backpressure/admission/retransmit/lag
               # state (every peer-identified ResilientConnection
               # self-registers) — the counter slices come from ONE
               # bucketed registry pass (metrics.groups), not a full
               # scan per link
               'connections': connections,
               # tick-path latencies from the SAME histogram series
               # the bench's *_p50/*_p99 JSON keys read — now
               # including the sampled device-phase attribution
               'latency': _latency_quantiles(
                   ('sync_apply_ms', 'sync_flush_ms',
                    'sync_convergence_ms', 'device_admit_ms',
                    'device_pack_ms', 'device_dispatch_ms',
                    'device_run_ms', 'device_idx_update_ms',
                    'device_patch_read_ms')),
               'memory': self._memory_summary(),
               'convergence': self._convergence_summary(),
               'health': self.evaluate_health()}
        if docs:
            clocks = store.clocks_all()
            doc_map = {}
            for idx, doc_id in enumerate(self.ids):
                held = self.quarantined.get(doc_id)
                doc_map[doc_id] = {
                    'clock': dict(clocks.get(idx, {})),
                    'quarantined': held['error'] if held else None,
                    'dirty': bool(self._view_ver[idx] !=
                                  store._doc_version[idx])}
            out['docs'] = doc_map
        return out

    def _link_lag(self):
        """``(lag_ops_total, lagging_docs_max)`` from the per-link
        gauges the heartbeats refresh — O(connections) registry reads,
        no per-doc work."""
        counters = _metrics.counters
        lag = 0
        lagging = 0
        for conn in self.connections.values():
            prefix = getattr(conn.metrics, 'prefix', '')
            lag += counters.get(
                prefix + 'sync_replication_lag_ops', 0)
            lagging = max(lagging, counters.get(
                prefix + 'sync_lagging_docs', 0))
        return lag, lagging

    def _memory_summary(self):
        """The memory-accounting block of :meth:`fleet_status`:
        THIS store's device-plane estimate (host arithmetic off the
        resident mirror — never a device sync) + encode-cache bytes,
        alongside the process-level journal/park gauges and the
        device-plane peak watermark. The serving layer overlays its
        residency totals (resident bytes, budget, pressure) on top."""
        from ..device.general import mirror_bytes
        store = self.store
        mir = getattr(getattr(store, 'pool', None), 'mirror', None)
        counters = _metrics.counters
        return {
            'device_plane_bytes': mirror_bytes(mir),
            'device_plane_fmt': mir.get('fmt') if mir else None,
            'device_plane_peak_bytes':
                counters.get('mem_device_plane_peak_bytes', 0),
            'wire_cache_bytes': getattr(store, '_wire_cache_bytes',
                                        0),
            # tiered doc storage: resident bytes of the per-doc
            # horizon state snapshots (the fold target history
            # compaction shrinks everything else into)
            'state_snapshot_bytes': store.state_snapshot_bytes()
            if hasattr(store, 'state_snapshot_bytes') else 0,
            'compacted_docs': len(getattr(store, 'horizon', ())),
            'journal_bytes': counters.get('mem_journal_bytes', 0),
            'park_shard_bytes': counters.get('mem_park_shard_bytes',
                                             0)}

    def _convergence_summary(self):
        """The replication-convergence block of :meth:`fleet_status`:
        per-link lag rolled up (worst link binds the fleet), pending
        convergence births, and the sticky divergence records."""
        lag, lagging = self._link_lag()
        return {'replication_lag_ops': lag,
                'lagging_docs': lagging,
                'pending_births': len(self._births),
                'parked_births': len(self._parked_births),
                'convergence_ms_p99':
                    _metrics.quantile('sync_convergence_ms', 0.99),
                'diverged': {d: dict(rec)
                             for d, rec in self.diverged.items()}}

    # -- health / SLO rollup -------------------------------------------------

    def _health_signals(self):
        """The current-state signal set the thresholds grade. Every
        entry is a live value (gauges refresh per heartbeat; counts
        are current registry sizes; ``retry_exhausted`` is the delta
        since the previous evaluation), so the rollup recovers as
        pressure lifts. O(connections) — never O(fleet), so the
        serving tick can evaluate every quantum."""
        debt = 0
        backpressure = 0
        exhausted = 0
        counters = _metrics.counters
        # live per-connection reads, O(connections)
        for conn in self.connections.values():
            for ctrl in (conn.admission, conn.shared_admission):
                if ctrl is None:
                    continue
                for bucket in (ctrl.change_bucket, ctrl.byte_bucket):
                    if bucket is not None:
                        debt = max(debt, -min(0, bucket.tokens))
            backpressure += conn.backpressure_depth
            # THIS doc set's links only (the peer-scoped slices, like
            # _link_lag) — the process-wide counter would bleed another
            # co-resident fleet's exhaustions into this one's health
            exhausted += counters.get(
                getattr(conn.metrics, 'prefix', '') +
                'sync_retry_exhausted', 0)
        lag, lagging = self._link_lag()
        delta = exhausted - self._health_last_exhausted
        self._health_last_exhausted = exhausted
        # recompile-storm: jit retraces since the last evaluation
        # (the shape-signature registry is process-wide; the first
        # evaluation records the baseline and reports 0)
        retraces = counters.get('device_retraces_total', 0)
        last = self._health_last_retraces
        self._health_last_retraces = retraces
        storm = retraces - last if last is not None else 0
        signals = {'replication_lag_ops': lag,
                   'lagging_docs': lagging,
                   'convergence_ms_p99':
                       _metrics.quantile('sync_convergence_ms', 0.99),
                   'quarantined': len(self.quarantined),
                   'diverged': len(self.diverged),
                   'retry_exhausted': max(0, delta),
                   'admission_debt': debt,
                   'backpressure_depth': backpressure,
                   'recompile_storm': max(0, storm),
                   # registered links whose peer the failure detector
                   # declared dead RIGHT NOW — a live count, so a
                   # healed peer clears the signal
                   'membership': sum(
                       1 for c in self.connections.values()
                       if getattr(c, 'link_state', 'up') == 'down'),
                   'parked': 0}
        if self.health_extra is not None:
            signals.update(self.health_extra())
        return signals

    def evaluate_health(self):
        """Compute the green/degraded/critical rollup from the
        configurable :attr:`health_thresholds`, record the state
        transition (a ``health_transition`` event + the
        ``fleet_health_state``/``fleet_health_transitions`` metrics)
        and fire the :attr:`health_incident` hook — the serving layer
        dumps a flight-recorder incident on first entry to critical.
        Called by :meth:`fleet_status` and by the serving tick."""
        signals = self._health_signals()
        state = 'green'
        reasons = []
        for name, value in signals.items():
            bounds = self.health_thresholds.get(name)
            if not bounds or value is None:
                continue
            degraded_at, critical_at = bounds
            if critical_at is not None and value >= critical_at:
                level = 'critical'
            elif degraded_at is not None and value >= degraded_at:
                level = 'degraded'
            else:
                continue
            reasons.append(f'{name}={value:g} >= {level} threshold')
            if _HEALTH_RANK[level] > _HEALTH_RANK[state]:
                state = level
        previous = self._health_state
        if state != previous:
            self._health_state = state
            _metrics.bump('fleet_health_transitions')
            _metrics.set_gauge('fleet_health_state',
                               _HEALTH_RANK[state])
            if _metrics.active:
                _metrics.emit('health_transition', previous=previous,
                              state=state, reasons=reasons)
            if self.health_incident is not None:
                self.health_incident(previous, state, signals,
                                     reasons)
        return {'state': state, 'reasons': reasons,
                'signals': signals,
                'thresholds': dict(self.health_thresholds)}

    evaluateHealth = evaluate_health

    def health(self):
        """The health rollup alone (one evaluation)."""
        return self.evaluate_health()

    def _connection_statuses(self):
        """Per-connection operator rows, the counter slices pre-
        bucketed by each link's scope prefix in one registry pass."""
        conns = self.connections
        if not conns:
            return {}
        prefixes = {pid: getattr(conn.metrics, 'prefix', '')
                    for pid, conn in conns.items()}
        buckets = _metrics.groups({p for p in prefixes.values() if p})
        return {pid: conn.connection_status(
                    scoped=buckets[prefixes[pid]]
                    if prefixes[pid] else None)
                for pid, conn in conns.items()}

    fleetStatus = fleet_status

    def apply_wire(self, data, doc_ids=None):
        """Batched admission straight from WIRE BYTES: either the JSON
        text of per-document change lists (``[[change, ...], ...]``,
        native codec with key kinds resolved against this store's
        object table) or a columnar v2/v3 container (``AMW2``/``AMW3``
        magic — varint op columns + shared literal tables, v3 with RLE
        action/obj columns, parsed with ZERO JSON anywhere), then the
        native stager inside one fused apply
        — no per-op Python on the whole path. ``doc_ids`` names the
        documents the arrays correspond to (defaults to positional
        ``doc-<i>`` ids, created on first touch). Falls back to the
        pure-Python edges when the codec library is unavailable.

        Returns the list of touched :class:`GeneralDocHandle`."""
        from ..wire import (COLUMNAR_MAGIC, COLUMNAR_MAGIC_V3,
                            parse_columnar_block, parse_general_block)
        from ..device.blocks import ChangeBlock
        t0 = _time.perf_counter()
        head = bytes(data[:4]) \
            if isinstance(data, (bytes, bytearray, memoryview)) else b''
        columnar = head in (COLUMNAR_MAGIC, COLUMNAR_MAGIC_V3)
        with _metrics.trace_span(
                'wire.parse', n_bytes=len(data),
                v=3 if head == COLUMNAR_MAGIC_V3
                else 2 if columnar else 1):
            if columnar:
                block = parse_columnar_block(data)
            else:
                block = parse_general_block(data, store=self.store)
            _metrics.observe('sync_wire_parse_ms',
                             (_time.perf_counter() - t0) * 1e3)
        n = block.n_docs
        if doc_ids is None:
            doc_ids = [f'doc-{i}' for i in range(n)]
        elif len(doc_ids) != n:
            raise ValueError(
                f'wire block carries {n} documents, got '
                f'{len(doc_ids)} doc ids')
        for doc_id in doc_ids:
            self._index(doc_id, create=True)
        # widen the block's doc axis to the store capacity (documents
        # map positionally: doc_ids[i] -> store index of that id)
        idx_of = [self.id_of[doc_id] for doc_id in doc_ids]
        if idx_of != list(range(n)) or n != self.capacity:
            remap = np.asarray(idx_of, np.int32)
            block = ChangeBlock(
                self.capacity,
                remap[block.doc] if block.n_changes else block.doc,
                block.actor, block.seq, block.dep_ptr, block.dep_actor,
                block.dep_seq, block.op_ptr, block.action, block.key,
                block.value, block.actors, block.keys, block.values,
                dup_keys=block._dup_keys, obj=block.obj,
                key_kind=block.key_kind, key_elem=block.key_elem,
                elem=block.elem, objs=block.objs)
        with _metrics.trace_span('doc_set.apply_wire',
                                 docs=len(doc_ids)):
            self.last_patch = _general.apply_general_block(
                self.store, block, options=self._options)
        _metrics.observe('sync_apply_ms',
                         (_time.perf_counter() - t0) * 1e3)
        self._note_births(doc_ids)
        out = []
        for doc_id in doc_ids:
            doc = self.get_doc(doc_id)
            out.append(doc)
            for handler in list(self.handlers):
                handler(doc_id, doc)
        return out

    applyWire = apply_wire

    def register_connection(self, peer_id, conn):
        """Adopt a peer-identified :class:`~.resilient.
        ResilientConnection` into the operator surface:
        :meth:`fleet_status` reports its live backpressure/admission/
        retransmit state per CONNECTION (the link registers itself
        when constructed with ``peer_id=``)."""
        self.connections[peer_id] = conn

    registerConnection = register_connection

    def unregister_connection(self, peer_id, conn):
        if self.connections.get(peer_id) is conn:
            del self.connections[peer_id]
            if not self.connections:
                # no peers left to ack anything: pending convergence
                # births can never close — drop them instead of
                # reporting a forever-growing pending_births figure
                self._births.clear()
                self._parked_births.clear()

    unregisterConnection = unregister_connection

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers = self.handlers + [handler]

    registerHandler = register_handler

    def unregister_handler(self, handler):
        self.handlers = [h for h in self.handlers if h != handler]

    unregisterHandler = unregister_handler

    # -- packed snapshot -----------------------------------------------------

    _SNAP_FORMAT = 'automerge-tpu-general-docset-snapshot@1'

    def save_snapshot(self):
        """The WHOLE document set as one packed artifact: the store's
        columnar snapshot plus the doc-id mapping. A 10k-doc fleet
        resumes replay-free (bytes in, working DocSet out)."""
        import json
        import struct
        store_bytes = self.store.save_snapshot()
        header = json.dumps({'format': self._SNAP_FORMAT,
                             'capacity': self.capacity,
                             'auto_grow': self.auto_grow,
                             'ids': self.ids}).encode()
        return struct.pack('>Q', len(header)) + header + store_bytes

    @classmethod
    def load_snapshot(cls, data, options=None, device=None):
        """Resume a doc set from :meth:`save_snapshot` bytes (this
        package's or the JAX package's) on ``device``."""
        import json
        import struct
        from ..snapshot import SnapshotCorruptError
        if len(data) < 8:
            raise SnapshotCorruptError(
                f'general-docset snapshot truncated: {len(data)} '
                f'bytes, header-length prefix needs 8')
        (hlen,) = struct.unpack('>Q', data[:8])
        if 8 + hlen > len(data):
            raise SnapshotCorruptError(
                f'general-docset snapshot truncated: header claims '
                f'{hlen} bytes, {len(data) - 8} available')
        try:
            header = json.loads(data[8:8 + hlen].decode())
        except (ValueError, UnicodeDecodeError) as err:
            raise SnapshotCorruptError(
                f'general-docset snapshot header is not valid JSON '
                f'({err})') from None
        if not isinstance(header, dict) or \
                header.get('format') != cls._SNAP_FORMAT:
            raise SnapshotCorruptError('not a general-docset snapshot')
        for field in ('capacity', 'ids'):
            if field not in header:
                raise SnapshotCorruptError(
                    f"general-docset snapshot: missing field "
                    f"'{field}'")
        try:
            out = cls(header['capacity'], options=options,
                      auto_grow=header.get('auto_grow', True),
                      device=device)
            out.store = _general.GeneralStore.load_snapshot(
                data[8 + hlen:], device=out.device)
            out.ids = list(header['ids'])
            out.id_of = {doc_id: i
                         for i, doc_id in enumerate(out.ids)}
        except SnapshotCorruptError:
            raise
        except Exception as err:
            raise SnapshotCorruptError(
                f'general-docset snapshot: payload failed to '
                f'reconstruct ({type(err).__name__}: {err})') from err
        return out

    # -- materialization -----------------------------------------------------

    def _doc_entry_rows(self, idx):
        """Entry rows of one document — CSR index over e_doc, cached
        per entry-table version (the columns are replaced, never
        mutated, so the array identity is the version)."""
        store = self.store
        ref, order, starts = self._entry_csr
        if ref is not store.e_doc or len(starts) != self.capacity + 1:
            order = np.argsort(store.e_doc, kind='stable')
            starts = np.searchsorted(store.e_doc[order],
                                     np.arange(self.capacity + 1))
            self._entry_csr = (store.e_doc, order, starts)
        return order[starts[idx]:starts[idx + 1]]

    def _winner_view(self, rows):
        """Winner index over entry rows ``rows`` (ascending original
        positions; None = every entry): ``(fields, w_value, w_link,
        plain)`` — the sorted distinct packed field keys, the winners'
        value-table ids and link flags, and the winners' BULK-DECODED
        plain values (None where the winner is a link or valueless).
        One vectorized field-sort + segment-argmax
        (:func:`~..device.general_backend.winner_select`, native when
        available) replaces the per-map ``by_field`` dict scans."""
        store = self.store
        cache = getattr(store, '_e_field_cache', None)
        if cache is not None and cache[0] is store.e_obj:
            e_field = cache[1]
        else:
            e_field = (store.e_obj.astype(np.int64) << 32) | store.e_key
            store._e_field_cache = (store.e_obj, e_field)
        ranks = store.actor_str_ranks()
        if rows is None:
            field = e_field
            rank = ranks[store.e_actor] if len(e_field) \
                else np.zeros(0, np.int64)
        else:
            field = e_field[rows]
            rank = ranks[store.e_actor[rows]]
        from ..device.general_backend import winner_select
        from ..device import profiler as _profiler
        # size-class registry for the vectorized winner select —
        # host-side (jit=False): a new entry-count bucket is tracked
        # per fn but never counted as an XLA compile or retrace
        _profiler.note_dispatch(
            'view.winner_select',
            (_profiler.shape_bucket(len(field)),), rows=len(field),
            jit=False)
        fields, wpos = winner_select(field, rank)
        w_rows = wpos if rows is None else rows[wpos]
        w_value = store.e_value[w_rows]
        w_link = store.e_link[w_rows]
        plain = store.values.take(np.where(w_link, -1, w_value))
        return fields, w_value, w_link, plain

    def materialize(self, doc_id):
        """The nested JSON view of one document (winners only): maps as
        dicts, lists as Python lists, text as str, links resolved
        recursively. Served from the dirty-doc view cache when the doc
        is clean; on a miss this is the single-doc fallback of the
        batched read path — the same winner index, assembled
        recursively (objects rebuilt per path, cycles cut with a
        mutable path set)."""
        idx = self.id_of.get(doc_id)
        if idx is None:
            raise KeyError(doc_id)
        store = self.store
        store._commit_pending()
        store.pool.sync()
        ver = store.doc_version(idx)
        hit = self._views.get(idx)
        if hit is not None and hit[0] == ver:
            return hit[1]
        tree = self._build_single(idx)
        self._views[idx] = (ver, tree)
        self._view_ver[idx] = ver
        return tree

    def _build_single(self, idx):
        """Recursive single-doc assembly over the winner index (the
        per-doc fallback the parity suite checks the batched path
        against)."""
        from ..device.general_backend import visible_seq_rows
        store = self.store
        root = int(store._root_row[idx])
        if root < 0:
            return {}
        fields, w_value, w_link, plain = self._winner_view(
            self._doc_entry_rows(idx))
        pool = store.pool
        get_obj = store.obj_of.get

        def value_at(fi, path):
            if w_link[fi]:
                row = get_obj((idx, store.values[int(w_value[fi])]))
                return build(row, path) if row is not None else None
            return plain[fi]

        def build(obj_row, path):
            if obj_row in path:
                return None            # defensive: cyclic links
            path.add(obj_row)
            try:
                t = store.obj_type[obj_row]
                base = np.int64(obj_row) << 32
                if t == _TYPE_MAP:
                    lo = np.searchsorted(fields, base)
                    hi = np.searchsorted(fields, base | _ELEM_BIT)
                    return {store.keys[int(fields[j]) & 0x7FFFFFFF]:
                            value_at(j, path) for j in range(lo, hi)}
                # sequence: visible elements in document order
                vrows = visible_seq_rows(store, obj_row)
                q = base | _ELEM_BIT | pool.local[vrows].astype(np.int64)
                pos = np.minimum(np.searchsorted(fields, q),
                                 max(len(fields) - 1, 0))
                hit = (fields[pos] == q) if len(fields) \
                    else np.zeros(len(q), bool)
                items = [value_at(int(pos[i]), path) if hit[i] else None
                         for i in range(len(q))]
                if t == _TYPE_TEXT:
                    return ''.join(str(v) for v in items)
                return items
            finally:
                path.discard(obj_row)

        return build(root, set())

    def materialize_many(self, doc_ids):
        """Materialize several documents at once: clean docs come
        straight from the view cache; all dirty docs rebuild in ONE
        vectorized pass over the entry columns (:meth:`_build_batch`).
        Returns trees aligned with ``doc_ids``. Views are shared with
        the cache — treat them as immutable. Whole-fleet readers
        should drain pending async applies first
        (:func:`~..device.general.drain_general`)."""
        store = self.store
        idxs = []
        for doc_id in doc_ids:
            idx = self.id_of.get(doc_id)
            if idx is None:
                raise KeyError(doc_id)
            idxs.append(idx)
        store._commit_pending()
        store.pool.sync()
        dirty = []
        for i in set(idxs):
            hit = self._views.get(i)
            if hit is None or hit[0] != store.doc_version(i):
                dirty.append(i)
        if dirty:
            # version snapshot BEFORE the build: an apply landing
            # mid-build re-dirties these docs rather than being masked
            dirty_vers = {i: store.doc_version(i) for i in dirty}
            with _metrics.trace_span('doc_set.materialize',
                                     dirty=len(dirty)):
                for i, tree in self._build_batch(dirty).items():
                    self._views[i] = (dirty_vers[i], tree)
                    self._view_ver[i] = dirty_vers[i]
        return [self._views[i][1] for i in idxs]

    def materialize_all(self):
        """``{doc_id: tree}`` for the whole fleet — the batched k-doc
        read path (ROADMAP "Batched materialization")."""
        return dict(zip(self.ids,
                        self.materialize_many(list(self.ids))))

    def _build_batch(self, idxs):
        """Vectorized materialization of doc indexes ``idxs``: one
        winner-select over their entry rows, one visible-element walk
        over ALL their sequence objects, values decoded in bulk, then
        a single fill pass that builds every object exactly once
        (links resolved by reference, cycles cut, text joined last).
        Returns ``{idx: tree}``."""
        from ..device.general_backend import visible_walk
        store = self.store
        idx_arr = np.asarray(sorted(idxs), np.int64)
        # entry rows of the requested docs: one O(entries) mask pass
        # unless the request covers the whole fleet
        if len(idx_arr) >= len(self.ids):
            rows = None
        else:
            want = np.zeros(store.n_docs, bool)
            want[idx_arr] = True
            rows = np.flatnonzero(want[store.e_doc])
        fields, w_value, w_link, plain = self._winner_view(rows)

        # containers for every object of the requested docs, built
        # exactly once (reachability is implicit: unlinked objects are
        # simply never referenced)
        obj_doc_arr, obj_type_arr = store.obj_arrays()
        if len(obj_doc_arr):
            want_d = np.zeros(store.n_docs, bool)
            want_d[idx_arr] = True
            objs_sel = np.flatnonzero(want_d[obj_doc_arr])
        else:
            objs_sel = np.zeros(0, np.int64)
        cont = {}
        for orow in objs_sel.tolist():
            cont[orow] = {} if obj_type_arr[orow] == _TYPE_MAP else []

        # link winners resolve to child object rows (rare: one dict
        # lookup per link field)
        f_obj = (fields >> 32).astype(np.int64)
        child_of = np.full(len(fields), -1, np.int64)
        link_fi = np.flatnonzero(w_link)
        if len(link_fi):
            link_uuids = store.values.take(w_value[link_fi])
            get_obj = store.obj_of.get
            for k, fi in enumerate(link_fi.tolist()):
                r = get_obj((int(obj_doc_arr[f_obj[fi]]),
                             link_uuids[k]))
                if r is not None:
                    child_of[fi] = r

        # out_links: parent obj row -> [(container, slot, child row)]
        # — the link-edge record the cycle cut and text join walk
        out_links = {}

        def place_link(orow, container, slot, fi):
            ch = int(child_of[fi])
            child = cont.get(ch) if ch >= 0 else None
            container[slot] = child
            if child is not None:
                out_links.setdefault(orow, []).append(
                    (container, slot, ch))

        # map fields (elem bit clear, parent is a map)
        if len(fields):
            is_map_f = ~((fields & _ELEM_BIT) != 0)
            is_map_f &= obj_type_arr[f_obj] == _TYPE_MAP
            keys_tab = store.keys
            for fi in np.flatnonzero(is_map_f).tolist():
                d = cont.get(int(f_obj[fi]))
                if d is None:
                    continue           # object of an unrequested doc
                key = keys_tab[int(fields[fi]) & 0x7FFFFFFF]
                if w_link[fi]:
                    place_link(int(f_obj[fi]), d, key, fi)
                else:
                    d[key] = plain[fi]

        # sequences: ONE visible-element sweep over every list/text
        # object of the requested docs, then one searchsorted resolves
        # each element's winner field
        if len(objs_sel):
            seq_objs = objs_sel[obj_type_arr[objs_sel] != _TYPE_MAP] \
                .astype(np.int64)
        else:
            seq_objs = objs_sel
        from ..device import profiler as _profiler
        _profiler.note_dispatch(
            'view.visible_walk',
            (_profiler.shape_bucket(len(seq_objs)),),
            rows=len(seq_objs), jit=False)
        seg, local, counts = visible_walk(store.pool, seq_objs)
        starts = np.zeros(len(seq_objs) + 1, np.int64)
        if len(seq_objs):
            np.cumsum(counts, out=starts[1:])
        if len(seg):
            q = (seq_objs[seg] << 32) | _ELEM_BIT | local
            pos = np.minimum(np.searchsorted(fields, q),
                             max(len(fields) - 1, 0))
            hit = (fields[pos] == q) if len(fields) \
                else np.zeros(len(q), bool)
            # bulk element values (plain decodes; a link's plain is
            # None, fixed up below), one list comp + extend per object
            item_vals = [plain[p] if h else None
                         for p, h in zip(pos.tolist(), hit.tolist())]
            starts_l = starts.tolist()
            for k, orow in enumerate(seq_objs.tolist()):
                cont[orow].extend(
                    item_vals[starts_l[k]:starts_l[k + 1]])
            for i in np.flatnonzero(hit & w_link[pos]).tolist():
                k = int(seg[i])
                orow = int(seq_objs[k])
                place_link(orow, cont[orow],
                           int(i - starts[k]), int(pos[i]))

        # cycle cut: DFS from each root over the link edges; a link to
        # an object on the current path nulls out (the batched reading
        # of the per-doc path's frozenset guard). O(links). Known
        # divergence from the per-doc fallback: objects build ONCE
        # here, so on a CYCLIC graph reachable via several paths the
        # cut lands relative to the first discovery path, while the
        # per-doc path re-unrolls the cycle per access path. Acyclic
        # documents (anything the reference frontend can produce,
        # including DAG-shared links) are value-identical on both
        # paths.
        state = {}
        for idx in idx_arr.tolist():
            root = int(store._root_row[idx])
            if root < 0:
                continue
            stack = [(root, iter(out_links.get(root, ())))]
            state[root] = 1
            while stack:
                row, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    state[row] = 2
                    stack.pop()
                    continue
                container, slot, child = nxt
                st_c = state.get(child, 0)
                if st_c == 1:
                    container[slot] = None
                elif st_c == 0:
                    state[child] = 1
                    stack.append(
                        (child, iter(out_links.get(child, ()))))

        # text joins LAST (after the cut, so a cut link stays None):
        # every un-cut reference to a text object is replaced by its
        # joined string, INNER-FIRST over the link graph — a text (or
        # a container inside one) linking to another text embeds the
        # joined string, never the raw element list. The cut pass
        # broke every reachable cycle; `joining` guards unreachable
        # text cycles.
        if len(objs_sel):
            text_rows = objs_sel[obj_type_arr[objs_sel] == _TYPE_TEXT]
            if len(text_rows):
                tset = set(text_rows.tolist())
                joined = {}
                joining = set()
                resolved = set()

                def resolve(obj):
                    """Replace text-link slots in obj's subtree."""
                    if obj in resolved:
                        return
                    resolved.add(obj)
                    for container, slot, child in \
                            out_links.get(obj, ()):
                        if child in tset:
                            if container[slot] is cont[child]:
                                container[slot] = join(child)
                        else:
                            resolve(child)

                def join(r):
                    s = joined.get(r)
                    if s is None:
                        if r in joining:
                            return None    # unreachable text cycle
                        joining.add(r)
                        resolve(r)
                        joining.discard(r)
                        s = joined[r] = ''.join(str(v)
                                                for v in cont[r])
                    return s

                for obj in list(out_links):
                    resolve(obj)

        out = {}
        for idx in idx_arr.tolist():
            root = int(store._root_row[idx])
            out[idx] = cont[root] if root >= 0 else {}
        return out
