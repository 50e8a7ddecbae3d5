"""Connection: per-peer replication protocol, multiplexing many documents.

Parity with the reference's ``src/connection.js``. The protocol is
network-agnostic: construct with a DocSet and a ``send_msg`` callback;
call :meth:`receive_msg` when the network delivers a message. Messages are
``{docId, clock}`` (advertisement/ack/request) or ``{docId, clock, changes}``
(data). ``their_clock`` tracks what we believe the peer has; ``our_clock``
what we've advertised.

On a TPU pod the same logical protocol runs between hosts over DCN, while
replicas sharing a mesh sync by collective instead of message
(:mod:`automerge_tpu_torch.parallel`).

The PyTorch port's copy of ``automerge_tpu/sync/connection.py``: the
same protocol and wire formats; a served snapshot resumes on the doc
set's device.
"""

import time

from .. import frontend as Frontend
from ..common import less_or_equal
from ..utils.metrics import metrics
from .doc_set import backend_of as _backend_of


# wire-v3 session warm-up from 'state' bootstraps (ISSUE 20): a peer
# bootstrapping from a state snapshot pre-seeds its session string
# table with the snapshot's actor/key literals, so its first warm
# flush ships bare refs instead of redefining strings the serving
# peer demonstrably holds. Module-level so the bench can A/B the
# definition-byte savings; correctness never depends on it (a missed
# warm-up just means normal define-on-first-use).
SESSION_WARMUP = True


class MessageRejected(ValueError):
    """An incoming sync message failed envelope/schema validation.

    Raised by :meth:`Connection.receive_msg` BEFORE any state mutation
    — a rejected message never pollutes ``_their_clock`` or reaches an
    apply path. Counted under ``sync_msgs_rejected``; the message names
    the offending field so a hostile or buggy peer is diagnosable from
    the log line alone."""


def _reject(reason):
    metrics.bump('sync_msgs_rejected')
    raise MessageRejected(reason)


def validate_msg(msg):
    """Validate the logical sync-message schema (advertisement, ack,
    request, data or snapshot): ``docId`` a string, ``clock`` a dict of
    ``str -> non-negative int`` seqs, ``changes`` (when present) a list
    of change dicts each carrying ``actor``/``seq``/``deps``/``ops``
    with sane types. Raises :class:`MessageRejected` (and bumps
    ``sync_msgs_rejected``) on the first violation; returns ``msg``."""
    if not isinstance(msg, dict):
        _reject(f'message is {type(msg).__name__}, not a dict')
    doc_id = msg.get('docId')
    if not isinstance(doc_id, str):
        _reject(f'docId is missing or not a string: {doc_id!r}')
    clock = msg.get('clock')
    if clock is not None:
        if not isinstance(clock, dict):
            _reject(f'clock is not a dict: {type(clock).__name__}')
        for actor, seq in clock.items():
            if not isinstance(actor, str):
                _reject(f'clock actor is not a string: {actor!r}')
            if not isinstance(seq, int) or isinstance(seq, bool) \
                    or seq < 0:
                _reject(f'clock seq for {actor!r} is not a '
                        f'non-negative int: {seq!r}')
    changes = msg.get('changes')
    if changes is not None:
        if not isinstance(changes, (list, tuple)):
            _reject(f'changes is not a list: '
                    f'{type(changes).__name__}')
        for change in changes:
            if not isinstance(change, dict):
                _reject(f'change is not a dict: '
                        f'{type(change).__name__}')
            if not isinstance(change.get('actor'), str):
                _reject(f'change actor is missing or not a string: '
                        f'{change.get("actor")!r}')
            seq = change.get('seq')
            if not isinstance(seq, int) or isinstance(seq, bool) \
                    or seq <= 0:
                _reject(f'change seq is not a positive int: {seq!r}')
            deps = change.get('deps')
            if not isinstance(deps, dict):
                _reject(f'change deps is missing or not a dict: '
                        f'{deps!r}')
            for actor, dseq in deps.items():
                if not isinstance(actor, str) or \
                        not isinstance(dseq, int) or \
                        isinstance(dseq, bool) or dseq < 0:
                    _reject(f'change dep {actor!r}: {dseq!r} is not '
                            f'str -> non-negative int')
            ops = change.get('ops')
            if not isinstance(ops, (list, tuple)) or \
                    not all(isinstance(op, dict) for op in ops):
                _reject('change ops is not a list of dicts')
    snapshot = msg.get('snapshot')
    if snapshot is not None and not isinstance(snapshot, (str, bytes)):
        _reject(f'snapshot payload is not str/bytes: '
                f'{type(snapshot).__name__}')
    state = msg.get('state')
    if state is not None and \
            not isinstance(state, (bytes, bytearray)):
        _reject(f'state payload is not bytes: '
                f'{type(state).__name__}')
    return msg


def validate_state_msg(msg):
    """Validate the multi-doc STATE bootstrap message (tiered doc
    storage): ``state`` the format version (1); ``docs`` a non-empty
    list of doc-id strings; ``clocks`` the aligned HORIZON clocks;
    ``lens`` the aligned per-doc payload byte lengths (one state
    snapshot per doc); ``blob`` their concatenation. Payload CONTENT
    is covered by the envelope CRC and its own checksummed container;
    a corrupt payload quarantines only its doc at absorb time."""
    if not isinstance(msg, dict):
        _reject(f'state message is {type(msg).__name__}, not a dict')
    if msg.get('state') != 1 or isinstance(msg.get('state'), bool):
        _reject(f"state version is not 1: {msg.get('state')!r}")
    docs = msg.get('docs')
    if not isinstance(docs, (list, tuple)) or not docs:
        _reject(f'state docs is not a non-empty list: {docs!r}')
    for doc_id in docs:
        if not isinstance(doc_id, str):
            _reject(f'state doc id is not a string: {doc_id!r}')
    clocks = msg.get('clocks')
    if not isinstance(clocks, (list, tuple)) or \
            len(clocks) != len(docs):
        _reject('state clocks is not a list aligned with docs')
    for clock in clocks:
        if not isinstance(clock, dict):
            _reject(f'state clock is not a dict: '
                    f'{type(clock).__name__}')
        for actor, seq in clock.items():
            if not isinstance(actor, str) or not isinstance(seq, int) \
                    or isinstance(seq, bool) or seq < 0:
                _reject(f'state clock entry {actor!r}: {seq!r} is '
                        f'not str -> non-negative int')
    lens = msg.get('lens')
    if not isinstance(lens, (list, tuple)) or len(lens) != len(docs):
        _reject('state lens is not a list aligned with docs')
    total = 0
    for ln in lens:
        if not isinstance(ln, int) or isinstance(ln, bool) or ln <= 0:
            _reject(f'state payload length is not a positive int: '
                    f'{ln!r}')
        total += ln
    blob = msg.get('blob')
    if not isinstance(blob, (bytes, bytearray)):
        _reject(f'state blob is not bytes: {type(blob).__name__}')
    if len(blob) != total:
        _reject(f'state blob carries {len(blob)} bytes, lens claim '
                f'{total}')
    return msg


def validate_wire_msg(msg):
    """Validate the multi-doc WIRE data-message schema (the columnar
    counterpart of a per-doc ``{docId, clock, changes}`` dict message):
    ``wire`` the format version (1 = JSON-blob spans, 2 = columnar
    binary spans + a shared ``tab`` literal table, 3 = RLE columnar
    spans referencing a SESSION string table — ``tab`` carries the
    message's new table definitions and ``sid`` the sender's table
    epoch); ``docs`` a
    non-empty list of doc-id strings; ``clocks`` an aligned list of
    ``str -> non-negative int`` clock dicts; ``counts`` an aligned
    list of per-doc change counts; ``lens`` the per-change byte
    lengths (``sum(counts)`` of them); ``blob`` the concatenated change
    encodings (``sum(lens)`` bytes); ``maxv`` (optional) the sender's
    highest spoken format version — the negotiation stamp. Change
    CONTENT is not inspected here — blob and tab ride under a CRC32
    envelope checksum (:func:`~automerge_tpu_torch.sync.resilient.
    payload_checksum`) and parse at flush, where a poisoned document
    lands in quarantine. Raises :class:`MessageRejected` on the first
    violation; returns ``msg``."""
    if not isinstance(msg, dict):
        _reject(f'wire message is {type(msg).__name__}, not a dict')
    version = msg.get('wire')
    if version not in (1, 2, 3) or isinstance(version, bool):
        _reject(f'wire version is not 1, 2 or 3: {version!r}')
    maxv = msg.get('maxv')
    if maxv is not None and (not isinstance(maxv, int)
                             or isinstance(maxv, bool) or maxv < 1):
        _reject(f'wire maxv is not a positive int: {maxv!r}')
    if version >= 2:
        tab = msg.get('tab')
        if not isinstance(tab, (bytes, bytearray)):
            _reject(f'wire v{version} tab is not bytes: '
                    f'{type(tab).__name__}')
    if version >= 3:
        sid = msg.get('sid')
        if not isinstance(sid, int) or isinstance(sid, bool) or sid < 0:
            _reject(f'wire v3 sid is not a non-negative int: {sid!r}')
    docs = msg.get('docs')
    if not isinstance(docs, (list, tuple)) or not docs:
        _reject(f'wire docs is not a non-empty list: {docs!r}')
    for doc_id in docs:
        if not isinstance(doc_id, str):
            _reject(f'wire doc id is not a string: {doc_id!r}')
    clocks = msg.get('clocks')
    if not isinstance(clocks, (list, tuple)) or \
            len(clocks) != len(docs):
        _reject(f'wire clocks is not a list aligned with docs: '
                f'{type(clocks).__name__}')
    for clock in clocks:
        if not isinstance(clock, dict):
            _reject(f'wire clock is not a dict: '
                    f'{type(clock).__name__}')
        for actor, seq in clock.items():
            if not isinstance(actor, str) or not isinstance(seq, int) \
                    or isinstance(seq, bool) or seq < 0:
                _reject(f'wire clock entry {actor!r}: {seq!r} is not '
                        f'str -> non-negative int')
    counts = msg.get('counts')
    if not isinstance(counts, (list, tuple)) or \
            len(counts) != len(docs):
        _reject(f'wire counts is not a list aligned with docs: '
                f'{type(counts).__name__}')
    for count in counts:
        if not isinstance(count, int) or isinstance(count, bool) \
                or count < 0:
            _reject(f'wire change count is not a non-negative int: '
                    f'{count!r}')
    lens = msg.get('lens')
    if not isinstance(lens, (list, tuple)) or \
            len(lens) != sum(counts):
        _reject(f'wire lens does not carry sum(counts)='
                f'{sum(counts)} entries: {lens!r}')
    total = 0
    for ln in lens:
        # zero-length spans can never hold a change encoding — reject
        # them here so a bogus message cannot quarantine a healthy doc
        # at flush (the dict path rejects malformed changes pre-state
        # too)
        if not isinstance(ln, int) or isinstance(ln, bool) or ln <= 0:
            _reject(f'wire change length is not a positive int: '
                    f'{ln!r}')
        total += ln
    blob = msg.get('blob')
    if not isinstance(blob, (bytes, bytearray)):
        _reject(f'wire blob is not bytes: {type(blob).__name__}')
    if len(blob) != total:
        _reject(f'wire blob carries {len(blob)} bytes, lens claim '
                f'{total}')
    return msg


# highest state-bootstrap message version this build speaks (tiered
# doc storage): a peer advertises its own via `maxs` on every wire/
# state message, and 'state' payloads only ship to peers that did —
# un-advertised (old) peers fall back to the legacy snapshot path
STATE_VERSION = 1

# highest wire-blob format this build speaks: 3 = RLE columnar spans +
# session-scoped string tables (actor uuids / hot keys ship once per
# connection); 2 = columnar binary spans + per-message literal tables
# (JSON-free receive path); 1 = the PR 5 JSON-blob spans, kept for
# mixed-fleet interop. Lower versions stay pinnable via
# WireConnection(wire_version=...) and negotiation takes the min of
# both ends' maxv stamps.
WIRE_VERSION = 3

# the flow-control sizing unit for served encode-cache entries — the
# ONE sizing rule, shared with the cache-byte accounting in
# device/blocks.py so the two can never drift
from ..device.blocks import _wire_entry_bytes as _entry_bytes  # noqa: E402,E501


def clock_union(clock_map, doc_id, clock):
    """Merge `clock` into `clock_map[doc_id]`, taking per-actor maxima
    (connection.js:9-12). The reference rebuilds an immutable map; these
    maps are private to one Connection, so updating in place is
    observably identical and keeps a 10k-doc sync O(messages), not
    O(messages * docs)."""
    merged = clock_map.get(doc_id)
    if merged is None:
        merged = clock_map[doc_id] = {}
    for actor, seq in clock.items():
        if seq > merged.get(actor, 0):
            merged[actor] = seq
    return clock_map


class Connection:
    def __init__(self, doc_set, send_msg):
        self._doc_set = doc_set
        self._send_msg = send_msg
        self._their_clock = {}
        self._our_clock = {}
        # per-connection metrics routing: defaults to the process-wide
        # registry; ResilientConnection swaps in a peer-labeled scope
        # (metrics.scoped(peer=...)) so this connection's counters land
        # BOTH process-wide and under peer/<id>/ — the per-connection
        # surface fleet_status() reports
        self.metrics = metrics

    def open(self):
        for doc_id in self._doc_set.doc_ids:
            self.doc_changed(doc_id, self._doc_set.get_doc(doc_id))
        self._doc_set.register_handler(self.doc_changed)

    def close(self):
        self._doc_set.unregister_handler(self.doc_changed)

    def send_msg(self, doc_id, clock, changes=None):
        msg = {'docId': doc_id, 'clock': dict(clock)}
        self._our_clock = clock_union(self._our_clock, doc_id, clock)
        if changes is not None:
            msg['changes'] = changes
        self.metrics.bump('sync_msgs_sent')
        if changes is not None:
            self.metrics.bump('sync_changes_sent', len(changes))
        if self.metrics.active:
            self.metrics.emit('sync_send', doc_id=doc_id,
                              changes=len(changes) if changes else 0)
        # the span is open across the transport callback so a resilient
        # shell stamps this span's id into the envelope's trace field
        # (the cross-peer correlation parent of the receiver's apply)
        with self.metrics.trace_span('sync.send', doc_id=doc_id):
            self._send_msg(msg)

    def maybe_send_changes(self, doc_id):
        """(connection.js:58-73). Extension over the reference: when the
        peer is behind a snapshot-truncated log (get_missing_changes
        raises — the change bodies it needs were dropped by a packed
        resume), the full packed snapshot ships instead, and the normal
        protocol resumes from there."""
        doc = self._doc_set.get_doc(doc_id)
        state = Frontend.get_backend_state(doc)
        clock = state.clock

        if doc_id in self._their_clock:
            try:
                changes = _backend_of(doc).get_missing_changes(
                    state, self._their_clock[doc_id])
            except ValueError as err:
                self._send_snapshot(doc_id, clock, err)
                return
            if changes:
                self._their_clock = clock_union(self._their_clock, doc_id, clock)
                self.send_msg(doc_id, clock, changes)
                return

        if clock != self._our_clock.get(doc_id, {}):
            self.send_msg(doc_id, clock)

    def _send_snapshot(self, doc_id, clock, original_err):
        """Serve a too-far-behind peer the packed state itself: a
        compacted doc's per-doc STATE snapshot when the doc set holds
        one (tiered doc storage — the peer absorbs it and the normal
        protocol serves the tail), else the per-document packed
        snapshot of device-backend documents; for everything else the
        original (clear) error propagates."""
        from .. import snapshot as _snapshot
        serve = getattr(self._doc_set, 'serve_state_payload', None)
        if serve is not None:
            got = serve(doc_id)
            if got is not None:
                payload, h_clock = got
                # assume delivery up to the horizon (the resilient
                # shell rolls this back if the envelope dies); the
                # receiver's next advert pulls the tail
                clock_union(self._their_clock, doc_id, h_clock)
                clock_union(self._our_clock, doc_id, clock)
                self.metrics.bump('sync_msgs_sent')
                self.metrics.bump('sync_state_msgs_sent')
                if self.metrics.active:
                    self.metrics.emit('sync_send', doc_id=doc_id,
                                      changes=0, state=True)
                with self.metrics.trace_span('sync.send',
                                             doc_id=doc_id,
                                             state=True):
                    self._send_msg({'docId': doc_id,
                                    'clock': dict(clock),
                                    'state': payload})
                return
        doc = self._doc_set.get_doc(doc_id)
        try:
            payload = _snapshot.save_snapshot(doc)
        except TypeError:
            raise original_err
        clock_union(self._their_clock, doc_id, clock)
        clock_union(self._our_clock, doc_id, clock)
        self.metrics.bump('sync_snapshots_sent')
        self.metrics.bump('sync_msgs_sent')
        if self.metrics.active:
            self.metrics.emit('sync_send', doc_id=doc_id, changes=0,
                              snapshot=True)
        with self.metrics.trace_span('sync.send', doc_id=doc_id,
                                     snapshot=True):
            self._send_msg({'docId': doc_id, 'clock': dict(clock),
                            'snapshot': payload})

    def doc_changed(self, doc_id, doc):
        """DocSet handler (connection.js:76-89)."""
        state = Frontend.get_backend_state(doc)
        if state is None:
            raise TypeError('This object cannot be used for network sync. '
                            'Are you trying to sync a snapshot from the history?')
        clock = state.clock
        if not less_or_equal(self._our_clock.get(doc_id, {}), clock):
            raise ValueError('Cannot pass an old state object to a connection')
        self.maybe_send_changes(doc_id)

    def receive_msg(self, msg):
        """(connection.js:91-108). The envelope is validated BEFORE any
        state mutation: a malformed message raises
        :class:`MessageRejected` (counted under ``sync_msgs_rejected``)
        and leaves ``_their_clock`` untouched."""
        validate_msg(msg)
        self.metrics.bump('sync_msgs_received')
        if self.metrics.active:
            self.metrics.emit('sync_receive', doc_id=msg.get('docId'),
                              changes=len(msg.get('changes') or ()))
        if 'clock' in msg and msg['clock'] is not None:
            self._their_clock = clock_union(self._their_clock, msg['docId'], msg['clock'])
        if 'snapshot' in msg:
            return self._receive_snapshot(msg)
        if 'state' in msg and msg['state'] is not None:
            return self._receive_state(msg)
        if 'changes' in msg and msg['changes'] is not None:
            return self._doc_set.apply_changes(msg['docId'], msg['changes'])

        if self._doc_set.get_doc(msg['docId']) is not None:
            self.maybe_send_changes(msg['docId'])
        elif msg['docId'] not in self._our_clock:
            # The remote node has a document we don't: request it by
            # advertising an empty clock.
            self.send_msg(msg['docId'], {})

        return self._doc_set.get_doc(msg['docId'])

    def _receive_state(self, msg):
        """Absorb a served per-doc state snapshot (tiered doc
        storage), then advertise the doc's new clock so the sender
        ships the retained tail through the normal protocol."""
        doc_id = msg['docId']
        apply_state = getattr(self._doc_set, 'apply_state', None)
        if apply_state is None:
            _reject(f'state payload for {doc_id!r} but this doc set '
                    f'cannot absorb state snapshots')
        self.metrics.bump('sync_state_msgs_received')
        out = apply_state(doc_id, msg['state'])
        self.maybe_send_changes(doc_id)
        return out

    def _receive_snapshot(self, msg):
        """Resume from a served snapshot, then replay any LOCAL changes
        the snapshot does not cover (concurrent edits survive the
        resync; the peer gets them through the normal protocol)."""
        from .. import snapshot as _snapshot
        doc_id = msg['docId']
        self.metrics.bump('sync_snapshots_received')
        old_doc = self._doc_set.get_doc(doc_id)
        actor_id = Frontend.get_actor_id(old_doc) if old_doc is not None \
            else None
        new_doc = _snapshot.load_snapshot(
            msg['snapshot'], actor_id=actor_id,
            device=self._snapshot_device(old_doc))
        if old_doc is not None:
            old_state = Frontend.get_backend_state(old_doc)
            new_state = Frontend.get_backend_state(new_doc)
            try:
                local_only = _backend_of(old_doc).get_missing_changes(
                    old_state, new_state.clock)
            except ValueError:
                raise ValueError(
                    'both replicas hold snapshot-truncated histories '
                    'that diverged before their resume points; they '
                    'cannot merge losslessly — resync one side from a '
                    'full change log or a common snapshot') from None
            if local_only:
                from ..device import backend as DeviceBackend
                new_state, patch = DeviceBackend.apply_changes(
                    new_state, local_only)
                patch['state'] = new_state
                new_doc = Frontend.apply_patch(new_doc, patch)
        self._doc_set.set_doc(doc_id, new_doc)
        return new_doc

    def _snapshot_device(self, old_doc):
        """The device a served snapshot resumes on: the doc set's
        (``DeviceDocSet``/``GeneralDocSet`` carry one), else that of
        the document it replaces, else None (CUDA)."""
        device = getattr(self._doc_set, 'device', None)
        if device is None and old_doc is not None:
            state = Frontend.get_backend_state(old_doc)
            device = getattr(state, 'device', None)
            store = getattr(state, 'store', None)
            if device is None and store is not None:
                device = getattr(store, 'device', None)
        return device

    # camelCase aliases (reference API parity)
    sendMsg = send_msg
    maybeSendChanges = maybe_send_changes
    docChanged = doc_changed
    receiveMsg = receive_msg


class BatchingConnection(Connection):
    """A Connection that accumulates incoming data messages and applies
    them in ONE batched call per network tick.

    The reference applies each data message's changes per document as it
    arrives (src/connection.js:95-97); on this framework's batch engines
    that wastes the whole point — a tick's worth of messages across MANY
    documents is exactly one device dispatch. ``receive_msg`` buffers
    data messages (clock bookkeeping still happens immediately, in
    arrival order); :meth:`flush` routes the buffered changes through
    ``doc_set.apply_changes_batch`` (one fused device call on a
    :class:`~automerge_tpu_torch.sync.device_doc_set.DeviceDocSet`) and then
    runs the deferred per-doc protocol follow-ups. Call ``flush()`` at
    the end of each delivery tick; message traffic is identical to the
    eager Connection.
    """

    def __init__(self, doc_set, send_msg):
        super().__init__(doc_set, send_msg)
        self._incoming = []
        # per-doc fault isolation record for doc sets WITHOUT their own
        # quarantine registry (GeneralDocSet carries its own): doc_id
        # -> {'error': repr, 'changes': [...]}. A later successful
        # delivery clears the entry.
        self.quarantined = {}

    def receive_msg(self, msg):
        if isinstance(msg, dict) and 'changes' in msg \
                and msg['changes'] is not None:
            validate_msg(msg)
            self.metrics.bump('sync_msgs_received')
            if 'clock' in msg and msg['clock'] is not None:
                self._their_clock = clock_union(
                    self._their_clock, msg['docId'], msg['clock'])
            self._incoming.append(msg)
            return None                      # applied on flush()
        return super().receive_msg(msg)

    def flush(self):
        """Apply the tick's buffered traffic in one batched call;
        returns {doc_id: doc} for the docs that changed. The timing/
        tracing template for every batched flavor: subclasses override
        :meth:`_flush_pending` (is there work?) and :meth:`_flush_work`
        (do it), never this wrapper, so the ``sync.flush`` span and the
        ``sync_flush_ms`` series stay consistent across protocols.

        Faults are isolated PER DOCUMENT: a doc whose changes raise is
        rolled back (the engines' store-intact-on-error contract) and
        quarantined with its exception — every other doc in the tick
        applies normally. Quarantine lands on the doc set's own
        registry when it has one (``GeneralDocSet.quarantined``), else
        on :attr:`quarantined` here; quarantined docs are retriable (a
        corrected later delivery clears the entry)."""
        if not self._flush_pending():
            # no-op tick: don't let empty flushes pollute the
            # sync_flush_ms quantiles or fill the flight recorder
            return {}
        t0 = time.perf_counter()
        with self.metrics.trace_span('sync.flush'):
            out = self._flush_work()
        self.metrics.observe('sync_flush_ms',
                             (time.perf_counter() - t0) * 1e3)
        return out

    def _flush_pending(self):
        return bool(self._incoming)

    def _flush_work(self):
        return self._flush_data()

    def _flush_data(self):
        """The buffered-dict-message half of :meth:`flush`."""
        if not self._incoming:
            return {}
        changes_by_doc = {}
        for msg in self._incoming:
            changes_by_doc.setdefault(msg['docId'], []) \
                .extend(msg['changes'])
        self._incoming = []
        self.metrics.bump('sync_changes_received',
                          sum(len(c) for c in changes_by_doc.values()))
        apply_batch = getattr(self._doc_set, 'apply_changes_batch', None)
        if apply_batch is not None:
            if hasattr(self._doc_set, 'quarantined'):
                # the doc set isolates internally (one fused apply on
                # the happy path, per-doc fallback on a fault)
                return apply_batch(changes_by_doc, isolate=True)
            try:
                return apply_batch(changes_by_doc)
            except Exception:
                # the batched apply rolled back; isolate per doc below
                pass
        out = {}
        for doc_id, changes in changes_by_doc.items():
            try:
                out[doc_id] = self._doc_set.apply_changes(doc_id,
                                                          changes)
                # clear quarantine only once the STORED changes are
                # accounted for: entries the doc's clock now covers
                # were superseded by a corrected redelivery; the rest
                # re-apply (transient fault) or keep the entry alive
                held = self.quarantined.get(doc_id)
                if held is not None:
                    state = Frontend.get_backend_state(out[doc_id])
                    clock = state.clock if state is not None else {}
                    pending = [c for c in held['changes']
                               if not isinstance(c, dict) or
                               c.get('seq', 0) >
                               clock.get(c.get('actor'), 0)]
                    try:
                        if pending:
                            out[doc_id] = self._doc_set.apply_changes(
                                doc_id, pending)
                        del self.quarantined[doc_id]
                    except Exception as err:
                        held['error'] = repr(err)
            except Exception as err:
                self.quarantined[doc_id] = {'error': repr(err),
                                            'changes': list(changes)}
                self.metrics.bump('sync_docs_quarantined')
                if self.metrics.active:
                    self.metrics.emit('doc_quarantined', doc_id=doc_id,
                                      error=repr(err))
        return out

    receiveMsg = receive_msg


class WireConnection(BatchingConnection):
    """The columnar binary delta path: a BatchingConnection whose DATA
    messages are multi-doc wire blobs instead of per-doc dict lists.

    Sender side, a network tick's ``doc_changed`` follow-ups coalesce
    into ONE multi-doc message per peer (``{'wire': 1, 'docs': [...],
    'clocks': [...], 'counts': [...], 'lens': [...], 'blob': bytes}``):
    each doc's missing changes come from the store's per-change encode
    cache (:meth:`~automerge_tpu_torch.device.blocks.BlockStore.
    get_missing_changes_wire`) as pre-encoded byte spans — with N peers
    a change encodes once and fans out N times, and a zero-change span
    is a bundled clock advertisement. Receive side, the tick's buffered
    blobs merge per doc and ride the native codec -> stager path in one
    fused apply (:meth:`GeneralDocSet.apply_wire
    <automerge_tpu_torch.sync.general_doc_set.GeneralDocSet.apply_wire>`);
    a fused-apply fault falls back to the dict batch path, which
    isolates and quarantines per document.

    Clock bookkeeping and message SEMANTICS are protocol-identical to
    the dict path (same advertisements, same requests, same snapshot
    fallback for truncated logs — those stay dict messages); only data
    transport is columnar. Both endpoints must speak it: pair
    WireConnection with WireConnection, and keep
    Connection/BatchingConnection for dict-path interop. Requires a
    wire-capable doc set (GeneralDocSet).
    """

    def __init__(self, doc_set, send_msg, max_msg_bytes=None,
                 wire_version=WIRE_VERSION):
        super().__init__(doc_set, send_msg)
        store = getattr(doc_set, 'store', None)
        if not hasattr(doc_set, 'apply_wire') or store is None or \
                not hasattr(store, 'get_missing_changes_wire'):
            raise TypeError(
                'WireConnection requires a wire-capable doc set '
                '(GeneralDocSet: apply_wire + a store serving '
                'get_missing_changes_wire); use Connection or '
                'BatchingConnection for other doc sets')
        if wire_version not in (1, 2, 3):
            raise ValueError(
                f'wire_version must be 1, 2 or 3, got {wire_version!r}')
        # per-peer flow control: soft cap on one outgoing message's
        # blob bytes — data spans past the cap carry to the next tick
        # (re-served from the encode cache, so deferral costs no
        # re-encode). None = unbounded.
        self.max_msg_bytes = max_msg_bytes
        # wire-format version negotiation (the PR 7/8 v-stamp pattern:
        # the stamp rides the messages themselves, no extra handshake).
        # `wire_version` is the highest format THIS side speaks; every
        # outgoing wire message from a v2-capable sender carries
        # `maxv`, and data ships in min(ours, the peer's advertised
        # maxv). A v1-only peer never advertises, so it pins the
        # sender to v1 framing; and because data only ever flows to a
        # peer we have HEARD from (their_clock gates the serve), the
        # first data message always follows at least one incoming
        # message — a pure-v2 pair negotiates up before any data
        # ships, costing zero v1 round-trips.
        self.wire_version = wire_version
        self._peer_wire_version = 1
        # state-bootstrap capability (tiered doc storage): `maxs`
        # rides every outgoing wire/state message exactly like `maxv`;
        # a peer that never advertises it (an old build) gets the
        # legacy snapshot fallback instead of 'state' messages
        self._peer_state_version = 0
        self._pending_send = {}       # doc_id -> None (insertion order)
        self._incoming_wire = []
        self._incoming_state = []
        # wire v3 session string tables. Sender: ONE SessionStringTable
        # (lazily created on the first v3 data send — its fresh module-
        # unique `sid` is the session epoch every outgoing v3 message
        # stamps). Receiver: ref -> literal maps keyed by the PEER's
        # sid; at most two epochs stay live (the current one plus the
        # one a reconnecting peer just abandoned), older epochs drop.
        self._tx_table = None
        self._rx_tables = {}
        # wire-v3 warm-up bookkeeping: `_warm_served` is the literal
        # list this side shipped inside a 'state' bootstrap (kept to
        # seed OUR rx map for the peer's warmed session when its first
        # v3 message arrives carrying the 'warm' stamp); fixed once
        # per connection so both ends agree on which snapshot set
        # defines the warm refs. `_warm_announce` stamps outgoing v3
        # messages until one is acked (the peer's seed is then proven
        # applied).
        self._warm_served = None
        self._warm_announce = False
        # delta-clock baseline (v3 warm-link advert compression): per
        # doc, the highest clock PROVEN shared with the peer — folded
        # only from payload clocks the peer explicitly acked (ack =>
        # delivered => the receiver folded that very clock into its
        # view of us, so eliding those entries from a later shipped
        # clock loses it nothing; plain union reconstructs exactly).
        # Outgoing v3 clocks ship only the entries above this
        # baseline; a fresh session (empty baseline) ships full
        # clocks — the session-reset fallback.
        self._adv_acked = {}

    def open(self):
        """Advertise every doc WITHOUT materializing handles: the wire
        ``doc_changed`` only needs the doc id, and a serving doc set
        must not fault its whole evicted tail back in just because a
        connection opened."""
        for doc_id in self._doc_set.doc_ids:
            self._pending_send[doc_id] = None
        self._doc_set.register_handler(self.doc_changed)

    def maybe_send_changes(self, doc_id):
        """Deferred: data sends coalesce into the tick's single
        multi-doc wire message (:meth:`flush`); the data-vs-
        advertisement decision happens there against the then-current
        clocks."""
        self._pending_send[doc_id] = None

    maybeSendChanges = maybe_send_changes

    def doc_changed(self, doc_id, doc):
        """DocSet handler — straight to the pending set. The base
        class's stale-state guard protects against re-registering an
        OLD frontend document object; wire doc sets hand out live
        handles whose state is the store itself, so the per-doc clock
        fetch it costs is pure overhead on a 10k-doc tick."""
        self._pending_send[doc_id] = None

    docChanged = doc_changed

    def receive_msg(self, msg):
        if isinstance(msg, dict) and 'state' in msg \
                and 'docs' in msg:
            # multi-doc state bootstrap: clock bookkeeping now (the
            # horizon clocks are the sender's proven floor), payloads
            # buffered and absorbed at flush BEFORE any buffered data
            # — the tail in the same tick lands on absorbed state
            validate_state_msg(msg)
            self._note_peer_caps(msg)
            self.metrics.bump('sync_msgs_received')
            self.metrics.bump('sync_state_msgs_received')
            for doc_id, clock in zip(msg['docs'], msg['clocks']):
                self._their_clock = clock_union(self._their_clock,
                                                doc_id, clock)
            if SESSION_WARMUP and msg.get('warm') and \
                    min(self.wire_version,
                        self._peer_wire_version) >= 3:
                self._warm_from_state(msg)
            self._incoming_state.append(msg)
            return None
        if isinstance(msg, dict) and 'wire' in msg:
            validate_wire_msg(msg)
            self._note_peer_caps(msg)
            if msg['wire'] > self.wire_version:
                # a peer shipped a format newer than this side speaks —
                # reject loudly (a conforming sender never does this:
                # it pins to the receiver's advertised maxv)
                _reject(f"wire version {msg['wire']} not spoken here "
                        f"(max {self.wire_version})")
            if msg['wire'] >= 3:
                # resolve session refs NOW, in arrival order — the
                # rewrite into per-message-tab form happens before any
                # bookkeeping, so an unresolvable ref (table state
                # lost) aborts the whole delivery cleanly: the
                # envelope is never acked and the sender's retransmit
                # repairs it, exactly like a checksum drop
                msg = self._resolve_session_msg(msg)
            self.metrics.bump('sync_msgs_received')
            self.metrics.bump('sync_wire_msgs_received')
            if msg['wire'] == 2:
                self.metrics.bump('sync_wire_v2_msgs_received')
            elif msg['wire'] >= 3:
                self.metrics.bump('sync_wire_v3_msgs_received')
            # clock bookkeeping happens immediately, in arrival order —
            # exactly the dict data path
            for doc_id, clock in zip(msg['docs'], msg['clocks']):
                self._their_clock = clock_union(self._their_clock,
                                                doc_id, clock)
            self._incoming_wire.append(msg)
            # zero-change spans are advertisements and answer NOW (data
            # spans never trigger replies, like dict data messages);
            # unknown docs mark pending and go out as BATCHED requests
            # — zero-change spans with an empty clock in the next
            # outgoing wire message, not one dict message per doc
            for doc_id, count in zip(msg['docs'], msg['counts']):
                if count:
                    continue
                if self._doc_set.get_doc(doc_id) is not None:
                    self.maybe_send_changes(doc_id)
                elif doc_id not in self._our_clock:
                    self._pending_send[doc_id] = None
            return None
        return super().receive_msg(msg)

    receiveMsg = receive_msg

    def _note_peer_caps(self, msg):
        """Fold the negotiation stamps a peer's message carries:
        ``maxv`` (highest wire-blob format it speaks) and ``maxs``
        (highest state-bootstrap version) — the in-band capability
        advertisement every wire/state message repeats."""
        maxv = msg.get('maxv')
        if isinstance(maxv, int) and not isinstance(maxv, bool) \
                and maxv > self._peer_wire_version:
            self._peer_wire_version = min(maxv, self.wire_version)
        maxs = msg.get('maxs')
        if isinstance(maxs, int) and not isinstance(maxs, bool) \
                and maxs > self._peer_state_version:
            self._peer_state_version = min(maxs, STATE_VERSION)

    def _warm_from_state(self, msg):
        """The bootstrapping peer's half of wire-v3 warm-up: derive
        the served snapshots' actor/key literal list (identical to
        what the sender derived — same bytes, same helper) and
        pre-seed OUR session string table with it, entries acked, so
        the first warm flush back ships bare refs. Outgoing v3
        messages then carry the ``'warm'`` stamp until one acks,
        telling the sender to seed its receive map by enumerating the
        same list. Skipped whenever the table already allocated refs
        (warm refs must never collide with organic ones)."""
        if self._tx_table is not None and len(self._tx_table):
            return
        from .. import wire as _wire
        from ..compaction import state_warm_literals
        blob = memoryview(msg['blob'])
        chunks, pos = [], 0
        for ln in msg['lens']:
            chunks.append(blob[pos:pos + ln])
            pos += ln
        lits = state_warm_literals(chunks)
        if not lits:
            return
        if self._tx_table is None:
            table = self._tx_table = _wire.SessionStringTable()
            register = getattr(self._doc_set.store,
                               'register_wire_session', None)
            if register is not None:
                register(table)
        n = self._tx_table.warm(lits)
        if n:
            self._warm_announce = True
            self.metrics.bump('sync_wire_session_warmups')
            self.metrics.bump('sync_wire_warm_literals', n)

    def _resolve_session_msg(self, msg):
        """Rewrite one incoming v3 message from session-table form
        (spans referencing the peer's session-wide refs, ``tab``
        carrying this message's new defs) into the self-contained
        per-message-tab form the buffered flush consumes. Defs install
        idempotently (dup/retransmit-safe); an unknown ref raises
        ValueError — the sender defines every literal in EVERY message
        until one is acked, so this only happens when the receiver's
        table state is lost (e.g. a restart), and the unacked envelope
        repairs via retransmit, never quarantine."""
        from .. import wire as _wire
        sid = msg['sid']
        refs = self._rx_tables.get(sid)
        if refs is None:
            while len(self._rx_tables) >= 2:
                # drop the oldest epoch (insertion order): a sender
                # only ever speaks its newest sid, and retransmits of
                # a dead session die with their connection
                del self._rx_tables[next(iter(self._rx_tables))]
            refs = self._rx_tables[sid] = {}
        if msg.get('warm') and self._warm_served is not None \
                and not refs:
            # the peer warmed its session from OUR 'state' bootstrap:
            # its refs 0..n-1 are the literal list we recorded when we
            # served it, in enumerate order (setdefault-idempotent —
            # retransmits and organic defs never clash: the peer's
            # organic refs start past the warm block)
            for i, lit in enumerate(self._warm_served):
                refs[i] = lit
            self.metrics.bump('sync_wire_session_warmups')
        for ref, lit in _wire.decode_session_defs(msg['tab']):
            refs[ref] = lit
        try:
            entries = _wire.decode_session_spans(
                msg['blob'], msg['lens'], refs)
        except ValueError:
            self.metrics.bump('sync_wire_table_stale_refs')
            raise
        spans, tab = _wire.assemble_columnar_spans(entries)
        return {**msg, 'tab': tab, 'blob': b''.join(spans),
                'lens': [len(s) for s in spans]}

    def note_wire_acked(self, payload):
        """Envelope-layer feedback (the resilient shell's ack hook):
        a stored v3 wire payload was acknowledged — its defs become
        session-confirmed (bare references from now on) and its ref
        uses unpin. Stateless: the refs re-derive from the payload
        itself, so no per-seq side table exists to leak. Every acked
        payload clock (wire AND state) also advances the delta-clock
        baseline: those entries are proven delivered, so later
        adverts elide them."""
        if isinstance(payload, dict):
            docs = payload.get('docs')
            clocks = payload.get('clocks')
            if isinstance(docs, list) and isinstance(clocks, list) \
                    and len(docs) == len(clocks):
                for doc_id, clock in zip(docs, clocks):
                    if isinstance(clock, dict) and clock:
                        clock_union(self._adv_acked, doc_id, clock)
        if self._tx_table is None or not isinstance(payload, dict) \
                or payload.get('wire') != 3 \
                or payload.get('sid') != self._tx_table.sid:
            return
        from .. import wire as _wire
        def_refs, used = _wire.session_payload_refs(payload)
        self._tx_table.note_acked(def_refs, used)
        if self._warm_announce and payload.get('warm'):
            # a warm-stamped message acked: the peer decoded it, so
            # its receive map is provably seeded — stop stamping
            self._warm_announce = False

    def note_wire_dead(self, payload):
        """Envelope-layer feedback: a stored v3 wire payload died
        permanently (retry budget exhausted) — unpin its ref uses so
        eviction can reclaim them; its defs stay unconfirmed and
        re-define on next use."""
        if self._tx_table is None or not isinstance(payload, dict) \
                or payload.get('wire') != 3 \
                or payload.get('sid') != self._tx_table.sid:
            return
        from .. import wire as _wire
        _, used = _wire.session_payload_refs(payload)
        self._tx_table.note_dead(used)

    def note_clock_regressed(self, doc_id, clock):
        """Membership of the regression heal (resilient.py's
        heartbeat branch): the peer provably lost state down to
        ``clock`` — the delta baseline must regress with it, or later
        adverts would elide entries the peer no longer holds."""
        self._adv_acked[doc_id] = dict(clock)

    def _ship_clock(self, doc_id, clock, version, advert=False):
        """The clock dict actually SHIPPED for a doc: on a warm v3
        link, only the entries above the peer-acked baseline (the
        receiver reconstructs exactly by union — every elided entry
        already reached it inside an acked payload it folded).
        Adverts never collapse to {}: an empty clock on a zero-count
        span is protocol-identical to a REQUEST, so a fully-elided
        advert ships whole instead."""
        if version < 3:
            return dict(clock)
        base = self._adv_acked.get(doc_id)
        if not base:
            return dict(clock)
        delta = {a: s for a, s in clock.items()
                 if s > base.get(a, 0)}
        if advert and not delta and clock:
            return dict(clock)
        elided = len(clock) - len(delta)
        if elided:
            self.metrics.bump('sync_wire_clock_entries_elided',
                              elided)
        return delta

    def _flush_pending(self):
        return bool(self._incoming or self._incoming_wire
                    or self._incoming_state or self._pending_send)

    def _flush_work(self):
        """Apply the tick's buffered data: state bootstraps absorb
        FIRST (the tail buffered in the same tick lands on absorbed
        state), then dict messages through the batched dict path and
        wire blobs through ONE fused apply_wire; finally assemble and
        ship the single outgoing multi-doc wire message the tick's
        ``doc_changed`` follow-ups asked for. Returns {doc_id: doc}
        for the docs that changed — the body
        :meth:`BatchingConnection.flush` times and traces."""
        out = self._flush_state()
        out.update(self._flush_data())
        out.update(self._flush_wire())
        self._flush_outgoing()
        return out

    def _flush_state(self):
        """Absorb the tick's buffered state-bootstrap payloads in one
        batched ``apply_states`` (per-doc fault isolation inside)."""
        if not self._incoming_state:
            return {}
        payloads = {}                  # doc_id -> latest payload
        for msg in self._incoming_state:
            blob, lens = msg['blob'], msg['lens']
            pos = 0
            for doc_id, ln in zip(msg['docs'], msg['lens']):
                payloads[doc_id] = bytes(blob[pos:pos + ln])
                pos += ln
        self._incoming_state = []
        apply_states = getattr(self._doc_set, 'apply_states', None)
        if apply_states is None:
            self.metrics.bump('sync_msgs_rejected')
            return {}
        return apply_states(payloads)

    def _flush_wire(self):
        """Merge the buffered wire blobs per document and apply in one
        fused codec->stager pass per FORMAT: v1 JSON spans concatenate
        into the JSON multi-doc shape, v2 columnar spans (plus their
        messages' shared literal tabs) stitch into one AMW2 container,
        v3 spans (already rewritten to per-message-tab form at receive)
        into one AMW3 container — both zero-``json.loads`` paths. A
        mixed-version tick (v1/v2/v3 peers buffered together) costs at
        most one fused apply per format."""
        if not self._incoming_wire:
            return {}
        segs_by_doc = {}                 # v1: doc_id -> [json bytes]
        spans_by_doc = {}                # v2: doc_id -> [(tab_i, span)]
        spans3_by_doc = {}               # v3: doc_id -> [(tab_i, span)]
        tabs = []
        tabs3 = []
        n_changes = 0
        for msg in self._incoming_wire:
            blob, lens = msg['blob'], msg['lens']
            v = msg['wire']
            if v >= 3:
                tab_i = len(tabs3)
                tabs3.append(bytes(msg['tab']))
                bucket = spans3_by_doc
            elif v == 2:
                tab_i = len(tabs)
                tabs.append(bytes(msg['tab']))
                bucket = spans_by_doc
            else:
                bucket = segs_by_doc
            pos = 0
            k = 0
            for doc_id, count in zip(msg['docs'], msg['counts']):
                if not count:
                    continue
                segs = bucket.setdefault(doc_id, [])
                for ln in lens[k:k + count]:
                    span = blob[pos:pos + ln]
                    segs.append((tab_i, span) if v >= 2 else span)
                    pos += ln
                k += count
                n_changes += count
        self._incoming_wire = []
        if not segs_by_doc and not spans_by_doc and not spans3_by_doc:
            return {}
        self.metrics.bump('sync_changes_received', n_changes)
        out = {}
        if segs_by_doc:
            def decode_v1(segs):
                import json as _json
                return _json.loads(
                    (b'[' + b','.join(segs) + b']').decode('utf-8'))

            data = b'[' + b','.join(
                b'[' + b','.join(segs) + b']'
                for segs in segs_by_doc.values()) + b']'
            out.update(self._apply_wire_isolated(
                data, segs_by_doc, decode_v1))
        if spans_by_doc:
            from .. import wire as _wire

            def decode_v2(spans):
                data_1 = _wire.build_columnar_container(tabs, [spans])
                return _wire.columnar_container_to_changes(data_1)[0]

            data = _wire.build_columnar_container(
                tabs, list(spans_by_doc.values()))
            out.update(self._apply_wire_isolated(
                data, spans_by_doc, decode_v2))
        if spans3_by_doc:
            from .. import wire as _wire

            def decode_v3(spans):
                data_1 = _wire.build_columnar_container(
                    tabs3, [spans], version=3)
                return _wire.columnar_container_to_changes(data_1)[0]

            data = _wire.build_columnar_container(
                tabs3, list(spans3_by_doc.values()), version=3)
            out.update(self._apply_wire_isolated(
                data, spans3_by_doc, decode_v3))
        retry = getattr(self._doc_set, 'retry_quarantined', None)
        if retry is not None:
            held = [d for d in out if d in self._doc_set.quarantined]
            if held:
                retry(held)
        return out

    def _apply_wire_isolated(self, data, segs_by_doc, decode_doc):
        """One fused ``apply_wire`` with the per-document quarantine
        fallback: a fused-apply fault rolls back (store-intact-on-
        error) and the payload re-delivers doc by doc through the dict
        batch path, which isolates and quarantines the poisoned ones.
        ``decode_doc`` turns one doc's raw spans back into dict
        changes; a doc whose spans do not even decode (impossible
        under the checksummed envelope transport) quarantines with no
        retriable body."""
        doc_ids = list(segs_by_doc)
        try:
            handles = self._doc_set.apply_wire(data, doc_ids=doc_ids)
        except Exception:
            changes_by_doc = {}
            for doc_id, segs in segs_by_doc.items():
                try:
                    changes_by_doc[doc_id] = decode_doc(segs)
                except (ValueError, UnicodeDecodeError) as err:
                    registry = getattr(self._doc_set, 'quarantined',
                                       self.quarantined)
                    registry[doc_id] = {'error': repr(err),
                                        'changes': []}
                    self.metrics.bump('sync_docs_quarantined')
            return self._doc_set.apply_changes_batch(
                changes_by_doc, isolate=True)
        return dict(zip(doc_ids, handles))

    def _serve_state_bootstraps(self, served, errors, version):
        """The horizon answer of the serve path: docs whose requester
        clock predates the compaction horizon
        (:class:`~automerge_tpu_torch.device.blocks.HorizonTruncated` in
        ``errors``) ship their recorded per-doc state snapshot in ONE
        ``'state'`` message, and their retained TAIL is re-served
        from the horizon clock into the tick's normal data message —
        cold-peer bootstrap lands in a single tick, O(state +
        divergence). Peers that never advertised ``maxs`` keep the
        legacy snapshot fallback (their error stays put)."""
        from ..device.blocks import HorizonTruncated
        if self._peer_state_version < 1:
            return
        store = self._doc_set.store
        ids = self._doc_set.ids
        horizon = getattr(store, 'horizon', None) or {}
        boot = {}
        for idx, err in list(errors.items()):
            rec = horizon.get(idx)
            if isinstance(err, HorizonTruncated) and rec is not None \
                    and rec.get('state') is not None:
                boot[idx] = rec
                del errors[idx]
        if not boot:
            return
        tail_served, tail_errors = store.get_missing_changes_wire_batch(
            [(idx, rec['clock']) for idx, rec in boot.items()],
            version=version)
        served.update(tail_served)
        errors.update(tail_errors)
        docs, clocks, lens, chunks = [], [], [], []
        for idx, rec in boot.items():
            if idx in tail_errors:
                continue
            doc_id = ids[idx]
            docs.append(doc_id)
            clocks.append(dict(rec['clock']))
            lens.append(len(rec['state']))
            chunks.append(rec['state'])
            # assume delivery up to the horizon (the resilient shell
            # rolls this back when the envelope dies), so the next
            # tick never re-ships the same snapshot
            clock_union(self._their_clock, doc_id, rec['clock'])
            clock_union(self._our_clock, doc_id, rec['clock'])
        if not docs:
            return
        blob = b''.join(chunks)
        msg = {'state': 1, 'docs': docs, 'clocks': clocks,
               'lens': lens, 'blob': blob, 'maxs': STATE_VERSION}
        if self.wire_version >= 2:
            msg['maxv'] = self.wire_version
        if SESSION_WARMUP and self._warm_served is None and \
                min(self.wire_version, self._peer_wire_version) >= 3:
            # wire-v3 warm-up offer: remember the literal list these
            # snapshots define and stamp the message, so the
            # bootstrapping peer may pre-seed its session table with
            # refs we can resolve (enumerating the SAME list)
            from ..compaction import state_warm_literals
            lits = state_warm_literals(chunks)
            if lits:
                self._warm_served = lits
                msg['warm'] = 1
        self.metrics.bump('sync_msgs_sent')
        self.metrics.bump('sync_state_msgs_sent')
        self.metrics.bump('sync_wire_bytes_sent', len(blob))
        if self.metrics.active:
            self.metrics.emit('sync_state_send', docs=len(docs),
                              blob_bytes=len(blob))
        self._send_msg(msg)

    def _flush_outgoing(self):
        """Assemble and ship the tick's single multi-doc wire message:
        cached change encodings for peers behind on data, zero-change
        spans as bundled advertisements. The serve is fleet-grained —
        one clock sweep and one batched cache fill
        (``get_missing_changes_wire_batch``: at most one native emit
        per retained block) regardless of how many docs the tick
        touched."""
        if not self._pending_send:
            return
        with self.metrics.trace_span('sync.flush_send',
                                     pending=len(self._pending_send)):
            self._flush_outgoing_traced()

    def _flush_outgoing_traced(self):
        pending = list(self._pending_send)
        self._pending_send.clear()
        # the negotiated DATA format for this peer: min(ours, their
        # advertised maxv) — v3 session columnar between two v3 ends,
        # v2 per-message columnar against a v2 peer, v1 JSON spans
        # until a peer advertises at all (and forever against v1)
        version = min(self.wire_version, self._peer_wire_version)
        # serving doc sets fault evicted docs back in before the serve
        # (a sync touch); docs the peer's clock already covers stay
        # evicted and report their RECORDED clock instead of the
        # store's (empty) one
        ensure = getattr(self._doc_set, 'ensure_resident', None)
        evicted_clocks = {}
        if ensure is not None:
            evicted_clocks = ensure(pending,
                                    peer_clocks=self._their_clock) \
                or {}
        store = self._doc_set.store
        id_of = self._doc_set.id_of
        if len(pending) > 16 and hasattr(store, 'clocks_all'):
            fleet_clocks = store.clocks_all()
            clock_of = lambda i: fleet_clocks.get(i, {})  # noqa: E731
        else:
            fleet_clocks = None
            clock_of = store.clock_of
        wants = []                       # (idx, have) for known peers
        for doc_id in pending:
            idx = id_of.get(doc_id)
            if idx is None or doc_id in evicted_clocks:
                continue
            if doc_id in self._their_clock:
                wants.append((idx, self._their_clock[doc_id]))
        if wants:
            with self.metrics.trace_span('wire.serve',
                                         docs=len(wants)) as span:
                served, errors = store.get_missing_changes_wire_batch(
                    wants, all_clocks=fleet_clocks, version=version)
                if self.metrics.active:
                    # the serve span carries the byte volume it served
                    # (trace_report's per-tick wire MB/s) — summed only
                    # under an observer, the idle path stays free
                    span.set(bytes=sum(
                        _entry_bytes(e) for blobs in served.values()
                        for e in blobs))
        else:
            served, errors = {}, {}
        if errors:
            self._serve_state_bootstraps(served, errors, version)
        docs, clocks, counts, chunks = [], [], [], []
        blob_bytes = 0
        data_docs = 0
        deferred = []
        for doc_id in pending:
            idx = id_of.get(doc_id)
            if idx is None:
                # a REQUEST: the peer advertised a doc we don't hold.
                # A zero-change span with an empty clock is protocol-
                # identical to the dict path's send_msg(doc_id, {}),
                # and the _our_clock entry (empty) suppresses repeat
                # requests exactly like the dict path
                if doc_id not in self._our_clock:
                    self._our_clock[doc_id] = {}
                    docs.append(doc_id)
                    clocks.append({})
                    counts.append(0)
                continue
            clock = evicted_clocks.get(doc_id)
            if clock is None:
                clock = clock_of(idx)
            if idx in errors:
                self._send_snapshot(doc_id, clock, errors[idx])
                continue
            blobs = served.get(idx)
            if blobs:
                size = sum(_entry_bytes(b) for b in blobs)
                if self.max_msg_bytes is not None and data_docs and \
                        blob_bytes + size > self.max_msg_bytes:
                    # over the per-message byte cap: this doc's data
                    # span (whole — clocks stay trivially exact) waits
                    # for the next tick's message. The first data span
                    # always ships, so an oversize single doc still
                    # makes progress.
                    deferred.append(doc_id)
                    continue
                blob_bytes += size
                data_docs += 1
                clock_union(self._their_clock, doc_id, clock)
                clock_union(self._our_clock, doc_id, clock)
                docs.append(doc_id)
                clocks.append(self._ship_clock(doc_id, clock,
                                               version))
                counts.append(len(blobs))
                chunks.extend(blobs)
                continue
            if clock != self._our_clock.get(doc_id, {}):
                clock_union(self._our_clock, doc_id, clock)
                docs.append(doc_id)
                clocks.append(self._ship_clock(doc_id, clock,
                                               version, advert=True))
                counts.append(0)
        if deferred:
            # carry past the cap to the next tick, in order; the
            # next serve re-reads the SAME cached encodings
            for doc_id in deferred:
                self._pending_send[doc_id] = None
            self.metrics.bump('sync_flow_deferred_docs',
                              len(deferred))
        self.metrics.set_gauge('sync_flow_backlog_docs',
                               len(self._pending_send))
        if not docs:
            return
        # assemble the data payload. Zero-data messages (pure
        # advertisement/request bundles) keep the v1 SHAPE whatever
        # the negotiated version — the v-stamp marks the payload
        # format, exactly the envelope-v pattern; `maxv` rides every
        # message a v2-capable sender ships, which is the whole
        # negotiation.
        tab_hits = tab_misses = 0
        if chunks and version >= 3:
            from .. import wire as _wire
            table = self._tx_table
            if table is None:
                table = self._tx_table = _wire.SessionStringTable()
                register = getattr(self._doc_set.store,
                                   'register_wire_session', None)
                if register is not None:
                    register(table)
            h0, m0, e0 = table.hits, table.misses, table.evictions
            spans, tab, _used = _wire.assemble_session_spans(
                chunks, table)
            tab_hits, tab_misses = table.hits - h0, table.misses - m0
            if table.evictions != e0:
                self.metrics.bump('sync_wire_table_evictions',
                                  table.evictions - e0)
            lens = [len(s) for s in spans]
            blob = b''.join(spans)
            msg = {'wire': 3, 'sid': table.sid, 'docs': docs,
                   'clocks': clocks, 'counts': counts, 'lens': lens,
                   'blob': blob, 'tab': tab}
            if self._warm_announce:
                msg['warm'] = 1
            self.metrics.bump('sync_wire_v3_msgs_sent')
            self.metrics.bump('sync_wire_def_bytes_sent', len(tab))
            self.metrics.bump('sync_wire_table_hits', tab_hits)
            self.metrics.bump('sync_wire_table_misses', tab_misses)
            self.metrics.set_gauge('sync_wire_table_entries',
                                   len(table))
            self.metrics.set_gauge('sync_wire_table_bytes',
                                   table.bytes)
            payload_bytes = len(blob) + len(tab)
        elif chunks and version >= 2:
            from .. import wire as _wire
            spans, tab = _wire.assemble_columnar_spans(chunks)
            lens = [len(s) for s in spans]
            blob = b''.join(spans)
            msg = {'wire': 2, 'docs': docs, 'clocks': clocks,
                   'counts': counts, 'lens': lens, 'blob': blob,
                   'tab': tab}
            self.metrics.bump('sync_wire_v2_msgs_sent')
            payload_bytes = len(blob) + len(tab)
        else:
            lens = [len(b) for b in chunks]
            blob = b''.join(chunks)
            msg = {'wire': 1, 'docs': docs, 'clocks': clocks,
                   'counts': counts, 'lens': lens, 'blob': blob}
            payload_bytes = len(blob)
        if self.wire_version >= 2:
            msg['maxv'] = self.wire_version
        msg['maxs'] = STATE_VERSION
        self.metrics.bump('sync_msgs_sent')
        self.metrics.bump('sync_wire_msgs_sent')
        self.metrics.bump('sync_changes_sent', len(lens))
        self.metrics.bump('sync_wire_bytes_sent', payload_bytes)
        if self.metrics.active:
            self.metrics.emit('sync_wire_send', docs=len(docs),
                              changes=len(lens), v=msg['wire'],
                              blob_bytes=payload_bytes,
                              tab_hits=tab_hits,
                              tab_misses=tab_misses)
        self._send_msg(msg)
