"""ResilientConnection: the sync protocol over a LOSSY transport.

:class:`~.connection.Connection` assumes every ``send_msg`` arrives
exactly once, intact, in order — true for an in-process callback, false
for any real link (DCN between pod hosts, WAN to clients). This module
wraps either Connection flavor in a degraded-operation shell, the
robustness layer the ROADMAP's "heavy traffic from millions of users"
north star requires before multi-host sync can be trusted:

- **Versioned envelope** — every logical message travels as ``{'v': 2,
  'kind': 'data', 'seq': n, 'sum': crc32(payload), 'payload': msg}``.
  Version 2 adds the optional ``trace`` correlation field, folded into
  ``sum`` when present — bumped because a v1 receiver would reject a
  traced envelope's checksum; v1 envelopes (which never carry
  ``trace``) stay accepted. The version stamps the SHAPE, not the
  sender's code: an envelope with no trace field (every ack/busy/hb,
  and data sent with no observer subscribed) is byte-identical to the
  v1 protocol and is stamped ``v=1``, so an idle-observer deployment
  interoperates with not-yet-upgraded peers in BOTH directions; only
  an envelope actually carrying ``trace`` stamps ``v=2``. Unknown
  versions and malformed envelopes are counted rejections
  (``sync_msgs_rejected``), never crashes.
- **Checksum** — CRC32 over the canonical-JSON payload; a corrupted
  message is dropped (``sync_checksum_failures``) and NOT acked, so the
  sender's retransmit repairs it.
- **Duplicate suppression** — received seqs are tracked (compactly: a
  contiguous floor + the sparse set above it); duplicates re-ack (the
  first ack may have been lost) but are not delivered twice
  (``sync_msgs_duplicate``).
- **Ack-driven retransmit** — unacked envelopes retransmit on
  :meth:`tick` with exponential backoff + seeded jitter
  (``sync_retransmits``) under a bounded retry budget
  (``sync_retry_exhausted``); the protocol's own anti-entropy (below)
  repairs anything the budget gave up on.
- **Anti-entropy heartbeat** — every ``heartbeat_every`` ticks the
  local clocks re-advertise (Demers et al.-style gossip repair,
  PAPERS.md): a dropped advertisement, an exhausted retry budget or a
  healed partition all converge through the normal
  advertisement/request/data exchange, with no extra protocol state.

Time is logical: the owner calls :meth:`tick` once per scheduling
quantum (a network tick in tests and bench, a timer in a real
deployment). Nothing here inspects wall clocks, so chaos schedules are
perfectly reproducible from a seed.

The PyTorch port's copy of ``automerge_tpu/sync/resilient.py``.
"""

import json
import random
import time
import zlib

from ..utils.metrics import metrics
from .connection import (BatchingConnection, Connection,
                         MessageRejected, WireConnection, clock_union)

BASE_VERSION = 1
ENVELOPE_VERSION = 2
# v1: no trace/digests field. v2: a checksummed `trace` rides a data
# envelope, or `digests`+`dsum` ride a heartbeat. Accept both; STAMP
# by shape — an envelope carrying neither (acks, busy, untraced data,
# undigested heartbeats) is byte-identical to the v1 protocol and
# ships as v=1 so a v1 receiver still accepts it; only an envelope
# actually carrying the optional field ships as v=2. A heartbeat's
# main `sum` stays the plain clocks checksum even when digested, so a
# v2-accepting receiver that predates digests still validates and
# heals from digested beats (it just ignores the fields it doesn't
# know).
ACCEPTED_VERSIONS = frozenset((BASE_VERSION, ENVELOPE_VERSION))


class TokenBucket:
    """A logical-time DEBT bucket: ``rate`` tokens refill per tick,
    credit capped at ``burst``; admission requires any POSITIVE
    balance and charges the full cost, driving the balance negative.
    The coalesced wire path ships one large message per tick — a
    threshold bucket would either always admit it (cost clamped) or
    livelock (cost > burst); debt admits it once and then holds the
    door shut until the refill pays the debt off, which is exactly
    "overload degrades to latency"."""

    __slots__ = ('rate', 'burst', 'tokens')

    def __init__(self, rate, burst=None):
        self.rate = rate
        self.burst = burst if burst is not None else 4 * rate
        self.tokens = self.burst

    def tick(self):
        self.tokens = min(self.burst, self.tokens + self.rate)

    def has(self, cost):
        return self.tokens > 0

    def take(self, cost):
        self.tokens -= cost

    def ticks_until(self, cost):
        """Refill ticks until the balance is positive again — the
        retry-after hint a denied peer gets."""
        if self.tokens > 0:
            return 0
        return -(-(1 - self.tokens) // max(self.rate, 1))


class AdmissionControl:
    """Admission buckets over INCOMING change payloads — the overload
    valve of the serving layer. Two meters, both must pass: changes per
    tick and payload bytes per tick (either may be None = unmetered).
    A denied envelope gets an explicit ``busy`` reply with a
    retry-after hint — overload degrades to latency, never to silent
    loss or divergence (the sender's backoff + the anti-entropy
    heartbeat repair anything that exhausts its retry budget while the
    valve is closed).

    One instance per link is per-peer admission; one instance SHARED
    across all of a node's connections is the fleet-wide cap (the
    owner must then call :meth:`tick` exactly once per quantum —
    connections only tick the controllers they own)."""

    def __init__(self, changes_per_tick=None, bytes_per_tick=None,
                 burst_ticks=4):
        self.change_bucket = TokenBucket(
            changes_per_tick, changes_per_tick * burst_ticks) \
            if changes_per_tick else None
        self.byte_bucket = TokenBucket(
            bytes_per_tick, bytes_per_tick * burst_ticks) \
            if bytes_per_tick else None

    def tick(self):
        if self.change_bucket is not None:
            self.change_bucket.tick()
        if self.byte_bucket is not None:
            self.byte_bucket.tick()

    def check(self, n_changes, n_bytes):
        """Retry-after hint in ticks (0 = would admit). Does NOT
        charge."""
        retry = 0
        if self.change_bucket is not None and \
                not self.change_bucket.has(n_changes):
            retry = max(retry, self.change_bucket.ticks_until(
                n_changes))
        if self.byte_bucket is not None and \
                not self.byte_bucket.has(n_bytes):
            retry = max(retry, self.byte_bucket.ticks_until(n_bytes))
        return retry

    def charge(self, n_changes, n_bytes):
        if self.change_bucket is not None:
            self.change_bucket.take(n_changes)
        if self.byte_bucket is not None:
            self.byte_bucket.take(n_bytes)


def _payload_cost(payload):
    """(n_changes, n_bytes) admission cost of a logical data message.
    Wire messages meter their change count and raw blob bytes; dict
    data messages meter change count only (their byte size is not
    known without an encode — the change meter is the binding one
    there). Advertisements/requests cost nothing: the repair loop must
    never be throttled."""
    if 'wire' in payload or ('state' in payload
                             and 'docs' in payload):
        n_bytes = 0
        for field in ('blob', 'tab'):
            part = payload.get(field)
            if isinstance(part, (bytes, bytearray)):
                n_bytes += len(part)
        return (sum(payload.get('counts') or ()), n_bytes)
    changes = payload.get('changes')
    state = payload.get('state')
    return (len(changes) if isinstance(changes, (list, tuple)) else 0,
            len(state) if isinstance(state, (bytes, bytearray))
            else 0)


def payload_checksum(payload):
    """CRC32 over the canonical JSON encoding of a logical message
    (sorted keys, no whitespace) — both ends compute the same bytes
    regardless of dict ordering.

    A WIRE data message carries its change payload as a binary
    ``blob`` (and, v2, a binary literal-table ``tab``); state
    bootstraps carry their per-doc snapshot payloads as a binary
    ``blob`` (multi-doc) or ``state`` (dict-path) field: those bytes
    are checksummed DIRECTLY (CRC32 over the raw bytes, folded into
    the header checksum as ``<field>_crc32``) instead of riding
    through ``json.dumps`` — integrity for megabytes of change data
    at memcpy speed, and the reason corrupt-blob envelopes are caught
    before the codec ever parses them. A v1 message (no tab)
    checksums byte-identically to the pre-v2 protocol."""
    if isinstance(payload, dict):
        binary = {f: payload[f] for f in ('blob', 'tab', 'state')
                  if isinstance(payload.get(f), (bytes, bytearray))}
        if binary:
            head = {k: v for k, v in payload.items()
                    if k not in binary}
            for field, part in binary.items():
                head[f'{field}_crc32'] = zlib.crc32(part)
            payload = head
    return zlib.crc32(json.dumps(payload, sort_keys=True,
                                 separators=(',', ':')).encode())


def envelope_checksum(payload, trace=None):
    """The checksum a data envelope carries: the payload checksum,
    with the optional ``trace`` correlation field folded in exactly
    like any other header field — a bit flipped in the trace ids is a
    checksum failure (dropped unacked, repaired by retransmit), never
    a silently corrupted trace tree. ``trace=None`` (an envelope from
    a pre-trace sender, or an idle-observer send) degrades to the
    plain payload checksum, so old envelopes stay acceptable."""
    head = payload_checksum(payload)
    if trace is None:
        return head
    return zlib.crc32(json.dumps(trace, sort_keys=True,
                                 separators=(',', ':')).encode(), head)


def digest_checksum(digests, clocks_sum):
    """The checksum guarding a heartbeat's optional ``digests`` map,
    SEEDED by the beat's clocks checksum so the digests bind to
    exactly these clocks. It rides a separate ``dsum`` field — the
    main ``sum`` stays the plain clocks checksum a v1-era receiver
    validates, so a DIGESTED beat still heals old peers (they verify
    the clocks and ignore the fields they don't know); a new receiver
    verifies ``dsum`` too, and a bit flipped in a digest drops only
    the audit for that beat (the next beat repeats it), never the
    clocks and never a false divergence alarm."""
    return zlib.crc32(json.dumps(digests, sort_keys=True,
                                 separators=(',', ':')).encode(),
                      clocks_sum)


def _valid_digests(digests):
    """A well-formed heartbeat digest map: ``{doc_id: uint64}``."""
    if not isinstance(digests, dict):
        return False
    for doc_id, dig in digests.items():
        if not isinstance(doc_id, str) or not isinstance(dig, int) \
                or isinstance(dig, bool) or dig < 0:
            return False
    return True


def _valid_trace(trace):
    """A well-formed envelope trace field: ``{'t': trace_id, 's':
    span_id}`` with int ids."""
    return (isinstance(trace, dict) and
            isinstance(trace.get('t'), int) and
            not isinstance(trace.get('t'), bool) and
            isinstance(trace.get('s'), int) and
            not isinstance(trace.get('s'), bool))


class _Unacked:
    __slots__ = ('envelope', 'due', 'attempts', 'backpressured',
                 'bp_since')

    def __init__(self, envelope, due):
        self.envelope = envelope
        self.due = due
        self.attempts = 0
        self.backpressured = False     # last reply was a busy deferral
        self.bp_since = None           # perf_counter at first busy


class ResilientConnection:
    """One peer's end of a lossy link: an inner
    :class:`~.connection.Connection` (or
    :class:`~.connection.BatchingConnection` with ``batching=True``,
    or the columnar :class:`~.connection.WireConnection` with
    ``wire=True``) speaks the unchanged logical protocol; this shell
    owns envelopes, acks, retransmission and heartbeats. Wire data
    envelopes carry their blob under a direct CRC32-over-bytes
    checksum, and a retransmit re-ships the SAME cached bytes — no
    re-encode anywhere on the retry path.

    ``send_msg`` is the raw transport callback (now carrying envelope
    dicts); :meth:`receive_msg` takes envelopes off the transport.
    Logical-protocol state lives in the inner connection, reachable as
    :attr:`connection`.
    """

    def __init__(self, doc_set, send_msg, batching=False, wire=False,
                 retry_limit=8, backoff_base=2, backoff_max=64,
                 jitter=2, heartbeat_every=16, seed=0,
                 admission=None, shared_admission=None,
                 max_msg_bytes=None, peer_id=None, scope=None,
                 hb_digests=True, wire_version=None, resume=True):
        self._send_raw = send_msg
        if wire:
            kwargs = {} if wire_version is None \
                else {'wire_version': wire_version}
            self._conn = WireConnection(doc_set, self._send_envelope,
                                        max_msg_bytes=max_msg_bytes,
                                        **kwargs)
        else:
            conn_cls = BatchingConnection if batching else Connection
            self._conn = conn_cls(doc_set, self._send_envelope)
        self._doc_set = doc_set
        # per-connection metrics scope: with a peer_id, every counter
        # this link (and its inner connection) bumps ALSO lands under
        # peer/<id>/ — the per-connection operator surface
        # fleet_status() reads back via the doc set's connection
        # registry (register_connection, when the doc set has one).
        # `scope` overrides the default peer label when peer ids alone
        # would collide in ONE process's registry — e.g. the chaos
        # harness hosts every node in-process, so two different links
        # targeting the same node must not share a peer/<id>/ slice
        self.peer_id = peer_id
        if scope is not None:
            self.metrics = scope
        elif peer_id is not None:
            self.metrics = metrics.scoped(peer=peer_id)
        else:
            self.metrics = metrics
        self._conn.metrics = self.metrics
        if peer_id is not None:
            register = getattr(doc_set, 'register_connection', None)
            if register is not None:
                register(peer_id, self)
        # envelope trace refs of the tick's buffered deliveries: the
        # flush-apply span links back to the sender spans whose data
        # it merges (cross-peer correlation for the BATCHED paths; the
        # eager path nests directly under the adopted remote parent)
        self._deferred_links = []
        # admission control: `admission` is this link's own per-peer
        # controller (an AdmissionControl or its kwargs dict; ticked by
        # this connection), `shared_admission` the node-wide controller
        # shared across links (ticked once per quantum by its owner)
        if isinstance(admission, dict):
            admission = AdmissionControl(**admission)
        self.admission = admission
        self.shared_admission = shared_admission
        self.retry_limit = retry_limit
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.jitter = jitter
        self.heartbeat_every = heartbeat_every
        self._rng = random.Random(seed)
        self._now = 0
        self._send_seq = 0
        self._sent = {}                    # seq -> _Unacked
        self._recv_floor = 0               # every seq <= floor delivered
        # delivered seqs > floor. Compact while gaps are transient; a
        # PERMANENTLY lost seq (sender's budget exhausted, its content
        # re-advertised under a new seq by the heartbeat) pins the
        # floor, leaving the set O(messages since the loss) until the
        # session re-establishes — acceptable for session-scoped links
        self._recv_above = set()
        # replication-lag tracking: the peer's ACKED clocks — folded
        # only from what the peer itself confirmed (its clock adverts,
        # heartbeats, and the payload clock of every data envelope it
        # acked), never from this side's optimistic sends — so
        # `replication_lag()` measures what the peer has really durably
        # received, and the doc set's convergence watermark is the
        # minimum clock EVERY live peer has acked
        self._peer_acked = {}          # doc_id -> {actor: seq}
        # O(divergence) reconnect (wire v3): the doc set keeps one
        # wire-session record per peer id ({'acked': doc_id -> clock},
        # written live — _peer_acked IS the record's dict). A NEW
        # connection to a known peer over the SAME doc set resumes the
        # record: both clock maps of the inner connection seed from the
        # peer's acked clocks, so the first flush serves exactly the
        # clock-diffed divergence window (one v3 message under a fresh
        # table epoch) instead of a full-history re-advertise cycle.
        # resume=False (or a replaced doc set, whose registry is empty)
        # starts clean — the crash-recovery posture.
        if wire and peer_id is not None:
            sessions = getattr(doc_set, 'wire_sessions', None)
            if sessions is not None:
                rec = sessions.get(peer_id) if resume else None
                if rec is not None:
                    self._peer_acked = rec['acked']
                    adv = getattr(self._conn, '_adv_acked', None)
                    for doc_id, clock in self._peer_acked.items():
                        self._conn._their_clock[doc_id] = dict(clock)
                        self._conn._our_clock[doc_id] = dict(clock)
                        if adv is not None:
                            # the delta-clock baseline resumes with
                            # the session: the record's entries are
                            # all peer-confirmed, so the first warm
                            # adverts elide them too
                            adv[doc_id] = dict(clock)
                    self.metrics.bump('sync_wire_session_resumes')
                else:
                    sessions[peer_id] = {'acked': self._peer_acked}
                    self.metrics.bump('sync_wire_session_resets')
        # heartbeats advertise per-doc state digests when the doc set
        # maintains them (divergence audit); hb_digests=False pins the
        # v1 heartbeat shape
        self.hb_digests = hb_digests
        # membership state, driven by the transport failure detector
        # (set_link_state): 'up' | 'suspect' | 'down'. In-process links
        # have no detector and stay 'up' forever.
        self.link_state = 'up'

    # -- lifecycle -----------------------------------------------------------

    @property
    def connection(self):
        return self._conn

    def open(self):
        self._conn.open()

    def close(self, drop_scope=False):
        """Detach from the doc set's connection registry and close the
        inner connection. The link's ``peer/<id>/`` counter slice is
        KEPT by default (post-mortem reads); ``drop_scope=True``
        deletes it — the hook for long-lived processes whose peers
        churn under fresh ids, where dead slices would otherwise grow
        the registry without bound."""
        if self.peer_id is not None:
            unregister = getattr(self._doc_set,
                                 'unregister_connection', None)
            if unregister is not None:
                unregister(self.peer_id, self)
        if drop_scope:
            drop = getattr(self.metrics, 'drop', None)
            if drop is not None:
                drop()
        self._conn.close()

    def flush(self):
        """Batched flavor only: apply the tick's buffered data
        messages (see :meth:`BatchingConnection.flush
        <automerge_tpu_torch.sync.connection.BatchingConnection.flush>`)."""
        flush = getattr(self._conn, 'flush', None)
        if flush is None:
            return {}
        if self.metrics.active and self._deferred_links:
            # the flush-apply span LINKS to the sender spans of every
            # buffered envelope it merges — the batched half of the
            # cross-peer trace tree (fan-in: several senders' data can
            # land in one fused apply)
            links = self._deferred_links
            self._deferred_links = []
            with self.metrics.trace_span('sync.flush_deliver',
                                         links=links):
                return flush()
        self._deferred_links = []
        return flush()

    def set_link_state(self, state):
        """Membership hook — the transport failure detector drives
        this. ``'down'`` parks the retransmit loop and heartbeat
        (tick() freezes ``_sent`` instead of burning the retry budget
        against a provably dead peer); leaving ``'down'`` re-dues every
        parked envelope for the next quantum, because the backoff
        schedule accumulated against a dead link measures nothing about
        congestion on the healed one. ``'suspect'`` changes no
        behavior — retransmits and heartbeats keep probing."""
        prev = self.link_state
        if state == prev:
            return
        self.link_state = state
        if prev == 'down':
            for rec in self._sent.values():
                rec.due = min(rec.due, self._now + 1)

    # -- outbound ------------------------------------------------------------

    def _backoff(self, attempts):
        delay = min(self.backoff_base * (2 ** attempts),
                    self.backoff_max)
        return delay + (self._rng.randrange(self.jitter + 1)
                        if self.jitter else 0)

    def _send_envelope(self, msg):
        """The inner connection's send callback: wrap, remember for
        retransmission, ship. With an observer subscribed, the
        envelope carries the sender's current span in a compact
        ``trace`` field (``{'t': trace_id, 's': span_id}`` — the
        flush/send span this message was assembled under), folded
        into the envelope checksum like any header field; a receiver
        adopts it as the remote parent of its delivery spans, which
        is what stitches one tick's fan-out into a single
        reconstructable cross-peer tree. Idle observers ship exactly
        the old envelope shape, and retransmits re-ship the stored
        envelope bytes — the trace field never re-stamps."""
        self._send_seq += 1
        trace = None
        if self.metrics.active:
            current = self.metrics.current_trace()
            if current is not None:
                trace = {'t': current[0], 's': current[1]}
        env = {'v': ENVELOPE_VERSION if trace else BASE_VERSION,
               'kind': 'data', 'seq': self._send_seq, 'payload': msg}
        if trace is not None:
            env['trace'] = trace
        env['sum'] = envelope_checksum(msg, trace)
        self._sent[self._send_seq] = _Unacked(
            env, self._now + self._backoff(0))
        self._send_raw(env)

    def _send_ack(self, seq):
        # acks are integrity-checked too: a corrupted ack must not
        # cancel retransmission of a DIFFERENT live envelope
        self._send_raw({'v': BASE_VERSION, 'kind': 'ack',
                        'ack': seq, 'sum': payload_checksum(seq)})

    def _send_busy(self, seq, retry_after):
        """Admission denied: an EXPLICIT overload reply (not a silent
        drop) telling the sender when to retry — overload degrades to
        latency, and the sender's counters make the backpressure
        visible."""
        self.metrics.bump('sync_busy_sent')
        if self.metrics.active:
            self.metrics.emit('sync_busy', seq=seq,
                              retry_after=retry_after)
        self._send_raw({'v': BASE_VERSION, 'kind': 'busy',
                        'seq': seq, 'retry_after': retry_after,
                        'sum': payload_checksum([seq, retry_after])})

    def _bp_clear(self, rec):
        """An unacked envelope left the busy-deferred state (acked or
        dropped): keep the global depth gauge exact, and record how
        long it sat deferred (the ``sync_busy_wait_ms`` series —
        monotonic clock, like every duration here)."""
        if rec is not None and rec.backpressured:
            rec.backpressured = False
            self.metrics.bump('sync_backpressure_depth', -1)
            if rec.bp_since is not None:
                self.metrics.observe(
                    'sync_busy_wait_ms',
                    (time.perf_counter() - rec.bp_since) * 1e3)
                rec.bp_since = None

    @property
    def backpressure_depth(self):
        """Outbound envelopes currently deferred by the peer's busy
        replies."""
        return sum(1 for rec in self._sent.values()
                   if rec.backpressured)

    def _forget_delivery(self, payload):
        """A data envelope died permanently (retry budget exhausted):
        roll back the inner connection's OPTIMISTIC their-clock for
        the docs it carried. ``maybe_send_changes`` unions the local
        clock into ``_their_clock`` at send time (``_send_snapshot``
        does too), assuming delivery — without this rollback the
        peer's next advert/request would be answered with "nothing
        missing" and the gap could never heal through the normal
        protocol. Advertisements (``changes``/``snapshot`` both
        absent) carry no data, so their loss needs no rollback."""
        if not isinstance(payload, dict):
            return
        # wire v3: unpin the dead payload's session refs so table
        # eviction can reclaim them (its defs stay unconfirmed)
        hook = getattr(self._conn, 'note_wire_dead', None)
        if hook is not None:
            hook(payload)
        their = self._conn._their_clock
        if 'state' in payload and 'docs' in payload:
            # every span of a state-bootstrap message is data
            for doc_id in payload.get('docs') or ():
                their.pop(doc_id, None)
        elif 'wire' in payload:
            for doc_id, count in zip(payload.get('docs') or (),
                                     payload.get('counts') or ()):
                if count:
                    their.pop(doc_id, None)
        elif 'docId' in payload and (
                payload.get('changes') is not None or
                payload.get('snapshot') is not None or
                payload.get('state') is not None):
            their.pop(payload['docId'], None)

    # -- replication lag / convergence ---------------------------------------

    def _fold_acked(self, payload):
        """Fold the clocks ``payload`` proves the peer holds into the
        acked map and notify the doc set (its convergence watermark
        and the ``sync_convergence_ms`` series advance on exactly
        these events). Called for clocks the peer ADVERTISED (its data
        messages and heartbeats) and for the payload clock of every
        data envelope the peer acked. An ack counts as received even
        if the apply later quarantines — quarantine is loudly visible
        through its own counters, and the peer's next heartbeat keeps
        this map truthful upward."""
        if not isinstance(payload, dict):
            return
        docs = []
        if 'wire' in payload or ('state' in payload
                                 and 'docs' in payload):
            for doc_id, clock in zip(payload.get('docs') or (),
                                     payload.get('clocks') or ()):
                if isinstance(doc_id, str) and isinstance(clock, dict):
                    clock_union(self._peer_acked, doc_id, clock)
                    docs.append(doc_id)
        else:
            doc_id = payload.get('docId')
            clock = payload.get('clock')
            if isinstance(doc_id, str) and isinstance(clock, dict):
                clock_union(self._peer_acked, doc_id, clock)
                docs.append(doc_id)
        if docs:
            self._note_acked(docs)

    def _note_acked(self, doc_ids):
        note = getattr(self._doc_set, 'note_peer_ack', None)
        if note is not None:
            note(doc_ids)

    def acked_clock(self, doc_id):
        """The highest clock the peer has confirmed for ``doc_id``
        (empty when it never mentioned the doc)."""
        return self._peer_acked.get(doc_id, {})

    def replication_lag(self, clocks=None):
        """``(lag_ops, lagging_docs)`` of this link: the change seqs
        the peer has not acked across the fleet, and the docs where it
        is behind — derived entirely from the clocks both ends already
        exchange (Okapi's cheap causal metadata, PAPERS.md). ``clocks``
        lets the heartbeat share its one fleet clock sweep."""
        if clocks is None:
            clocks = self._local_clocks()
        lag = 0
        lagging = 0
        for doc_id, clock in clocks.items():
            acked = self._peer_acked.get(doc_id)
            if acked:
                d = sum(s - a for s, a in
                        ((s, acked.get(actor, 0))
                         for actor, s in clock.items()) if s > a)
            else:
                d = sum(clock.values())
            if d:
                lag += d
                lagging += 1
        return lag, lagging

    # -- inbound -------------------------------------------------------------

    def _reject(self, reason):
        self.metrics.bump('sync_msgs_rejected')
        if self.metrics.active:
            self.metrics.emit('envelope_rejected', reason=reason)
        return None

    def _seen(self, seq):
        return seq <= self._recv_floor or seq in self._recv_above

    def _mark_seen(self, seq):
        self._recv_above.add(seq)
        while self._recv_floor + 1 in self._recv_above:
            self._recv_floor += 1
            self._recv_above.discard(self._recv_floor)

    def receive_msg(self, env):
        """Take one envelope off the transport. Malformed or corrupt
        envelopes are counted and swallowed (a hostile packet must
        never kill the sync loop); valid duplicates re-ack and drop;
        fresh data delivers to the inner protocol. Returns whatever
        the inner ``receive_msg`` returned (None otherwise)."""
        if not isinstance(env, dict):
            return self._reject(
                f'envelope is {type(env).__name__}, not a dict')
        if env.get('v') not in ACCEPTED_VERSIONS:
            return self._reject(
                f'unsupported envelope version {env.get("v")!r}')
        kind = env.get('kind')
        if kind == 'ack':
            seq = env.get('ack')
            if not isinstance(seq, int) or isinstance(seq, bool):
                return self._reject(f'ack seq is not an int: {seq!r}')
            if env.get('sum') != payload_checksum(seq):
                self.metrics.bump('sync_checksum_failures')
                return self._reject(f'ack checksum mismatch '
                                    f'(ack {seq})')
            rec = self._sent.pop(seq, None)
            self._bp_clear(rec)
            if rec is not None:
                # the peer confirmed this envelope: the payload clock
                # it carried is now ACKED — the lag/convergence signal
                payload = rec.envelope.get('payload')
                self._fold_acked(payload)
                # wire v3: the session-table defs this payload carried
                # are now peer-confirmed (bare refs from here on)
                hook = getattr(self._conn, 'note_wire_acked', None)
                if hook is not None:
                    hook(payload)
            return None
        if kind == 'busy':
            return self._receive_busy(env)
        if kind == 'hb':
            return self._receive_heartbeat(env)
        if kind != 'data':
            return self._reject(f'unknown envelope kind {kind!r}')
        seq = env.get('seq')
        if not isinstance(seq, int) or isinstance(seq, bool) or seq <= 0:
            return self._reject(f'data seq is not a positive int: '
                                f'{seq!r}')
        payload = env.get('payload')
        if not isinstance(payload, dict):
            return self._reject('data envelope has no payload dict')
        # the optional trace field is covered by the checksum exactly
        # like the payload: absent (an old/idle-observer envelope) the
        # sum degrades to the plain payload checksum, malformed or
        # bit-flipped it fails the sum and the envelope drops unacked
        trace = env.get('trace')
        if trace is not None and not _valid_trace(trace):
            return self._reject(f'data trace field malformed: '
                                f'{trace!r}')
        if env.get('sum') != envelope_checksum(payload, trace):
            # NOT acked: the sender's retransmit re-delivers intact
            self.metrics.bump('sync_checksum_failures')
            return self._reject(f'payload checksum mismatch (seq '
                                f'{seq})')
        # the clocks an integrity-checked data payload advertises are
        # the peer's own state — fold them into the acked map
        # (duplicates carry the same clocks; the union is idempotent)
        self._fold_acked(payload)
        if self._seen(seq):
            self._send_ack(seq)            # the first ack may be lost
            self.metrics.bump('sync_msgs_duplicate')
            return None
        # admission control: meter fresh data payloads AFTER integrity
        # and duplicate checks (a dup was already paid for) and BEFORE
        # any delivery/buffering. Denial replies busy with a
        # retry-after hint and neither acks nor consumes the seq — the
        # sender redelivers once the valve reopens, or its exhausted
        # budget falls through to the anti-entropy heartbeat.
        ctrls = [c for c in (self.admission, self.shared_admission)
                 if c is not None]
        if ctrls:
            n_changes, n_bytes = _payload_cost(payload)
            if n_changes or n_bytes:
                retry = max(c.check(n_changes, n_bytes)
                            for c in ctrls)
                if retry:
                    self._send_busy(seq, retry)
                    return None
                for c in ctrls:
                    c.charge(n_changes, n_bytes)
        # deliver FIRST, ack on the outcome: an acked seq is consumed
        # forever (dup-suppressed on redelivery), so acking before a
        # failed apply would lose the message at the envelope layer.
        # NOTE: in batching mode "delivered" means BUFFERED — the
        # apply happens at flush(), where a fault lands in the
        # quarantine registry WITH its changes (retried until they
        # really apply), so flush-time failures are repaired at the
        # quarantine layer, not by envelope retransmit
        try:
            out = self._deliver(env, payload, trace)
        except MessageRejected:
            # schema-invalid at ORIGIN (checksum passed): retransmits
            # cannot fix it, so ack + consume the seq; counted by the
            # inner validation, and the loop lives on
            self._send_ack(seq)
            self._mark_seen(seq)
            return None
        except Exception as err:
            # apply-time failure (poisoned eager apply, transient
            # engine error): NOT acked, NOT marked seen — the sender's
            # retransmit redelivers and a transient cause heals; a
            # permanent one exhausts the budget and falls to the
            # anti-entropy loop. Either way the sync loop survives.
            self.metrics.bump('sync_apply_failures')
            if self.metrics.active:
                self.metrics.emit('sync_apply_failure', seq=seq,
                                  error=repr(err))
            return None
        self._send_ack(seq)
        self._mark_seen(seq)
        return out

    def _deliver(self, env, payload, trace):
        """Hand one fresh, integrity-checked data payload to the inner
        protocol, under the sender's trace context when one rode the
        envelope: the eager path's apply spans nest directly beneath
        the remote parent; the batched paths buffer, so the (trace,
        span) ref is remembered and LINKED from the tick's flush span
        (:meth:`flush`). No observer, no overhead: straight
        delivery."""
        if not self.metrics.active or trace is None:
            return self._conn.receive_msg(payload)
        ref = (trace['t'], trace['s'])
        before = self._buffered_depth()
        with self.metrics.trace_context(*ref):
            with self.metrics.trace_span('envelope.recv',
                                         seq=env.get('seq')):
                out = self._conn.receive_msg(payload)
        # link only what the flush will actually merge: a rejected or
        # failed payload contributes nothing (the exception skips
        # this), and an eagerly-handled one (snapshot, clock-only
        # advertisement) already traced under envelope.recv — only a
        # delivery that grew the inner buffers rides the tick's
        # flush-deliver links
        if self._buffered_depth() > before:
            self._deferred_links.append(ref)
        return out

    def _buffered_depth(self):
        """How many messages the inner connection is holding for its
        next flush (0 for the eager flavor, which buffers nothing)."""
        conn = self._conn
        return (len(getattr(conn, '_incoming', ())) +
                len(getattr(conn, '_incoming_wire', ())) +
                len(getattr(conn, '_incoming_state', ())))

    def _receive_busy(self, env):
        """The peer's admission valve deferred our data envelope:
        reschedule it for the hinted tick. A busy reply consumes a
        retry attempt — a peer that stays overloaded past the budget
        exhausts exactly like a dead link (counted separately under
        ``sync_retry_exhausted_backpressure``), and the heartbeat's
        re-advertisement regenerates the data once admission
        reopens."""
        seq = env.get('seq')
        retry_after = env.get('retry_after')
        if not isinstance(seq, int) or isinstance(seq, bool) or \
                not isinstance(retry_after, int) or \
                isinstance(retry_after, bool) or retry_after < 0:
            return self._reject(f'busy seq/retry_after malformed: '
                                f'{seq!r}/{retry_after!r}')
        if env.get('sum') != payload_checksum([seq, retry_after]):
            self.metrics.bump('sync_checksum_failures')
            return self._reject(f'busy checksum mismatch (seq {seq})')
        rec = self._sent.get(seq)
        if rec is None:
            return None                # already acked/dropped
        self.metrics.bump('sync_busy_received')
        rec.attempts += 1
        if rec.attempts >= self.retry_limit:
            del self._sent[seq]
            self._bp_clear(rec)
            self.metrics.bump('sync_retry_exhausted')
            self.metrics.bump('sync_retry_exhausted_backpressure')
            self._forget_delivery(rec.envelope.get('payload'))
            # same event the timeout path emits: a flight-recorder
            # incident must show backpressure-driven exhaustion too
            if self.metrics.active:
                self.metrics.emit('sync_retry_exhausted', seq=seq)
            return None
        if not rec.backpressured:
            rec.backpressured = True
            rec.bp_since = time.perf_counter()
            self.metrics.bump('sync_backpressure_depth')
        # the hint is clamped to the backoff ceiling: a hard-shut (or
        # hostile) peer advertising an enormous retry-after must not
        # park the envelope forever — bounded re-attempts keep burning
        # the budget, which is what lets sustained backpressure
        # exhaust and fall through to the anti-entropy repair
        rec.due = self._now + \
            min(max(retry_after, 1), self.backoff_max) + \
            (self._rng.randrange(self.jitter + 1) if self.jitter
             else 0)
        return None

    def _receive_heartbeat(self, env):
        clocks = env.get('clocks')
        if not isinstance(clocks, dict):
            return self._reject('heartbeat has no clocks dict')
        if env.get('sum') != payload_checksum(clocks):
            self.metrics.bump('sync_checksum_failures')
            return self._reject('heartbeat checksum mismatch')
        # the optional digest map is advisory: malformed or
        # dsum-mismatched digests drop ONLY the audit for this beat
        # (counted; the next beat repeats them) — the clocks above
        # already verified and still heal normally
        digests = env.get('digests')
        if digests is not None and (
                not _valid_digests(digests) or
                env.get('dsum') != digest_checksum(digests,
                                                   env['sum'])):
            self.metrics.bump('sync_checksum_failures')
            digests = None
        self.metrics.bump('sync_heartbeats_received')
        doc_set = self._conn._doc_set
        # a heartbeat is the peer's authoritative state advert: every
        # clock it carries is ACKED (the lag/convergence signal).
        # REGRESSION heal first: an advertised clock strictly BELOW
        # the recorded acked clock means the peer lost state (a crash
        # restart without the session record — a resumed session can
        # only advance). The recorded floor is a lie now: reset both
        # the acked record and the serve-side their-clock DOWN to what
        # the peer actually advertises and mark the doc pending, so
        # the next flush re-serves the lost tail. Gate on an EMPTY
        # unacked map: while envelopes are in flight (including
        # busy-deferred redeliveries) an advert legitimately trails
        # the acked floor — in batching mode an ack means BUFFERED,
        # and a causal gap parks later changes until the missing
        # envelope redelivers. Only when the retransmit layer has
        # nothing outstanding is a persisting regression proof of
        # lost peer state rather than repair still in progress.
        for doc_id, clock in clocks.items():
            if not isinstance(clock, dict):
                continue
            acked = self._peer_acked.get(doc_id)
            if acked and not self._sent \
                    and any(clock.get(a, 0) < s
                            for a, s in acked.items()):
                self._peer_acked[doc_id] = dict(clock)
                self._conn._their_clock[doc_id] = dict(clock)
                # the delta-clock baseline must regress with the acked
                # record, or the next advert would elide entries the
                # peer no longer has (connection.py note_clock_regressed)
                regressed = getattr(self._conn,
                                    'note_clock_regressed', None)
                if regressed is not None:
                    regressed(doc_id, clock)
                self._conn.maybe_send_changes(doc_id)
            clock_union(self._peer_acked, doc_id, clock)
        self._note_acked(list(clocks))
        if digests:
            self._audit_digests(clocks, digests)
        # membership only: get_doc would mint (and cache) a handle per
        # advertised doc, ~fleet-size allocations per beat on general/
        # serving doc sets
        id_of = getattr(doc_set, 'id_of', None)
        known = (lambda d: d in id_of) if id_of is not None \
            else (lambda d: doc_set.get_doc(d) is not None)
        for doc_id, clock in clocks.items():
            if clock and not known(doc_id):
                # the beat re-opens the one-shot request suppression:
                # we requested this doc once but the data never landed
                # (e.g. the sender's budget exhausted against our own
                # busy valve) — re-request, bounded by the beat period
                if doc_id in self._conn._our_clock and \
                        self.metrics.active:
                    self.metrics.emit('heartbeat_heal', doc_id=doc_id)
                self._conn._our_clock.pop(doc_id, None)
            try:
                # a heartbeat entry IS an advertisement: the normal
                # protocol answers it (request / data / nothing)
                self._conn.receive_msg({'docId': doc_id,
                                        'clock': clock})
            except MessageRejected:
                pass
        return None

    def _audit_digests(self, clocks, digests):
        """The divergence audit: a doc whose advertised clock EQUALS
        the local clock holds — by the CRDT convergence contract —
        byte-identical state, so its state digests must match too.
        Equal clocks with unequal digests is silent divergence (an
        out-of-band mutation, an evil-twin change, bit rot below the
        checksums): bump ``sync_divergence_detected``, record it on
        the doc set's ``diverged`` registry (which dumps a flight-
        recorder incident on serving stacks) and quarantine NEITHER
        side — the digest says the replicas disagree, not which one is
        right. Report, don't guess. Docs whose clocks differ are just
        lag (the normal protocol is still converging them) and are
        never compared."""
        doc_set = self._doc_set
        digest_of = getattr(doc_set, 'digest_of_id', None)
        clock_of = getattr(doc_set, 'clock_of_id', None)
        if digest_of is None or clock_of is None:
            return
        for doc_id, remote in digests.items():
            clock = clocks.get(doc_id)
            if not isinstance(clock, dict) or clock != clock_of(doc_id):
                continue               # lag, not divergence
            local = digest_of(doc_id)
            if local is None or local == remote:
                continue
            note = getattr(doc_set, 'note_divergence', None)
            fresh = note(doc_id, peer=self.peer_id,
                         local_digest=local, remote_digest=remote,
                         clock=dict(clock)) if note is not None \
                else True
            if fresh:
                self.metrics.bump('sync_divergence_detected')
                if self.metrics.active:
                    self.metrics.emit('sync_divergence',
                                      doc_id=doc_id,
                                      local_digest=local,
                                      remote_digest=remote)

    # -- logical time --------------------------------------------------------

    def tick(self):
        """Advance one scheduling quantum: retransmit overdue unacked
        envelopes (exponential backoff + jitter, bounded budget) and
        emit the periodic anti-entropy heartbeat."""
        self._now += 1
        if self.admission is not None:
            self.admission.tick()      # shared controllers are ticked
            #                            once per quantum by their owner
        if self.link_state == 'down':
            # membership park: the failure detector declared this peer
            # dead, so burning the retry budget would only exhaust
            # every in-flight envelope — rolling back its optimistic
            # clocks and re-requesting via heartbeat once the peer
            # heals, for nothing. Park instead: ``_sent`` keeps its
            # contents and attempt counts frozen, the heartbeat stays
            # quiet (no point beating a dead link), and
            # set_link_state('up') re-dues everything immediately.
            if self._sent:
                self.metrics.bump('membership_retries_parked')
            return
        # seqs are minted monotonically and entries only deleted, so
        # dict order IS ascending seq order — no re-sort per quantum
        for seq in list(self._sent):
            rec = self._sent.get(seq)
            if rec is None or rec.due > self._now:
                continue
            if rec.attempts >= self.retry_limit:
                # budget exhausted: stop retransmitting — the
                # heartbeat's re-advertisement regenerates whatever
                # this envelope carried once the link heals
                del self._sent[seq]
                self.metrics.bump('sync_retry_exhausted')
                if rec.backpressured:
                    self.metrics.bump(
                        'sync_retry_exhausted_backpressure')
                self._bp_clear(rec)
                self._forget_delivery(rec.envelope.get('payload'))
                if self.metrics.active:
                    self.metrics.emit('sync_retry_exhausted',
                                      seq=seq)
                continue
            rec.attempts += 1
            rec.due = self._now + self._backoff(rec.attempts)
            self.metrics.bump('sync_retransmits')
            payload = rec.envelope.get('payload')
            if isinstance(payload, dict) and \
                    isinstance(payload.get('blob'), (bytes, bytearray)):
                # wire blobs retransmit as the SAME cached bytes the
                # encode cache served the first time — this counter is
                # the degraded-link bench's "bytes re-served with zero
                # re-encode" figure
                n = len(payload['blob'])
                tab = payload.get('tab')
                if isinstance(tab, (bytes, bytearray)):
                    n += len(tab)
                self.metrics.bump('sync_retransmit_wire_bytes', n)
            if self.metrics.active:
                self.metrics.emit('sync_retransmit', seq=seq,
                                  attempt=rec.attempts)
            self._send_raw(rec.envelope)
        if self.heartbeat_every and \
                self._now % self.heartbeat_every == 0:
            self.heartbeat()

    def _local_clocks(self):
        """Every local doc's truthful clock in one pass — what the
        heartbeat advertises and what the lag derivation compares the
        acked map against."""
        from .. import frontend as Frontend
        clocks = {}
        hb = getattr(self._doc_set, 'heartbeat_clocks', None)
        store = getattr(self._doc_set, 'store', None)
        if hb is not None:
            # serving doc sets advertise evicted docs' RECORDED clocks
            # without faulting anything in — a heartbeat must never
            # thrash the residency cache
            clocks = hb()
        elif store is not None and hasattr(store, 'clocks_all') and \
                hasattr(self._doc_set, 'ids'):
            # bulk stores: every clock in ONE pass over the clock rows
            # (per-doc clock_of would pay a searchsorted per document,
            # per heartbeat, per peer — O(fleet log) each beat)
            by_idx = store.clocks_all()
            for i, doc_id in enumerate(self._doc_set.ids):
                clocks[doc_id] = dict(by_idx.get(i, {}))
        else:
            for doc_id in self._doc_set.doc_ids:
                doc = self._doc_set.get_doc(doc_id)
                if doc is None:
                    continue
                state = Frontend.get_backend_state(doc)
                if state is None:
                    continue
                clocks[doc_id] = dict(state.clock)
        return clocks

    def heartbeat(self):
        """Re-advertise every local doc's current clock in one
        unreliable envelope (loss is fine: the next beat repeats it).
        This is the Demers-style anti-entropy loop that makes
        convergence eventual even when retransmit budgets run out.

        The beat also refreshes this link's replication-lag gauges
        (local clocks vs the peer's acked map — one sweep the clock
        collection already paid for) and, when the doc set maintains
        per-doc state digests, attaches them for the divergence audit.
        A digested heartbeat stamps v=2 with the digests under their
        own seeded ``dsum`` (the main ``sum`` stays the plain clocks
        checksum, so even a digest-unaware v2 receiver heals from it);
        an undigested one is byte-identical to the v1 protocol — mixed
        fleets interoperate unchanged in both directions."""
        clocks = self._local_clocks()
        if not clocks:
            return
        # per-link lag gauges ride the beat: the scoped write lands
        # both process-wide and under peer/<id>/, and fleet_status()
        # health reads the per-link slices
        lag, lagging = self.replication_lag(clocks)
        self.metrics.set_gauge('sync_replication_lag_ops', lag)
        self.metrics.set_gauge('sync_lagging_docs', lagging)
        digests = None
        if self.hb_digests:
            hb_dig = getattr(self._doc_set, 'heartbeat_digests', None)
            if hb_dig is not None:
                digests = hb_dig() or None
        self.metrics.bump('sync_heartbeats_sent')
        env = {'v': ENVELOPE_VERSION if digests else BASE_VERSION,
               'kind': 'hb', 'sum': payload_checksum(clocks),
               'clocks': clocks}
        if digests is not None:
            env['digests'] = digests
            env['dsum'] = digest_checksum(digests, env['sum'])
        self._send_raw(env)

    @property
    def in_flight(self):
        """Unacked outbound envelopes (retransmission candidates)."""
        return len(self._sent)

    # -- operator surface ----------------------------------------------------

    def connection_status(self, scoped=None):
        """This link's slice of the operator surface (what a doc set's
        ``fleet_status()`` reports per CONNECTION instead of only via
        process-wide counters): live protocol state plus — when the
        link is peer-scoped — the peer's own counter slice
        (``peer/<id>/``). Admission debt is the negative token balance
        the debt buckets are currently paying off (0 = open valve).
        ``scoped`` lets a caller polling MANY links (fleet_status)
        hand in this link's pre-bucketed counter slice from one
        registry pass instead of paying a full-registry scan per
        connection."""
        if scoped is None:
            scoped = self.metrics.group() \
                if self.peer_id is not None else {}

        def debt_of(ctrl):
            if ctrl is None:
                return None
            out = {}
            for label, bucket in (('changes', ctrl.change_bucket),
                                  ('bytes', ctrl.byte_bucket)):
                if bucket is not None:
                    out[label] = max(0, -bucket.tokens)
            return out

        # per-link wire surface: negotiated format version (min of both
        # ends' maxv, 0 on non-wire links) and the v3 session-table
        # pressure — what an operator reads to see which links talk v3
        # and how big their tables run
        wire_version = 0
        table_entries = table_bytes = 0
        ours = getattr(self._conn, 'wire_version', None)
        if ours is not None:
            wire_version = min(ours,
                               self._conn._peer_wire_version)
            table = getattr(self._conn, '_tx_table', None)
            if table is not None:
                table_entries = len(table)
                table_bytes = table.bytes
        return {
            'peer': self.peer_id,
            'state': self.link_state,
            'wire_version': wire_version,
            'table_entries': table_entries,
            'table_bytes': table_bytes,
            'in_flight': len(self._sent),
            'backpressure_depth': self.backpressure_depth,
            'busy_sent': scoped.get('sync_busy_sent', 0),
            'busy_received': scoped.get('sync_busy_received', 0),
            'retransmits': scoped.get('sync_retransmits', 0),
            'retry_exhausted': scoped.get('sync_retry_exhausted', 0),
            # lag gauges refresh on each heartbeat (stale by at most
            # one beat period); acked_docs is live
            'replication_lag_ops':
                scoped.get('sync_replication_lag_ops', 0),
            'lagging_docs': scoped.get('sync_lagging_docs', 0),
            'acked_docs': len(self._peer_acked),
            'msgs_sent': scoped.get('sync_msgs_sent', 0),
            'msgs_received': scoped.get('sync_msgs_received', 0),
            'flow_backlog_docs':
                len(getattr(self._conn, '_pending_send', ()) or ()),
            'flow_deferred_docs':
                scoped.get('sync_flow_deferred_docs', 0),
            'admission_debt': debt_of(self.admission),
            'shared_admission_debt': debt_of(self.shared_admission),
        }

    connectionStatus = connection_status

    # camelCase aliases (reference API style)
    receiveMsg = receive_msg
