"""Real-socket transport for the resilient envelope protocol.

Everything below PR 19 simulated links in-process: envelopes were
handed between Python objects and every injected fault was a list
manipulation. This module is the asyncio TCP binding that turns the
fleet into a server:

* a length-prefixed, CRC-framed stream codec (:func:`encode_frame` /
  :class:`FrameDecoder`) — torn tails and short reads buffer, corrupt
  frames (bad magic, bit-flipped length prefixes, CRC mismatches)
  raise a COUNTED :class:`FrameError` that resets the stream, never a
  crash and never a quarantine (the envelope layer's checksums and
  retransmits repair whatever the reset dropped). The codec is
  zero-copy on both directions: :func:`encode_frame_iov` emits an
  iovec (header struct + JSON head + the payload's byte fields,
  spliced without re-copies, CRC folded across the parts) that the
  write loop drains with ONE ``writelines`` per batch, and
  :class:`FrameDecoder` parses head/body as :class:`memoryview`
  slices over a compacting ring buffer, so a received frame is never
  copied before its CRC check;

* :class:`TransportEndpoint` — server + client in one object, with
  **session multiplexing**: ONE socket per peer pair carries every
  hosted doc set and every logical channel (data / ack / busy /
  heartbeat / state / control) instead of the in-process fleets'
  one-link-per-pair-per-docset full mesh. A HELLO handshake carries a
  process epoch: a re-dial with the SAME epoch is a transparent
  reconnect (the existing :class:`~.resilient.ResilientConnection`
  objects — and their wire-v3 session string tables — survive
  untouched); a CHANGED epoch means the peer restarted, so both sides
  rebuild their links through the wire-session ``resume=True`` path
  and the first flush serves only the divergence window;

* an **eager fast path** (``eager=True``, the default) — staging an
  envelope kicks the peer link's flusher immediately instead of
  waiting for the next :meth:`~TransportEndpoint.tick`, with an
  adaptive micro-coalescing window: the flusher task is scheduled for
  the NEXT event-loop turn, so every envelope staged in the current
  synchronous burst rides one flush/one ``writelines``, and kicks
  that arrive while a drain is in flight coalesce into the drain's
  next batch (``transport_coalesced_batches``). ``tick()`` keeps
  ownership of heartbeats, keepalives, re-dial backoff and the
  failure detector ONLY — on an idle link the staged→socket latency
  is the syscall floor, not the tick quantum. ``eager=False`` keeps
  the tick-quantized path alive as the bench A/B baseline. Liveness
  frames (HELLO, keepalive pings, ``busy`` backpressure replies)
  bypass the data queue — front-of-queue, flushed on the next wakeup
  even mid-window — so micro-batching can never delay failure
  detection;

* a **liveness/membership layer** — a heartbeat-deadline failure
  detector in logical-tick units (configurable ``suspect_after`` /
  ``dead_after``, with the deadline extended by the current re-dial
  backoff so a link mid-recovery is not declared dead by its own
  backoff schedule). Peer state (``up``/``suspect``/``down``) feeds
  each link's :meth:`~.resilient.ResilientConnection.set_link_state`
  (a down peer PARKS retransmits instead of burning the retry
  budget), the doc sets' ``note_peer_down``/``note_peer_up`` hooks
  (the ``membership`` health signal; pending convergence births park)
  and — on serving stacks — a ``peer_down`` flight-recorder incident.
  Writes keep applying locally throughout; outgoing frames queue in a
  BOUNDED per-peer deque with oldest-advert collapse, so a dead peer
  degrades the fleet instead of growing it without bound.

Frame layout (all integers big-endian)::

    magic   2  b'AT'
    channel 1  0=data 1=ack 2=busy 3=hb 4=state 5=ctl
    hlen    4  header length
    blen    4  body length
    crc     4  CRC32 over header + body
    header  hlen  JSON: {'d': docset, 'e': envelope, 'b': [[f,n],..]}
    body    blen  the envelope payload's binary fields, concatenated

The header's envelope is the resilient envelope minus its binary
payload fields (``blob``/``tab``/``state`` bytes), which ship raw in
the body — JSON never base64s a wire blob. Control frames carry
``{'ctl': {...}}`` headers and no doc set.

The PyTorch port's copy of ``automerge_tpu/sync/transport.py``: the
same frames byte for byte, so a reference peer and a port peer talk.
"""

import asyncio
import itertools
import json
import struct
import weakref
import zlib
from collections import deque

from ..utils.metrics import metrics
from .connection import MessageRejected
from .resilient import ResilientConnection

FRAME_MAGIC = b'AT'
_HEADER = struct.Struct('>2sBIII')
# hard ceiling on a single frame's header+body: anything larger is a
# corrupt (bit-flipped) length prefix, not a real message — the codec
# must reject it instead of buffering gigabytes waiting for a frame
# that will never complete
MAX_FRAME_BYTES = 64 * 1024 * 1024
CHANNELS = {'data': 0, 'ack': 1, 'busy': 2, 'hb': 3, 'state': 4,
            'ctl': 5}
CHANNEL_NAMES = {v: k for k, v in CHANNELS.items()}

# ring-buffer compaction threshold: consumed bytes at the front of
# the decode buffer are reclaimed once they pass this, so steady-state
# decoding never memmoves per frame and the buffer never grows
# unboundedly either
COMPACT_AT = 64 * 1024

# a dial that neither connects nor fails within this long is abandoned
# and retried on the backoff schedule: a connect whose socket event is
# lost would otherwise hold the link in ``dialing`` for good
DIAL_TIMEOUT_S = 2.0

# process-wide endpoint epoch mint: a TransportEndpoint stamps its
# epoch into every HELLO, so the far side can tell a transparent TCP
# reconnect (same epoch — keep the live connections and their session
# tables) from a process restart (new epoch — rebuild through the
# wire-session resume path)
_EPOCH_COUNTER = itertools.count(1)


class FrameError(ValueError):
    """A frame failed to decode (bad magic, out-of-bounds length,
    CRC mismatch, malformed header). The stream is unrecoverable past
    this point — the caller closes the socket and re-dials; counted
    under ``transport_frame_errors``."""


def _channel_of(env):
    kind = env.get('kind')
    if kind == 'data':
        payload = env.get('payload')
        if isinstance(payload, dict) and 'state' in payload \
                and 'docs' in payload:
            return CHANNELS['state']
        return CHANNELS['data']
    return CHANNELS.get(kind, CHANNELS['data'])


def encode_frame_iov(dset, env):
    """One envelope -> ``(channel, parts, nbytes)``: the frame as an
    iovec of byte chunks ready for ``writer.writelines``, never
    joined. Binary payload fields (wire blobs, session tabs, state
    snapshots) are lifted out of the JSON header and spliced into the
    iovec AS-IS — an immutable ``bytes`` blob ships without a single
    copy; mutable buffers (``bytearray``/``memoryview``) are
    snapshotted once, because the frame may sit in a send queue after
    the caller reuses its buffer. The CRC folds across the parts."""
    payload = env.get('payload')
    # classify BEFORE the binary fields lift out — a state snapshot
    # is recognized by its (bytes-valued) 'state' payload field
    channel = _channel_of(env)
    binfields = []
    body_parts = []
    if isinstance(payload, dict):
        names = sorted(f for f, v in payload.items()
                       if isinstance(v, (bytes, bytearray, memoryview)))
        if names:
            head_payload = {k: v for k, v in payload.items()
                            if k not in names}
            for f in names:
                part = payload[f]
                if not isinstance(part, bytes):
                    part = bytes(part)
                binfields.append([f, len(part)])
                body_parts.append(part)
            env = {**env, 'payload': head_payload}
    head = {'d': dset, 'e': env}
    if binfields:
        head['b'] = binfields
    head_bytes = json.dumps(head, separators=(',', ':')).encode('utf-8')
    crc = zlib.crc32(head_bytes)
    blen = 0
    for part in body_parts:
        crc = zlib.crc32(part, crc)
        blen += len(part)
    parts = [_HEADER.pack(FRAME_MAGIC, channel, len(head_bytes),
                          blen, crc), head_bytes]
    parts.extend(body_parts)
    return channel, parts, _HEADER.size + len(head_bytes) + blen


def encode_frame(dset, env):
    """One envelope -> one CRC-framed byte string (the joined form of
    :func:`encode_frame_iov` — tests and tools that index into the
    frame use this; the hot path ships the iovec unjoined)."""
    _channel, parts, _n = encode_frame_iov(dset, env)
    return b''.join(parts)


def encode_ctl_frame(ctl):
    """A transport-control frame (HELLO): no doc set, no envelope."""
    head_bytes = json.dumps({'ctl': ctl},
                            separators=(',', ':')).encode('utf-8')
    crc = zlib.crc32(head_bytes)
    return _HEADER.pack(FRAME_MAGIC, CHANNELS['ctl'],
                        len(head_bytes), 0, crc) + head_bytes


class FrameDecoder:
    """Incremental stream decoder. :meth:`feed` buffers arbitrary
    chunk boundaries (interleaved partial reads are the NORMAL case
    on TCP) and yields every complete frame; a frame that cannot be
    valid — wrong magic, a length prefix past :attr:`max_frame_bytes`,
    a CRC mismatch, an unparseable header — raises :class:`FrameError`
    after bumping ``transport_frame_errors``. :meth:`eof` accounts a
    torn tail (connection died mid-frame) under
    ``transport_partial_frames`` and discards it unparsed.

    Internally a compacting ring buffer: frames are parsed through
    :class:`memoryview` slices over the receive buffer — header
    fields via ``unpack_from``, the CRC check and the JSON parse
    straight off the views — so no byte of a frame is copied before
    its CRC verifies. Consumed bytes accumulate at the front
    (``_pos``) and are reclaimed in one ``del`` once they pass
    ``compact_at`` (or the buffer empties), amortizing compaction to
    O(1) per byte instead of a memmove per frame."""

    def __init__(self, max_frame_bytes=MAX_FRAME_BYTES, scope=None,
                 compact_at=COMPACT_AT):
        self.max_frame_bytes = max_frame_bytes
        self.metrics = scope if scope is not None else metrics
        self.compact_at = compact_at
        self._buf = bytearray()
        self._pos = 0

    def _error(self, reason):
        self.metrics.bump('transport_frame_errors')
        # reassign rather than clear: feed() may hold live memoryviews
        # over the old buffer (a resize would raise BufferError); the
        # old bytearray is dropped when the last view releases
        self._buf = bytearray()
        self._pos = 0
        raise FrameError(reason)

    def feed(self, data):
        """Returns ``[(kind, docset, obj), ...]`` for every frame
        completed by ``data``: ``('env', dset, envelope)`` or
        ``('ctl', None, ctl_dict)``."""
        self._buf += data
        buf = self._buf
        pos = self._pos
        end = len(buf)
        out = []
        mv = memoryview(buf)
        head = body = None
        try:
            while end - pos >= _HEADER.size:
                magic, _chan, hlen, blen, crc = \
                    _HEADER.unpack_from(buf, pos)
                if magic != FRAME_MAGIC:
                    self._error('bad frame magic')
                if hlen == 0 or hlen + blen > self.max_frame_bytes:
                    self._error(
                        'frame length out of bounds (corrupt prefix)')
                total = _HEADER.size + hlen + blen
                if end - pos < total:
                    break                # torn tail: wait for more
                hstart = pos + _HEADER.size
                head = mv[hstart:hstart + hlen]
                body = mv[hstart + hlen:pos + total]
                if zlib.crc32(body, zlib.crc32(head)) != crc:
                    self._error('frame crc mismatch')
                pos += total
                try:
                    obj = json.loads(str(head, 'utf-8'))
                except (UnicodeDecodeError, ValueError):
                    self._error('frame header is not valid json')
                if not isinstance(obj, dict):
                    self._error('frame header is not an object')
                ctl = obj.get('ctl')
                if ctl is not None:
                    if not isinstance(ctl, dict):
                        self._error('ctl frame is not an object')
                    self.metrics.bump('transport_frames_received')
                    out.append(('ctl', None, ctl))
                    continue
                dset = obj.get('d')
                env = obj.get('e')
                if not isinstance(dset, str) \
                        or not isinstance(env, dict):
                    self._error('frame header missing docset/envelope')
                binfields = obj.get('b')
                if binfields:
                    payload = env.get('payload')
                    if not isinstance(payload, dict) \
                            or not isinstance(binfields, list):
                        self._error('binary fields without a payload')
                    bpos = 0
                    for entry in binfields:
                        if not (isinstance(entry, list)
                                and len(entry) == 2
                                and isinstance(entry[0], str)
                                and isinstance(entry[1], int)
                                and entry[1] >= 0):
                            self._error('malformed binary field entry')
                        field, n = entry
                        # the frame's ONLY copy, and only after the
                        # CRC proved the bytes: the payload field must
                        # outlive the ring buffer's next compaction
                        payload[field] = bytes(body[bpos:bpos + n])
                        bpos += n
                    if bpos != blen:
                        self._error('binary fields disagree with body')
                self.metrics.bump('transport_frames_received')
                out.append(('env', dset, env))
        finally:
            # sub-view slices export the buffer independently of mv:
            # the LAST frame's head/body must drop too, or the del
            # below raises BufferError on a still-exported bytearray
            head = body = None
            mv.release()
        # views released: the buffer is resizable again. Reclaim the
        # consumed prefix wholesale when it empties or grows past the
        # compaction threshold.
        self._pos = pos
        if pos:
            if pos == len(buf):
                self._buf = bytearray()
                self._pos = 0
            elif pos >= self.compact_at:
                del buf[:pos]
                self._pos = 0
        return out

    def eof(self):
        """The stream ended; account any torn tail."""
        if len(self._buf) - self._pos:
            self.metrics.bump('transport_partial_frames')
        self._buf = bytearray()
        self._pos = 0

    @property
    def buffered(self):
        return len(self._buf) - self._pos


class _PeerLink:
    """Everything one peer pair shares: the single socket, the
    multiplexed per-docset connections, the bounded outgoing queue
    and the failure-detector state."""

    def __init__(self, peer_id, dial=None):
        self.peer_id = peer_id
        self.dial = dial               # (host, port) when we dial
        self.conns = {}                # docset name -> ResilientConnection
        self.peer_epoch = None
        self.writer = None
        self.reader_task = None
        self.writer_task = None
        self.outq = deque()            # (channel, iovec parts, nbytes)
        self.wake = asyncio.Event()
        self.state = 'up'
        self.last_seen = 0
        self.backoff = 0               # current re-dial backoff (ticks)
        self.redial_at = 0
        self.dialing = False
        self.had_socket = False
        # eager fast path: the in-flight flusher task and the
        # coalescing latch (a kick during a drain folds into the
        # drain's next batch instead of spawning a second task)
        self.flusher = None
        self.flush_again = False
        self.kicker = None             # doc-changed handler, if eager


class TransportEndpoint:
    """One node's socket endpoint: an asyncio server plus outgoing
    dials, multiplexing every hosted doc set over one socket per peer.

    ``doc_sets`` maps docset names (the mux key both ends must agree
    on) to doc sets. ``conn_kwargs`` forwards to every
    :class:`~.resilient.ResilientConnection` built for a peer
    (``heartbeat_every``, ``retry_limit``, admission, ...).
    ``suspect_after``/``dead_after`` are the failure-detector
    thresholds in :meth:`tick` units of silence; while a re-dial is
    backing off, the deadline stretches by the backoff (a link that
    is actively recovering is not declared dead by its own schedule).
    ``max_queue`` bounds each peer's outgoing frame queue; past it the
    oldest heartbeat/advert frame collapses first (the envelope layer
    re-advertises), then the oldest frame overall (retransmit
    repairs). ``eager`` (default on) is the fast path: staging an
    envelope schedules an immediate flush on the next event-loop turn
    instead of waiting for ``tick()`` — ``eager=False`` keeps the
    tick-quantized path as the A/B baseline.
    """

    def __init__(self, node_id, doc_sets, host='127.0.0.1', port=0, *,
                 conn_kwargs=None, resume=True, suspect_after=24,
                 dead_after=64, max_queue=1024,
                 redial_backoff=(1, 16), max_frame_bytes=None,
                 eager=True):
        self.node_id = node_id
        self.doc_sets = dict(doc_sets)
        self.host = host
        self.port = port
        self._conn_kwargs = dict(conn_kwargs or {})
        self._conn_kwargs.setdefault('batching', True)
        self._conn_kwargs.setdefault('wire', True)
        self.resume = resume
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.max_queue = max_queue
        self.redial_base, self.redial_max = redial_backoff
        self._probe_every = max(1, suspect_after // 4)
        self.max_frame_bytes = max_frame_bytes or MAX_FRAME_BYTES
        self.eager = eager
        self.epoch = next(_EPOCH_COUNTER)
        self.peers = {}                # peer_id -> _PeerLink
        self.now = 0
        self.closed = False
        self._server = None
        # transports of accepted sockets, held weakly: a closed one
        # drops out by itself
        self._inbound = weakref.WeakSet()
        self.metrics = metrics.scoped(node=str(node_id))
        # bytes this endpoint wrote to and read from its sockets: a
        # fleet whose links lose nothing is quiet once they are equal
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- lifecycle -----------------------------------------------------------

    async def start(self):
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def connect(self, peer_id, host, port):
        """Dial (or re-target) a peer. The link persists across socket
        loss: tick() re-dials with capped backoff until close()."""
        link = self.peers.get(peer_id)
        if link is None:
            link = self.peers[peer_id] = _PeerLink(peer_id,
                                                   dial=(host, port))
            link.last_seen = self.now
        else:
            link.dial = (host, port)
        await self._dial(link)
        return link

    async def close(self):
        """Graceful shutdown: stop the server, close every socket and
        connection (links unregister from their doc sets)."""
        self.closed = True
        if self._server is not None:
            self._server.close()
        for link in self.peers.values():
            self._cancel_tasks(link)
            self._drop_kicker(link)
            if link.writer is not None:
                try:
                    link.writer.close()
                except Exception:
                    pass
                link.writer = None
            for conn in link.conns.values():
                try:
                    conn.close()
                except Exception:
                    pass
        if self._server is not None:
            # from Python 3.12.1 on wait_closed() waits until every
            # accepted socket has closed; an accepted socket that no
            # link holds any more (a re-dial replaced it) can sit
            # closing forever and hang it, so abort what is left
            for tr in list(self._inbound):
                tr.abort()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
        await asyncio.sleep(0)

    async def kill(self):
        """Abrupt process-death simulation: abort every socket (RST,
        nothing flushed) and stop — connections are NOT closed cleanly
        and doc-set handlers stay registered, exactly like a killed
        process. Peers find out from their failure detectors."""
        self.closed = True
        if self._server is not None:
            self._server.close()
        for link in self.peers.values():
            self._cancel_tasks(link)
            self._drop_kicker(link)
            if link.writer is not None:
                transport = link.writer.transport
                try:
                    transport.abort()
                except Exception:
                    pass
                link.writer = None
        await asyncio.sleep(0)

    def _cancel_tasks(self, link):
        for task in (link.reader_task, link.writer_task,
                     link.flusher):
            if task is not None and not task.done():
                task.cancel()
        link.reader_task = link.writer_task = link.flusher = None

    def _drop_kicker(self, link):
        if link.kicker is None:
            return
        for ds in self.doc_sets.values():
            try:
                ds.unregister_handler(link.kicker)
            except Exception:
                pass
        link.kicker = None

    # -- dialing / handshake -------------------------------------------------

    async def _dial(self, link):
        if self.closed or link.dialing or link.dial is None:
            return False
        link.dialing = True
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(*link.dial), DIAL_TIMEOUT_S)
        except (OSError, asyncio.TimeoutError):
            link.dialing = False
            link.backoff = min(max(link.backoff * 2,
                                   self.redial_base),
                               self.redial_max)
            link.redial_at = self.now + link.backoff
            return False
        link.dialing = False
        if link.had_socket:
            self.metrics.bump('transport_reconnects')
        else:
            self.metrics.bump('transport_connects')
        link.backoff = 0
        self._attach_writer(link, writer)
        link.reader_task = asyncio.ensure_future(
            self._read_loop(link, reader, writer))
        self._enqueue_ctl(link, {'hello': 1, 'node': self.node_id,
                                 'epoch': self.epoch}, front=True)
        return True

    async def _accept(self, reader, writer):
        """Server side: the peer identifies itself with the first
        (HELLO) frame; until then nothing is routable."""
        self._inbound.add(writer.transport)
        await self._read_loop(None, reader, writer)

    def _on_hello(self, ctl, writer):
        peer = ctl.get('node')
        epoch = ctl.get('epoch')
        link = self.peers.get(peer)
        if link is None:
            link = self.peers[peer] = _PeerLink(peer)
            link.last_seen = self.now
        self.metrics.bump('transport_accepts')
        self._attach_writer(link, writer)
        # the reply goes out BEFORE the conns open: opening a conn
        # queues its adverts, and the dialer can only route them
        # after our HELLO has built ITS conns — reply-first keeps the
        # first flight routable instead of dropped-unroutable
        self._enqueue_ctl(link, {'hello': 1, 'node': self.node_id,
                                 'epoch': self.epoch})
        self._ensure_conns(link, epoch)
        return link

    def _ensure_conns(self, link, peer_epoch):
        """Create (or keep) the per-docset multiplexed connections.
        Same epoch -> transparent reconnect: the live connections,
        their unacked envelopes and their v3 session string tables
        all survive the socket swap untouched. New epoch -> the peer
        process restarted: tear down and rebuild through the
        wire-session ``resume`` path, so the first flush serves only
        the divergence window."""
        if peer_epoch is None:
            peer_epoch = -1
        if link.conns and link.peer_epoch == peer_epoch:
            return
        for conn in link.conns.values():
            try:
                conn.close()
            except Exception:
                pass
        link.conns = {}
        link.peer_epoch = peer_epoch
        for name, ds in self.doc_sets.items():
            conn = ResilientConnection(
                ds, self._sender(link, name),
                peer_id=link.peer_id,
                scope=metrics.scoped(node=str(self.node_id),
                                     peer=str(link.peer_id)),
                resume=self.resume,
                **self._conn_kwargs)
            conn.link_state = link.state
            link.conns[name] = conn
            conn.open()
        if self.eager and link.kicker is None:
            # eager staging hook: any doc change (local write or
            # received apply) kicks this link's flusher. The flush
            # itself runs as a task on the NEXT loop turn, so handler
            # ordering vs the conns' own doc_changed (which stages
            # the envelope) does not matter — by the time the flusher
            # runs, everything staged this turn is visible.
            def kicker(doc_id, doc, _link=link):
                self._kick(_link)
            link.kicker = kicker
            for ds in self.doc_sets.values():
                ds.register_handler(kicker)

    def _sender(self, link, name):
        def send(env):
            self._enqueue(link, name, env)
        return send

    # -- outgoing ------------------------------------------------------------

    def _enqueue(self, link, dset, env):
        if self.closed:
            return
        channel, parts, nbytes = encode_frame_iov(dset, env)
        q = link.outq
        if len(q) >= self.max_queue:
            # graceful degradation: the queue is bounded, and the
            # oldest ADVERT collapses first — heartbeats re-advertise
            # every clock each beat, so dropping a stale one loses
            # nothing; only when no advert remains does the oldest
            # frame overall go (the envelope layer retransmits it)
            dropped = False
            for i, entry in enumerate(q):
                if entry[0] == CHANNELS['hb']:
                    del q[i]
                    dropped = True
                    break
            if not dropped:
                q.popleft()
            self.metrics.bump('transport_frames_dropped')
        entry = (channel, parts, nbytes)
        if channel == CHANNELS['busy']:
            # backpressure replies are liveness: they bypass the data
            # queue so a saturated link cannot delay the signal that
            # would relieve it
            self._insert_liveness(link, entry)
        else:
            q.append(entry)
        link.wake.set()

    def _enqueue_ctl(self, link, ctl, front=False, liveness=False):
        frame = encode_ctl_frame(ctl)
        entry = (CHANNELS['ctl'], [frame], len(frame))
        if front:
            # the HELLO must be the FIRST frame on a fresh socket —
            # the queue may hold data frames from before the socket
            # died, and the acceptor drops anything pre-handshake
            link.outq.appendleft(entry)
        elif liveness:
            self._insert_liveness(link, entry)
        else:
            link.outq.append(entry)
        link.wake.set()

    def _insert_liveness(self, link, entry):
        """Front-of-queue insertion for liveness frames (keepalive
        pings, busy replies): ahead of every queued data frame but
        BEHIND any leading ctl frames, so a pending HELLO stays the
        first frame on its socket. The next writelines batch carries
        it regardless of how deep the data backlog is."""
        q = link.outq
        i = 0
        for e in q:
            if e[0] != CHANNELS['ctl']:
                break
            i += 1
        q.insert(i, entry)

    # -- eager fast path -----------------------------------------------------

    def _kick(self, link):
        """Schedule an immediate flush of this link's staged
        envelopes. Called on every doc change and every received
        batch. The flusher task runs on the next event-loop turn —
        that turn boundary IS the micro-coalescing window: everything
        staged in the current synchronous burst (a batched apply's
        doc_changed fan-out, a receive's follow-ups) rides one flush
        and one writelines. A kick landing while a drain is in flight
        latches ``flush_again`` instead of spawning a second task, so
        under load arrivals coalesce into the next batch. Outside the
        event loop this is a no-op — ``tick()`` or ``poke()`` drains
        sync-side staging."""
        if not self.eager or self.closed or not link.conns:
            return
        if link.flusher is not None and not link.flusher.done():
            link.flush_again = True
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        link.flush_again = False
        link.flusher = loop.create_task(self._flush_link(link))

    async def _flush_link(self, link):
        self.metrics.bump('transport_eager_flushes')
        while not self.closed:
            link.flush_again = False
            for conn in list(link.conns.values()):
                conn.flush()
            if not link.flush_again:
                return
            # kicks arrived while draining: one more pass next turn,
            # carrying everything that accumulated meanwhile
            self.metrics.bump('transport_coalesced_batches')
            await asyncio.sleep(0)

    async def poke(self):
        """Flush envelopes staged from OUTSIDE the event loop (the
        sync façade applies writes, then pokes): one direct flush per
        link plus a yield so the write loops run. The event-driven
        quiesce driver — :meth:`tick` is not needed for data to
        move."""
        for link in list(self.peers.values()):
            for conn in list(link.conns.values()):
                conn.flush()
        await asyncio.sleep(0)

    def _attach_writer(self, link, writer):
        if link.writer is not None and link.writer is not writer:
            try:
                link.writer.close()
            except Exception:
                pass
        if link.writer_task is not None and not link.writer_task.done():
            link.writer_task.cancel()
        link.writer = writer
        link.had_socket = True
        link.wake.set()
        link.writer_task = asyncio.ensure_future(
            self._write_loop(link, writer))

    async def _write_loop(self, link, writer):
        try:
            while not self.closed and link.writer is writer:
                q = link.outq
                if not q:
                    link.wake.clear()
                    await link.wake.wait()
                    continue
                if writer.transport.is_closing():
                    # a socket that is going away keeps its frames for
                    # the next one: Python 3.12's writelines on a lost
                    # transport raises TypeError, not ConnectionError
                    raise ConnectionResetError
                # drain the WHOLE queue into one writelines/drain
                # cycle: no per-frame write() calls, no join — the
                # iovec parts go straight to the transport. There is
                # no await between the pops and the writelines, so a
                # socket swap cannot strand popped frames.
                parts = []
                frames = 0
                nbytes = 0
                while q:
                    entry = q.popleft()
                    parts.extend(entry[1])
                    frames += 1
                    nbytes += entry[2]
                with self.metrics.trace_span('transport.write',
                                             frames=frames,
                                             bytes=nbytes):
                    writer.writelines(parts)
                    await writer.drain()
                self.metrics.bump('transport_frames_sent', frames)
                self.metrics.bump('transport_bytes_sent', nbytes)
                self.bytes_sent += nbytes
                self.metrics.observe('transport_frames_per_syscall',
                                     frames)
        except (ConnectionError, OSError):
            self._detach_socket(link, writer)
        except asyncio.CancelledError:
            raise

    # -- incoming ------------------------------------------------------------

    async def _read_loop(self, link, reader, writer):
        decoder = FrameDecoder(self.max_frame_bytes,
                               scope=self.metrics)
        try:
            while not self.closed:
                data = await reader.read(65536)
                if not data:
                    decoder.eof()
                    break
                self.metrics.bump('transport_bytes_received',
                                  len(data))
                self.bytes_received += len(data)
                with self.metrics.trace_span('transport.read',
                                             bytes=len(data)):
                    events = decoder.feed(data)
                for kind, dset, obj in events:
                    if kind == 'ctl':
                        link = self._handle_ctl(link, obj, writer)
                    elif link is None:
                        # pre-handshake envelope: unroutable
                        self.metrics.bump('transport_frames_dropped')
                    else:
                        self._dispatch(link, dset, obj)
                if link is not None and events:
                    # a received batch usually stages follow-ups
                    # (acks ship inline, but applies stage adverts
                    # and responses) — kick so they leave this turn,
                    # not next tick
                    self._kick(link)
        except FrameError:
            pass                        # counted; stream resets below
        except (ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        finally:
            if link is not None:
                self._detach_socket(link, writer)
            else:
                try:
                    writer.close()
                except Exception:
                    pass

    def _handle_ctl(self, link, ctl, writer):
        if 'hello' in ctl:
            if link is None:
                link = self._on_hello(ctl, writer)
            else:
                self._ensure_conns(link, ctl.get('epoch'))
        # ANY ctl frame (hello or keepalive ping) proves the peer's
        # process is alive — a pre-handshake ping (link is None) has
        # nothing to mark and is ignored
        if link is not None:
            link.last_seen = self.now
            self._note_alive(link)
        return link

    def _dispatch(self, link, dset, env):
        link.last_seen = self.now
        self._note_alive(link)
        conn = link.conns.get(dset)
        if conn is None:
            self.metrics.bump('transport_frames_dropped')
            return
        try:
            conn.receive_msg(env)
        except MessageRejected:
            pass                        # counted by the envelope layer

    def _detach_socket(self, link, writer):
        if link.writer is writer:
            link.writer = None
            self.metrics.bump('transport_disconnects')
            if link.dial is not None and not self.closed:
                # immediate first re-dial; failures grow the backoff
                link.redial_at = self.now + 1
        try:
            writer.close()
        except Exception:
            pass

    # -- liveness / membership -----------------------------------------------

    def _note_alive(self, link):
        if link.state != 'up':
            self._transition(link, 'up')

    def _transition(self, link, state):
        prev = link.state
        if prev == state:
            return
        link.state = state
        for conn in link.conns.values():
            set_state = getattr(conn, 'set_link_state', None)
            if set_state is not None:
                set_state(state)
        self.metrics.bump('membership_transitions')
        counts = {'up': 0, 'suspect': 0, 'down': 0}
        for other in self.peers.values():
            counts[other.state] = counts.get(other.state, 0) + 1
        self.metrics.set_gauge('membership_peers_up', counts['up'])
        self.metrics.set_gauge('membership_peers_suspect',
                               counts['suspect'])
        self.metrics.set_gauge('membership_peers_down',
                               counts['down'])
        if state == 'down':
            self.metrics.bump('membership_peer_down_total')
            # the event first (it rides the flight recorder's ring),
            # the hook second (a serving doc set dumps the incident —
            # WITH this event in it)
            if metrics.active:
                metrics.emit('peer_down', node=self.node_id,
                             peer=link.peer_id,
                             idle_ticks=self.now - link.last_seen)
            for ds in self.doc_sets.values():
                note = getattr(ds, 'note_peer_down', None)
                if note is not None:
                    note(link.peer_id)
        elif prev == 'down':
            if metrics.active:
                metrics.emit('peer_up', node=self.node_id,
                             peer=link.peer_id)
            for ds in self.doc_sets.values():
                note = getattr(ds, 'note_peer_up', None)
                if note is not None:
                    note(link.peer_id)

    def membership(self):
        """{peer_id: 'up'|'suspect'|'down'} — this endpoint's view."""
        return {pid: link.state for pid, link in self.peers.items()}

    # -- logical time --------------------------------------------------------

    async def tick(self):
        """One scheduling quantum, driven by the owner: re-dial lost
        links (capped backoff), tick + flush every multiplexed
        connection, then run the failure detector. Must run inside
        the event loop — it yields once so IO progresses. With the
        eager path on, data no longer WAITS for this (staging kicks
        its own flush); tick keeps heartbeats, keepalives, backoff
        and membership on the quantum schedule, and its closing flush
        is the safety net for anything staged outside the loop."""
        self.now += 1
        for link in list(self.peers.values()):
            if link.writer is None and link.dial is not None \
                    and not link.dialing and not self.closed \
                    and self.now >= link.redial_at:
                asyncio.ensure_future(self._dial(link))
            for conn in link.conns.values():
                conn.tick()
        # the detector runs AFTER the conn ticks (a heartbeat due this
        # quantum gets queued before silence is judged) and stretches
        # the deadline by the re-dial backoff: a link actively backing
        # off is recovering, not yet provably dead
        for link in self.peers.values():
            idle = self.now - link.last_seen
            grace = link.backoff if link.writer is None else 0
            if link.state != 'down' and \
                    idle >= self.dead_after + grace:
                self._transition(link, 'down')
            elif link.state == 'up' and \
                    idle >= self.suspect_after + grace:
                self._transition(link, 'suspect')
            # transport-owned keepalive: a suspect/down peer's conns
            # park their heartbeats, so the probe that discovers the
            # peer came back must come from the transport itself. The
            # ping either proves liveness on arrival (the receiver
            # marks us up and its heartbeats resume) or flushes out a
            # silently dead socket (the write errors, the link
            # detaches and re-dials). Without it, two peers that mark
            # each other down deadlock: both park, nobody speaks.
            # Liveness insertion: the ping goes ahead of any queued
            # data, so a saturated queue cannot delay the probe.
            if link.state != 'up' and link.writer is not None \
                    and self.now % self._probe_every == 0:
                self._enqueue_ctl(link, {'ping': 1}, liveness=True)
        for link in self.peers.values():
            for conn in link.conns.values():
                conn.flush()
        await asyncio.sleep(0)

    # -- introspection -------------------------------------------------------

    def pending(self):
        """True while any link has queued frames, unacked envelopes
        or staged-but-unflushed adverts — the socket fleets' quiesce
        check. The staged check matters on freshly built conns: a
        connection opened mid-tick stages its adverts for the NEXT
        flush, and quiescing before that flush would strand them."""
        for link in self.peers.values():
            if link.outq:
                return True
            if link.flusher is not None and not link.flusher.done():
                return True
            for conn in link.conns.values():
                if conn._sent or conn.backpressure_depth:
                    return True
                staged = getattr(getattr(conn, '_conn', None),
                                 '_flush_pending', None)
                if staged is not None and staged():
                    return True
        return False

    def connection_for(self, peer_id, dset):
        link = self.peers.get(peer_id)
        if link is None:
            return None
        return link.conns.get(dset)
