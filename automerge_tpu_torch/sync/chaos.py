"""ChaosTransport: a seeded adversarial message fabric for sync fleets.

The convergence claim of the whole system — replicas that exchange
messages end up byte-identical — is only worth something if it holds
when the transport misbehaves. This module is the harness that proves
it: a deterministic (seeded) in-process network between N peers that
drops, duplicates, delays/reorders, corrupts and partitions envelopes
on schedule, plus a fleet driver that wires
:class:`~.resilient.ResilientConnection` endpoints over it, ticks
logical time, and checks byte-identical convergence of every peer's
materialized state against a clean run.

Used by ``tests/test_chaos.py`` (the chaos convergence suite, pinned
seeds in CI) and ``bench.py``'s ``bench_degraded_link`` (the config-5
10k-doc fleet under 5%/20% loss).

Everything is logical-time and seeded — a failing schedule replays
exactly from its seed, which is what makes transport bugs debuggable.

The PyTorch port's copy of ``automerge_tpu/sync/chaos.py``:
:func:`replay_schedule_over_sockets` takes ``device``.
"""

import copy
import json
import random
import weakref
from collections import Counter

from .resilient import ResilientConnection


def doc_view(doc):
    """Plain-JSON materialization of one document (frontend docs and
    GeneralDocHandles alike) — the byte-identity comparand."""
    if hasattr(doc, 'materialize'):
        return doc.materialize()

    def conv(obj):
        name = type(obj).__name__
        if name == 'Text':
            return ''.join(str(c) for c in obj)
        if name == 'AmList':
            return [conv(v) for v in obj]
        if hasattr(obj, '_conflicts') or hasattr(obj, 'items'):
            return {k: conv(v) for k, v in obj.items()}
        return obj
    return conv(doc)


def doc_set_view(doc_set):
    """``{doc_id: plain tree}`` for a whole doc set (uses the batched
    read path when the doc set has one)."""
    if hasattr(doc_set, 'materialize_all'):
        return dict(doc_set.materialize_all())
    return {doc_id: doc_view(doc_set.get_doc(doc_id))
            for doc_id in doc_set.doc_ids}


def canonical(view):
    """Canonical byte encoding of a view — equality here IS
    byte-identical convergence."""
    return json.dumps(view, sort_keys=True, default=str)


def assert_digest_parity(doc_set):
    """Assert the incremental per-doc state digests equal an O(doc)
    recompute over the retained log, for every doc of a general-store
    doc set — the maintenance-correctness oracle the chaos schedules
    run after converging (no-op for doc sets without digests, or for
    snapshot-truncated stores whose history cannot be recomputed).
    COMPACTED stores stay checkable: the recompute starts from the
    digest recorded at each doc's horizon and folds only the retained
    tail, so the oracle survives the bodies being folded away."""
    store = getattr(doc_set, 'store', None)
    if store is None or not hasattr(store, 'digests_all'):
        return
    if store.log_truncated or not store._digest_valid:
        return
    digs = store.digests_all()
    for doc_id in doc_set.doc_ids:
        idx = doc_set.id_of[doc_id]
        got = int(digs[idx])
        want = store.digest_recompute(idx)
        assert got == want, (
            f'digest drift on {doc_id!r}: incremental {got:#x} != '
            f'recomputed {want:#x}')


class ChaosFleet:
    """N peers over a full-mesh adversarial fabric.

    ``doc_sets`` is a list of DocSet-like objects (one per peer); each
    directed link gets a :class:`ResilientConnection` endpoint. Per-tick
    scheduling: deliver every envelope whose delay expired, advance
    every endpoint's logical clock (retransmits + heartbeats), then
    flush batching endpoints. Fault injection happens at SEND time from
    one seeded RNG, so a schedule is a pure function of the seed.

    Fault knobs: ``drop``/``dup``/``corrupt`` are per-envelope
    probabilities; ``delay`` is the max extra ticks of random delivery
    delay (0 = in-order); :meth:`partition`/:meth:`heal` sever and
    restore node pairs (severed links drop everything, like a dead
    cable, not like a polite shutdown).
    """

    def __init__(self, doc_sets, seed=0, drop=0.0, dup=0.0, delay=0,
                 corrupt=0.0, batching=True, wire=False,
                 heartbeat_every=8, conn_kwargs=None, admission=None,
                 wire_version=None):
        self.doc_sets = list(doc_sets)
        self.rng = random.Random(seed)
        self.drop = drop
        self.dup = dup
        self.delay = delay
        self.corrupt = corrupt
        self.batching = batching
        self.wire = wire                 # columnar wire data path
        self.now = 0
        self._order = 0
        self.stats = Counter()
        self.queues = {}                 # (frm, to) -> [[due, order, env]]
        self.conns = {}                  # (owner, peer) -> endpoint
        self.partitioned = set()         # frozenset({a, b})
        self._conn_kwargs = dict(conn_kwargs or {})
        self._conn_kwargs.setdefault('heartbeat_every', heartbeat_every)
        if wire:
            self._conn_kwargs['wire'] = True
        # per-node wire-format version: an int pins every node, a list
        # pins per node (None entries = the build default) — the
        # mixed-version interop schedules run v1/v2/v3 peers in ONE
        # fleet and must still converge byte-identically (a pair
        # speaks min(sides), so one pinned node downgrades its links)
        if wire_version is None or isinstance(wire_version, int):
            self.node_wire_version = [wire_version] * len(self.doc_sets)
        else:
            self.node_wire_version = list(wire_version)
        # node-wide admission: ONE AdmissionControl shared by all of a
        # node's endpoints (the fleet-wide valve; the per-link valve
        # rides conn_kwargs['admission']). `admission` is kwargs for
        # every node, or a per-node list (None entries = unmetered)
        from .resilient import AdmissionControl
        n_nodes = len(self.doc_sets)
        if admission is None:
            self.node_admission = [None] * n_nodes
        elif isinstance(admission, dict):
            self.node_admission = [AdmissionControl(**admission)
                                   for _ in range(n_nodes)]
        else:
            self.node_admission = [
                cfg if cfg is None or
                isinstance(cfg, AdmissionControl)
                else AdmissionControl(**cfg) for cfg in admission]
        nodes = range(len(self.doc_sets))
        for a in nodes:
            for b in nodes:
                if a != b:
                    self.queues[(a, b)] = []
        for a in nodes:
            for b in nodes:
                if a != b:
                    self._make_conn(a, b)
        for conn in self.conns.values():
            conn.open()

    def _make_conn(self, owner, peer):
        # every endpoint is peer-scoped (peer_id=node<N>): its counters
        # land process-wide AND under a per-LINK scope, and a doc set
        # with a connection registry reports it per-connection in
        # fleet_status() — the chaos suite exercises the same operator
        # surface a real deployment reads. The scope carries the owner
        # node too (node/node<owner>/peer/node<peer>/): every fleet
        # node shares this one process's registry, so two links
        # targeting the same node (0->2 and 1->2) must not merge into
        # one peer/node2/ slice the way they never would across real
        # hosts
        from ..utils.metrics import metrics
        kwargs = dict(self._conn_kwargs)
        if self.wire and self.node_wire_version[owner] is not None:
            kwargs['wire_version'] = self.node_wire_version[owner]
        conn = ResilientConnection(
            self.doc_sets[owner], self._sender(owner, peer),
            batching=self.batching,
            shared_admission=self.node_admission[owner],
            seed=self.rng.randrange(1 << 30),
            peer_id=f'node{peer}',
            scope=metrics.scoped(node=f'node{owner}',
                                 peer=f'node{peer}'),
            **kwargs)
        self.conns[(owner, peer)] = conn
        return conn

    # -- the adversarial link ------------------------------------------------

    def _sender(self, frm, to):
        def send(env):
            self.stats['sent'] += 1
            if frozenset((frm, to)) in self.partitioned:
                self.stats['partition_dropped'] += 1
                return
            copies = 1
            if self.drop and self.rng.random() < self.drop:
                self.stats['dropped'] += 1
                copies = 0
            elif self.dup and self.rng.random() < self.dup:
                self.stats['duplicated'] += 1
                copies = 2
            for _ in range(copies):
                e = env
                if self.corrupt and self.rng.random() < self.corrupt:
                    self.stats['corrupted'] += 1
                    e = self._corrupt_env(env)
                due = self.now + 1 + (self.rng.randrange(self.delay + 1)
                                      if self.delay else 0)
                self._order += 1
                self.queues[(frm, to)].append([due, self._order, e])
        return send

    def _corrupt_env(self, env):
        """One seeded mutation: flipped checksum, bogus version, mangled
        seq/kind, a field torn out of the payload, or a bit flipped in
        a wire blob — every shape the receiver must survive (and count)
        without crashing. Blob corruption targets the CRC32-over-bytes
        path: the flipped byte must be caught BEFORE the codec parses,
        never quarantine a doc."""
        env = copy.deepcopy(env)
        mode = self.rng.randrange(6)
        if mode == 0:
            env['sum'] = env.get('sum', 0) ^ 0x5A5A5A5A
        elif mode == 1:
            env['v'] = 99
        elif mode == 2:
            env['seq'] = 'corrupt'
        elif mode == 3:
            env['kind'] = 'garbage'
        elif mode == 4:
            payload = env.get('payload')
            # flip one bit in a binary payload section — blob, the v2
            # literal tab or the v3 session-definition tab, all under
            # the CRC32-over-bytes checksum (a flipped v3 tab must be
            # caught by the envelope sum and repaired by retransmit,
            # never poison the receiver's session table)
            field = self.rng.choice(('blob', 'tab'))
            part = payload.get(field) if isinstance(payload, dict) \
                else None
            if not isinstance(part, (bytes, bytearray)) or not part:
                field = 'blob'
                part = payload.get(field) if isinstance(payload, dict) \
                    else None
            if isinstance(part, (bytes, bytearray)) and len(part):
                i = self.rng.randrange(len(part))
                payload[field] = part[:i] + \
                    bytes([part[i] ^ (1 << self.rng.randrange(8))]) + \
                    part[i + 1:]
            else:
                env['sum'] = -1
        else:
            body = env.get('payload') if isinstance(
                env.get('payload'), dict) else env.get('clocks')
            if isinstance(body, dict) and body:
                del body[self.rng.choice(sorted(body, key=str))]
            else:
                env['sum'] = -1
        return env

    # -- partitions ----------------------------------------------------------

    def partition(self, a, b):
        """Sever the (bidirectional) link between peers a and b; queued
        traffic on the link is lost too (a dead cable, not a drain)."""
        self.partitioned.add(frozenset((a, b)))
        self.queues[(a, b)].clear()
        self.queues[(b, a)].clear()

    def heal(self, a, b):
        self.partitioned.discard(frozenset((a, b)))

    # -- time ----------------------------------------------------------------

    def tick(self):
        """One network quantum: deliver due envelopes (per-link, in due
        order), advance every endpoint's clock, flush batching
        endpoints."""
        self.now += 1
        for (frm, to), q in self.queues.items():
            if not q:
                continue
            due = [m for m in q if m[0] <= self.now]
            if not due:
                continue
            q[:] = [m for m in q if m[0] > self.now]
            for _, _, env in sorted(due):
                self.stats['delivered'] += 1
                self.conns[(to, frm)].receive_msg(env)
        for conn in self.conns.values():
            conn.tick()
        for ctrl in self.node_admission:
            if ctrl is not None:
                ctrl.tick()            # the shared valve refills ONCE
                #                        per quantum, not once per link
        if self.batching or self.wire:
            for conn in self.conns.values():
                conn.flush()
        # serving doc sets advance their residency clock (last-touch
        # aging, memory-budget enforcement, quarantine parking)
        for ds in self.doc_sets:
            t = getattr(ds, 'tick', None)
            if t is not None:
                t()

    def pending(self):
        """Traffic still in flight: queued envelopes or unacked sends
        awaiting retransmission."""
        return any(self.queues.values()) or \
            any(c.in_flight for c in self.conns.values())

    # -- convergence ---------------------------------------------------------

    def views(self):
        return [doc_set_view(ds) for ds in self.doc_sets]

    def converged(self):
        views = [canonical(v) for v in self.views()]
        return all(v == views[0] for v in views[1:])

    def run(self, max_ticks=2000, min_ticks=0):
        """Tick until every peer's materialization is byte-identical
        and the fabric is quiet; returns the tick count. Raises if the
        fleet has not converged by ``max_ticks`` (a chaos schedule that
        defeats the resilience layer is a test failure, not a hang)."""
        while self.now < max_ticks:
            self.tick()
            if self.now >= min_ticks and not self.pending() \
                    and self.converged():
                return self.now
        raise RuntimeError(
            f'fleet failed to converge within {max_ticks} ticks '
            f'(stats: {dict(self.stats)})')

    def close(self):
        """Detach every endpoint from its doc set (so a doc set can be
        reused across fleets, e.g. by the bench's loss-rate sweep)."""
        for conn in self.conns.values():
            conn.close()

    # -- fault injection beyond the transport --------------------------------

    def inject_silent_divergence(self, node, doc_id, changes):
        """Mutate ONE replica's store out-of-band: apply ``changes``
        directly to ``node``'s doc set, bypassing the fabric entirely
        (no envelope, no checksum — exactly the logic-level corruption
        the transport layer cannot see). The injection is SILENT end
        to end: the node's endpoints never see the apply (their
        ``doc_changed`` handlers are detached around it) and are then
        told the peer already covers the new clock — so injecting an
        "evil twin" of a change another replica holds (same ``(actor,
        seq)``, other content) leaves every clock EQUAL, the normal
        protocol ships nothing, and the replicas stay silently
        diverged forever. Only the heartbeat digest audit can catch
        it."""
        from .connection import clock_union
        ds = self.doc_sets[node]
        owned = [c for (o, _p), c in self.conns.items() if o == node]
        inners = [getattr(c, '_conn', c) for c in owned]
        for inner in inners:
            ds.unregister_handler(inner.doc_changed)
        try:
            out = ds.apply_changes(doc_id, changes)
        finally:
            for inner in inners:
                ds.register_handler(inner.doc_changed)
        clock = ds.clock_of_id(doc_id) if \
            hasattr(ds, 'clock_of_id') else {}
        for conn, inner in zip(owned, inners):
            clock_union(inner._their_clock, doc_id, clock)
            clock_union(inner._our_clock, doc_id, clock)
            pend = getattr(inner, '_pending_send', None)
            if pend is not None:
                pend.pop(doc_id, None)
            acked = getattr(conn, '_peer_acked', None)
            if acked is not None:
                clock_union(acked, doc_id, clock)
        return out

    # -- crash/restart -------------------------------------------------------

    def reconnect(self, node, doc_set=None):
        """Crash-restart peer ``node``: all its in-flight traffic is
        lost, its doc set is replaced (e.g. recovered from snapshot +
        journal), and every adjacent link re-establishes with FRESH
        envelope sessions on both ends — exactly what a process restart
        does to a connection."""
        if doc_set is not None:
            self.doc_sets[node] = doc_set
        for (owner, peer), conn in list(self.conns.items()):
            if node not in (owner, peer):
                continue
            try:
                conn.close()
            except Exception:
                pass                     # the crashed side's handler is gone
            self.queues[(owner, peer)].clear()
            self._make_conn(owner, peer).open()


# -- socket-level chaos (PR 19) ------------------------------------------------
#
# Everything above injects faults on an IN-PROCESS fabric: envelopes
# are Python objects and a "partition" is a list clear. The classes
# below move the same seeded adversity to REAL loopback TCP: a
# fault-injecting proxy per peer pair (latency, jitter, chunk drop /
# duplicate — which corrupt the byte stream and exercise the frame
# codec's CRC reset path — mid-frame cuts, hard partitions) under a
# SocketChaosFleet that mirrors ChaosFleet's driver API, so the PR 13
# scenario schedules replay unchanged over actual sockets and compare
# byte-identical against the clean in-process oracle.

import asyncio  # noqa: E402


class ChaosProxy:
    """A fault-injecting TCP proxy for ONE peer pair: the dialing
    endpoint connects here instead of to its peer, and every byte
    stream crossing the proxy suffers the configured faults.

    Chunk-level drop/duplicate deliberately CORRUPT the framed stream
    (TCP itself never loses bytes mid-connection) — that is the point:
    the frame codec must catch the damage by CRC, reset the session
    and let the envelope layer repair by retransmit. ``cut`` forwards
    half a chunk then kills the pipe (a mid-frame connection reset —
    the torn-tail path). ``partition()`` stops the listener and aborts
    live pipes (a dead cable: re-dials get ECONNREFUSED and back off)
    until ``heal()`` re-opens the same port.

    ``target_port_of`` is a callable so a restarted peer (new server
    port) is re-routable without rebuilding the proxy."""

    def __init__(self, target_port_of, host='127.0.0.1', seed=0,
                 latency_ms=0.0, jitter_ms=0.0, drop=0.0, dup=0.0,
                 cut=0.0, corrupt=0.0):
        self.target_port_of = target_port_of
        self.host = host
        self.rng = random.Random(seed)
        self.latency_ms = latency_ms
        self.jitter_ms = jitter_ms
        self.drop = drop
        self.dup = dup
        self.cut = cut
        self.corrupt = corrupt
        self.partitioned = False
        self.port = None
        self._server = None
        self.pipes = set()
        # transports of accepted sockets, held weakly (see close())
        self._accepted = weakref.WeakSet()
        self.stats = Counter()

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port or 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def _handle(self, creader, cwriter):
        self._accepted.add(cwriter.transport)
        if self.partitioned:
            cwriter.close()
            return
        try:
            sreader, swriter = await asyncio.open_connection(
                self.host, self.target_port_of())
        except OSError:
            cwriter.close()
            return
        pipe = (cwriter, swriter)
        self.pipes.add(pipe)
        pumps = (asyncio.ensure_future(self._pump(creader, swriter)),
                 asyncio.ensure_future(self._pump(sreader, cwriter)))
        try:
            await asyncio.wait(pumps,
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for task in pumps:
                if not task.done():
                    task.cancel()
            self.pipes.discard(pipe)
            for writer in pipe:
                try:
                    writer.close()
                except Exception:
                    pass

    async def _pump(self, reader, writer):
        try:
            while True:
                data = await reader.read(4096)
                if not data or self.partitioned:
                    return
                if self.latency_ms or self.jitter_ms:
                    await asyncio.sleep(
                        (self.latency_ms +
                         self.rng.random() * self.jitter_ms) / 1e3)
                roll = self.rng.random()
                if roll < self.drop:
                    self.stats['dropped'] += 1
                    continue
                if roll < self.drop + self.cut:
                    self.stats['cut'] += 1
                    writer.write(data[:max(1, len(data) // 2)])
                    await writer.drain()
                    return              # mid-frame reset
                if roll < self.drop + self.cut + self.corrupt:
                    # flip one byte: whole-chunk drop/dup usually
                    # stays FRAME-aligned (TCP coalesces writes), so
                    # this is the fault that reliably exercises the
                    # codec's CRC reject -> stream reset -> re-dial
                    # path at the socket level
                    self.stats['corrupted'] += 1
                    i = self.rng.randrange(len(data))
                    data = data[:i] + bytes([data[i] ^ 0x40]) \
                        + data[i + 1:]
                writer.write(data)
                if self.dup and self.rng.random() < self.dup:
                    self.stats['dupped'] += 1
                    writer.write(data)
                await writer.drain()
        except (ConnectionError, OSError):
            return

    def _kill_pipes(self):
        for cwriter, swriter in list(self.pipes):
            for writer in (cwriter, swriter):
                try:
                    writer.transport.abort()
                except Exception:
                    pass

    async def sever(self):
        """Dead cable: stop listening (new dials are refused — the
        endpoints' re-dial backoff takes over) and abort live pipes."""
        await self.close()

    async def heal(self):
        self.partitioned = False
        if self._server is None:
            await self.start()         # same recorded port

    async def close(self):
        self.partitioned = True
        if self._server is not None:
            self._server.close()
            # from Python 3.12.1 on wait_closed() waits until every
            # accepted socket has closed, and one left closing by a
            # fault can stay so forever: abort them all first
            for tr in list(self._accepted):
                tr.abort()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
            self._server = None
        self._kill_pipes()


class SocketChaosFleet:
    """:class:`ChaosFleet`'s driver API over REAL loopback sockets:
    one :class:`~.transport.TransportEndpoint` per node (each hosting
    its doc set under one mux key), every pair joined through a
    :class:`ChaosProxy`, ticked synchronously — the fleet owns a
    private event loop, so the callers (tests, bench, schedule
    replay) stay plain synchronous code.

    Unlike the in-process fabric there is no seeded delivery ORDER:
    TCP + asyncio schedule delivery. The comparand is unchanged
    anyway — CRDT convergence makes the FINAL state byte-identical
    regardless of arrival order, which is exactly what the schedule
    replays assert against the clean oracle."""

    def __init__(self, doc_sets, seed=0, drop=0.0, dup=0.0, cut=0.0,
                 corrupt=0.0, latency_ms=0.0, jitter_ms=0.0,
                 heartbeat_every=8, conn_kwargs=None,
                 suspect_after=24, dead_after=48, max_queue=1024,
                 resume=True, dset='fleet', eager=True):
        self.loop = asyncio.new_event_loop()
        self.doc_sets = list(doc_sets)
        self.dset = dset
        self.seed = seed
        self.now = 0
        self._latency = latency_ms + jitter_ms
        ck = dict(conn_kwargs or {})
        ck.setdefault('heartbeat_every', heartbeat_every)
        self._conn_kwargs = ck
        self._ep_kwargs = dict(suspect_after=suspect_after,
                               dead_after=dead_after,
                               max_queue=max_queue, resume=resume,
                               redial_backoff=(1, 8), eager=eager)
        self._fault_kwargs = dict(latency_ms=latency_ms,
                                  jitter_ms=jitter_ms, drop=drop,
                                  dup=dup, cut=cut, corrupt=corrupt)
        self.endpoints = []
        self.proxies = {}              # (a, b) with a < b
        # True while no link can lose bytes: no fault knob set, no
        # node killed, no pair partitioned (see _quiet)
        self._lossless = not any(self._fault_kwargs.values())
        self._run(self._start())

    def _run(self, coro):
        return self.loop.run_until_complete(coro)

    def _make_endpoint(self, node, **overrides):
        from .transport import TransportEndpoint
        kwargs = dict(self._ep_kwargs)
        kwargs.update(overrides)
        return TransportEndpoint(
            f'node{node}', {self.dset: self.doc_sets[node]},
            conn_kwargs=dict(self._conn_kwargs), **kwargs)

    async def _start(self):
        n = len(self.doc_sets)
        for i in range(n):
            ep = self._make_endpoint(i)
            await ep.start()
            self.endpoints.append(ep)
        for a in range(n):
            for b in range(a + 1, n):
                proxy = ChaosProxy(
                    (lambda b=b: self.endpoints[b].port),
                    seed=self.seed * 1009 + a * 37 + b,
                    **self._fault_kwargs)
                await proxy.start()
                self.proxies[(a, b)] = proxy
                await self.endpoints[a].connect(
                    f'node{b}', '127.0.0.1', proxy.port)
        await self._pump(8)            # let the HELLOs land

    async def _pump(self, rounds):
        for _ in range(rounds):
            await asyncio.sleep(0)
        if self._latency:
            # real latency faults are wall-clock: give the delayed
            # chunks time to clear their timers
            await asyncio.sleep(self._latency * 1.5 / 1e3)

    # -- ChaosFleet driver API ----------------------------------------------

    def tick(self):
        self.now += 1
        self._run(self._tick_async())

    async def _tick_async(self):
        for ep in self.endpoints:
            if not ep.closed:
                await ep.tick()
        for ds in self.doc_sets:
            t = getattr(ds, 'tick', None)
            if t is not None:
                t()
        await self._pump(6)

    def _local_work(self):
        """True while an endpoint holds a flush task not yet run or a
        frame queued on a live socket."""
        for ep in self.endpoints:
            if ep.closed:
                continue
            for link in ep.peers.values():
                if link.flusher is not None and not link.flusher.done():
                    return True
                if link.outq and link.writer is not None:
                    return True
        return False

    def _in_flight(self):
        """True while, on lossless links, bytes written to a socket are
        not yet read at its other end."""
        return self._lossless and (
            sum(ep.bytes_sent for ep in self.endpoints)
            != sum(ep.bytes_received for ep in self.endpoints))

    async def _settle_fabric(self, turns=256, waits=50):
        """Run the event loop while there is local work (up to ``turns``
        turns) or bytes in flight (then up to ``waits`` more waits of 1
        ms, for bytes the host has not delivered yet)."""
        for i in range(turns + waits):
            if self._in_flight():
                await asyncio.sleep(0 if i < turns else 1e-3)
            elif i < turns and self._local_work():
                await asyncio.sleep(0)
            else:
                return

    def _quiet(self):
        """The quiet check of :meth:`run`: no endpoint :meth:`pending`
        once the fabric has settled (:meth:`_settle_fabric`). A tick
        ends after a fixed number of event-loop turns, and whether the
        last frames it set off have landed by then, and their flush
        tasks run, depends on the host's speed: without the settle
        :meth:`run` ended a tick later on some runs than on others, and
        every tick count read after it (a failure detector's deadlines)
        moved with it."""
        self._run(self._settle_fabric())
        return not self.pending()

    def partition(self, a, b):
        self._lossless = False
        self._run(self.proxies[(min(a, b), max(a, b))].sever())

    def heal(self, a, b):
        self._run(self.proxies[(min(a, b), max(a, b))].heal())

    def kill(self, node):
        """Abrupt process death: sockets abort, nothing closes
        cleanly — peers only find out from their failure detectors."""
        self._lossless = False
        self._run(self.endpoints[node].kill())

    def restart(self, node, doc_set=None, resume=True):
        """Bring a killed node back: a NEW endpoint (new epoch — the
        surviving peers rebuild their links through the wire-session
        resume path) hosting ``doc_set`` (default: the node's previous
        doc set, the recovered-from-durable-state posture). Pairs
        where the restarted node dials reconnect here; pairs dialing
        INTO it re-dial on their own backoff, routed by the proxies'
        late-bound target ports."""
        if doc_set is not None:
            self.doc_sets[node] = doc_set
        ep = self._make_endpoint(node, resume=resume)
        self.endpoints[node] = ep

        async def go():
            await ep.start()
            for (a, b), proxy in self.proxies.items():
                if a == node:
                    await ep.connect(f'node{b}', '127.0.0.1',
                                     proxy.port)
            await self._pump(8)
        self._run(go())

    def pending(self):
        return any(not ep.closed and ep.pending()
                   for ep in self.endpoints)

    def views(self):
        return [doc_set_view(ds) for ds in self.doc_sets]

    def converged(self):
        views = [canonical(v) for v in self.views()]
        return all(v == views[0] for v in views[1:])

    def run(self, max_ticks=2000, min_ticks=0):
        """Tick until byte-identical convergence and a quiet fabric;
        raises past ``max_ticks`` (a schedule that defeats the
        transport is a failure, not a hang)."""
        start = self.now
        while self.now - start < max_ticks:
            self.tick()
            if self.now - start >= min_ticks and self._quiet() \
                    and self.converged():
                return self.now
        raise RuntimeError(
            f'socket fleet failed to converge within {max_ticks} '
            f'ticks')

    def settle(self, max_rounds=400):
        """Event-driven drain to convergence: poke every endpoint
        once (flushing whatever the sync side staged), then just let
        the event loop run — receives kick their own eager flushes,
        acks ship inline, and the fleet quiesces WITHOUT a single
        tick quantum. This is the eager fast path's convergence
        driver: the time :meth:`settle` takes is the transport's real
        link floor, where :meth:`run` pays the tick schedule. Returns
        the number of pump rounds used; raises past ``max_rounds``.
        Heartbeats/keepalives/failure detection do NOT advance here —
        chaos schedules that need them still drive :meth:`tick`."""
        async def go():
            for ep in self.endpoints:
                if not ep.closed:
                    await ep.poke()
            quiet = 0
            for i in range(max_rounds):
                await self._pump(2)
                # pending() dips false between conversation legs while
                # bytes are still in flight, and converged() is a full
                # materialize — only pay for it after the fabric has
                # been quiet for a few consecutive rounds
                quiet = 0 if self.pending() else quiet + 1
                if quiet >= 3:
                    if self.converged():
                        return i + 1
                    quiet = 0
                    for ep in self.endpoints:   # quiet but divergent:
                        if not ep.closed:       # nudge staged work out
                            await ep.poke()
            return None
        rounds = self._run(go())
        if rounds is None:
            raise RuntimeError(
                f'socket fleet failed to settle within {max_rounds} '
                f'pump rounds')
        return rounds

    def close(self):
        async def go():
            for ep in self.endpoints:
                if not ep.closed:
                    await ep.close()
            for proxy in self.proxies.values():
                await proxy.close()
            await asyncio.sleep(0)
        self._run(go())
        self._run(asyncio.sleep(0.01))  # unwind cancellations
        self.loop.close()


def replay_schedule_over_sockets(schedule, chaos=None, doc_sets=None,
                                 max_ticks=4000, device=None,
                                 **fleet_kwargs):
    """Re-run a fleetsim scenario schedule (``build_schedule``) over
    real loopback sockets through the fault-injecting proxies, then
    converge. Returns the canonical per-node views plus the
    quarantine/divergence totals — the byte-identity comparand
    against :func:`~automerge_tpu_torch.fleetsim.run_oracle`. Without
    ``doc_sets``, each node is a ``GeneralDocSet`` on ``device`` (None
    is the card, raising without one)."""
    spec = schedule['spec']
    if doc_sets is None:
        from .general_doc_set import GeneralDocSet
        doc_sets = [GeneralDocSet(spec['n_docs'] + 8, device=device)
                    for _ in range(spec['n_nodes'])]
    fleet = SocketChaosFleet(
        doc_sets, seed=schedule['seed'] + 7,
        heartbeat_every=spec['heartbeat_every'],
        **dict(chaos or {}), **fleet_kwargs)
    try:
        for tick in schedule['ticks']:
            for a, b in tick.get('partition', ()):
                fleet.partition(a, b)
            for a, b in tick.get('heal', ()):
                fleet.heal(a, b)
            by_node = {}
            for node, doc_id, changes in tick['writes']:
                by_node.setdefault(node, {})[doc_id] = changes
            for node, batch in by_node.items():
                doc_sets[node].apply_changes_batch(batch)
            fleet.tick()
        ticks = fleet.run(max_ticks=max_ticks)
        return {
            'views': [canonical(v) for v in fleet.views()],
            'ticks': ticks,
            'quarantined': sum(len(getattr(ds, 'quarantined', ()) or
                                   ()) for ds in doc_sets),
            'diverged': sum(len(getattr(ds, 'diverged', ()) or ())
                            for ds in doc_sets),
        }
    finally:
        fleet.close()
