"""Sharded fleet serving: the doc axis partitioned over a device mesh.

One :class:`~.general_doc_set.GeneralDocSet` owns one columnar store —
one device's worth of fleet. This module is the step past that wall: a
:class:`ShardedGeneralDocSet` owns N per-shard doc sets placed on the
devices of a 1-D mesh and routes every apply/materialize/wire touch through a doc→shard
**placement map** — consistent-hash by default, explicit pins on top —
so a request pays the cost of ONE shard's planes, never the fleet's.
Per-request work is where sharding earns its keep even on one host:
the plane-sized terms of an apply (staging prefixes, visibility
renumber, patch reads) shrink by the shard fraction.

Three protocols live here:

**Placement** (:class:`PlacementMap`): a deterministic consistent-hash
ring (blake2b, virtual nodes — independent of ``PYTHONHASHSEED``)
assigns new docs to shards; explicit pins override the ring and are
what migration flips. A 1-device/1-shard fleet routes everything to
shard 0 and is byte-identical to the unsharded doc set.

**Live migration** (:meth:`ShardedGeneralDocSet.migrate_docs`): the
state snapshot + retained tail + causally-buffered queue of each
doc ships as ONE checksummed unit (CRC32 over a canonical JSON body —
a corrupt unit refuses to absorb, the source keeps serving), absorbs
on the destination, digest-verifies against the source, and only then
the placement entry flips. In-flight changes arriving during the
window buffer behind a per-doc **fence** and re-route to the
destination after the flip — queued, never dropped
(``placement_fenced_changes``). On any fault the destination rolls
back and the source keeps owning the doc.

**Rollups**: ``fleet_status()`` aggregates per-shard stats through
:func:`~automerge_tpu_torch.parallel.general_shard.fleet_rollup` — a
``psum``-style cross-shard reduction over a multi-entry mesh (numpy
on one device) — so the operator surface stays O(connections +
shards), never O(fleet).

The :class:`~.control.FleetController` placement knob consumes
:meth:`ShardedGeneralDocSet.shard_load` (per-shard apply-rate windows
+ resident bytes) and drains hot docs to the coldest shard under
sustained imbalance; see ``control._placement_rule``.

The PyTorch port's copy of ``automerge_tpu/sync/sharded.py``: the same
placement ring, migration units and snapshot format (a snapshot written
by either package loads in the other). Shard *i*'s
:class:`GeneralDocSet` is built on ``shard_device(mesh, i)`` (the
reference builds it under that device's ``jax.default_device``), and
the default mesh is :func:`~..parallel.mesh.make_mesh` over ``device``
(None: every visible card, raising without one).
"""

import base64
import bisect
import hashlib
import json
import time as _time
import zlib

import numpy as np

from ..utils.metrics import metrics as _metrics
from .general_doc_set import (DEFAULT_HEALTH_THRESHOLDS, GeneralDocSet,
                              _latency_quantiles)

_MIGRATE_FORMAT = 'automerge-tpu-migration-unit@1'
_SNAP_FORMAT = 'automerge-tpu-sharded-docset-snapshot@1'


def _hash64(key):
    return int.from_bytes(
        hashlib.blake2b(key.encode('utf-8'), digest_size=8).digest(),
        'big')


class PlacementMap:
    """doc_id → shard: a consistent-hash ring with explicit pins.

    The ring is deterministic (blake2b over ``shard-<s>:<replica>``
    labels) so every process — and every later process replaying a
    snapshot — derives the same default placement. ``replicas``
    virtual nodes per shard keep the ring statistically even; pins
    (:meth:`pin`) sit above the ring and are the entries migration
    flips atomically.
    """

    def __init__(self, n_shards, replicas=32):
        if n_shards < 1:
            raise ValueError('need at least one shard')
        self.n_shards = n_shards
        self.replicas = replicas
        self.pins = {}                 # doc_id -> shard (explicit)
        points = sorted(
            (_hash64(f'shard-{s}:{r}'), s)
            for s in range(n_shards) for r in range(replicas))
        self._ring_keys = [k for k, _ in points]
        self._ring_shards = [s for _, s in points]

    def shard_of(self, doc_id):
        pin = self.pins.get(doc_id)
        if pin is not None:
            return pin
        i = bisect.bisect_right(self._ring_keys,
                                _hash64(str(doc_id))) \
            % len(self._ring_keys)
        return self._ring_shards[i]

    def pin(self, doc_id, shard):
        if not 0 <= shard < self.n_shards:
            raise ValueError(
                f'shard {shard} out of range [0, {self.n_shards})')
        self.pins[doc_id] = shard
        _metrics.set_gauge('placement_overrides', len(self.pins))

    def unpin(self, doc_id):
        self.pins.pop(doc_id, None)
        _metrics.set_gauge('placement_overrides', len(self.pins))

    def snapshot(self):
        return {'n_shards': self.n_shards, 'replicas': self.replicas,
                'pins': dict(self.pins)}

    @classmethod
    def restore(cls, snap):
        pm = cls(snap['n_shards'], replicas=snap.get('replicas', 32))
        pm.pins = dict(snap.get('pins', {}))
        return pm


def encode_migration_unit(rec):
    """One doc's parkable state (:meth:`GeneralDocSet.
    extract_doc_state` record) as a self-checking wire unit: canonical
    JSON body behind a CRC32 header. The snapshot/tail/queue travel
    together — the unit either absorbs whole or not at all."""
    body = json.dumps({'format': _MIGRATE_FORMAT, 'doc': rec},
                      sort_keys=True,
                      separators=(',', ':')).encode('utf-8')
    crc = zlib.crc32(body) & 0xffffffff
    return crc.to_bytes(4, 'big') + body


def decode_migration_unit(data):
    """Verify and open a migration unit (raises ValueError on checksum
    or format mismatch — the absorb never sees a torn unit)."""
    data = bytes(data)
    crc, body = int.from_bytes(data[:4], 'big'), data[4:]
    if zlib.crc32(body) & 0xffffffff != crc:
        raise ValueError('migration unit checksum mismatch')
    payload = json.loads(body.decode('utf-8'))
    if payload.get('format') != _MIGRATE_FORMAT:
        raise ValueError(
            f'unknown migration unit format {payload.get("format")!r}')
    return payload['doc']


def _take_block(block, sel, n_docs, new_doc):
    """A new :class:`ChangeBlock` holding change rows ``sel`` of
    ``block`` with the doc column replaced by ``new_doc`` (the target
    store's indexes) — the CSR slice every shard's cut of a wire batch
    rides through. Literal tables are shared, not copied."""
    from ..device.blocks import ChangeBlock, _csr_take
    sel = np.asarray(sel, np.int64)
    dep_ptr, (dep_actor, dep_seq) = _csr_take(
        block.dep_ptr, sel, (block.dep_actor, block.dep_seq))
    if block.obj is not None:
        _, (obj, key_kind, key_elem, elem) = _csr_take(
            block.op_ptr, sel,
            (block.obj, block.key_kind, block.key_elem, block.elem))
    else:
        obj = key_kind = key_elem = elem = None
    op_ptr, (action, key, value) = _csr_take(
        block.op_ptr, sel, (block.action, block.key, block.value))
    return ChangeBlock(
        n_docs, np.asarray(new_doc, np.int32), block.actor[sel],
        block.seq[sel], dep_ptr, dep_actor, dep_seq, op_ptr, action,
        key, value, block.actors, block.keys, block.values,
        dup_keys=None, obj=obj, key_kind=key_kind, key_elem=key_elem,
        elem=elem, objs=block.objs)


class ShardedGeneralDocSet:
    """N per-shard :class:`GeneralDocSet`s behind one DocSet surface.

    ``capacity`` is the FLEET capacity; each shard starts at its
    1/N cut and auto-grows independently. ``mesh`` (a 1-D doc-axis
    mesh, default :func:`~automerge_tpu_torch.parallel.mesh.make_mesh`
    over ``device``: None is every visible card) places shard *i*'s
    store on device ``i % mesh_size`` — the shard's doc set is built
    on that device, so its planes and every fused apply stay where the
    placement map says. ``shard_factory(index, capacity, device)``
    swaps the per-shard doc set class (a serving wrapper makes
    eviction/fault-in shard-local — each shard manages its own
    residency budget).

    The surface mirrors :class:`GeneralDocSet`; handlers fire at THIS
    layer (per requested doc, after the shard-routed apply), so a
    migration's internal absorb never double-fires them.
    """

    def __init__(self, capacity, n_shards=None, mesh=None, options=None,
                 auto_grow=True, shard_factory=None, replicas=32,
                 device=None):
        from ..parallel.mesh import make_mesh, shard_device
        if mesh is None:
            mesh = make_mesh(device=device)
        self.mesh = mesh
        if n_shards is None:
            n_shards = mesh.devices.size
        self.n_shards = max(1, int(n_shards))
        self.capacity = capacity
        self._options = options
        per_shard = max(4, -(-capacity // self.n_shards))
        if shard_factory is None:
            def shard_factory(i, cap, device):
                return GeneralDocSet(cap, options=options,
                                     auto_grow=auto_grow, device=device)
        self.devices = [shard_device(mesh, i)
                        for i in range(self.n_shards)]
        # each shard's store lives on its device from the start, so
        # its planes and fused applies stay there
        self.shards = [shard_factory(i, per_shard, self.devices[i])
                       for i in range(self.n_shards)]
        self.placement = PlacementMap(self.n_shards, replicas=replicas)
        self._doc_shard = {}           # doc_id -> owning shard (live)
        self._fences = {}              # doc_id -> buffered work items
        self.handlers = []
        self.connections = {}
        self.controller = None
        # per-shard load telemetry: ops admitted this window / the
        # last completed window (what the controller's placement rule
        # reads), decayed per-doc heat for hot-doc selection, and
        # migration tallies for the placement block
        self._window = np.zeros(self.n_shards, np.int64)
        self._last_window = np.zeros(self.n_shards, np.int64)
        self._heat = {}                # doc_id -> decayed op count
        self._migrations_in = np.zeros(self.n_shards, np.int64)
        self._migrations_out = np.zeros(self.n_shards, np.int64)
        self._imbalance = 1.0
        # health rollup state (the borrowed GeneralDocSet evaluators)
        self.health_thresholds = dict(DEFAULT_HEALTH_THRESHOLDS)
        self.health_extra = None
        self.health_incident = None
        self._health_state = 'green'
        self._health_last_exhausted = 0
        self._health_last_retraces = None
        self._births = {}
        # membership hooks the borrowed convergence/status evaluators
        # consult (a sharded set has no transport links of its own, so
        # these stay empty unless a binding marks peers down)
        self._parked_births = {}
        self._down_peers = set()

    # -- placement / routing -------------------------------------------------

    def shard_of(self, doc_id):
        """The shard currently serving ``doc_id`` (live registry for
        known docs, the placement map's answer for new ones)."""
        s = self._doc_shard.get(doc_id)
        return self.placement.shard_of(doc_id) if s is None else s

    def _ensure(self, doc_id):
        s = self._doc_shard.get(doc_id)
        if s is None:
            s = self.placement.shard_of(doc_id)
            self._doc_shard[doc_id] = s
        return s

    def _group(self, doc_ids, create=False):
        by_shard = {}
        for doc_id in doc_ids:
            s = self._ensure(doc_id) if create else self.shard_of(doc_id)
            by_shard.setdefault(s, []).append(doc_id)
        return by_shard

    def _note_load(self, shard, doc_id, ops):
        self._window[shard] += ops
        self._heat[doc_id] = self._heat.get(doc_id, 0.0) + ops
        _metrics.bump('shard_apply_ops', ops)

    def _fire(self, docs):
        if self.handlers:
            for doc_id, doc in docs.items():
                for handler in list(self.handlers):
                    handler(doc_id, doc)

    @property
    def doc_ids(self):
        return list(self._doc_shard)

    @property
    def quarantined(self):
        out = {}
        for shard in self.shards:
            out.update(shard.quarantined)
        return out

    @property
    def diverged(self):
        out = {}
        for shard in self.shards:
            out.update(shard.diverged)
        return out

    # -- apply surface -------------------------------------------------------

    def get_doc(self, doc_id):
        s = self._ensure(doc_id)
        return self.shards[s].get_doc(doc_id)

    def apply_changes(self, doc_id, changes):
        return self.apply_changes_batch({doc_id: changes})[doc_id]

    applyChanges = apply_changes

    def apply_changes_batch(self, changes_by_doc, isolate=False):
        """Shard-routed fused apply: the batch partitions by placement
        and each shard's cut applies in ONE fused device step on that
        shard's device. Docs behind a migration fence buffer their
        changes (re-routed after the flip, never dropped) and return
        their current pre-flip handle."""
        out = {}
        routed = {}
        for doc_id, changes in changes_by_doc.items():
            if doc_id in self._fences:
                self._fences[doc_id].append(('changes', list(changes)))
                _metrics.bump('placement_fenced_changes', len(changes))
                s = self.shard_of(doc_id)
                out[doc_id] = self.shards[s].get_doc(doc_id) \
                    if doc_id in self.shards[s].id_of else None
                continue
            routed.setdefault(self._ensure(doc_id), {})[doc_id] = changes
        for s, sub in routed.items():
            applied = self.shards[s].apply_changes_batch(
                sub, isolate=isolate)
            out.update(applied)
            for doc_id, changes in sub.items():
                self._note_load(
                    s, doc_id,
                    sum(len(c.get('ops', ())) or 1 for c in changes))
        self._fire({d: h for d, h in out.items()
                    if d in changes_by_doc and h is not None})
        return out

    applyChangesBatch = apply_changes_batch

    def apply_wire(self, data, doc_ids=None):
        """Wire-batch admission across shards. A columnar (AMW2) block
        parses ONCE, then each shard's cut slices out as a CSR
        sub-block (shared literal tables, doc column remapped to the
        shard store) and applies fused on that shard's device; the
        JSON text form routes through the change-dict path. Fenced
        docs buffer their single-doc sub-block behind the migration
        fence like any other in-flight change."""
        from ..wire import COLUMNAR_MAGIC, parse_columnar_block
        from ..device import general as _general
        columnar = isinstance(data, (bytes, bytearray, memoryview)) \
            and bytes(data[:4]) == COLUMNAR_MAGIC
        if not columnar:
            text = bytes(data).decode('utf-8') \
                if isinstance(data, (bytes, bytearray, memoryview)) \
                else data
            per_doc = json.loads(text)
            if doc_ids is None:
                doc_ids = [f'doc-{i}' for i in range(len(per_doc))]
            self.apply_changes_batch(
                dict(zip(doc_ids, per_doc)))
            return [self.get_doc(d) for d in doc_ids]
        t0 = _time.perf_counter()
        with _metrics.trace_span('wire.parse', n_bytes=len(data), v=2):
            block = parse_columnar_block(data)
        n = block.n_docs
        if doc_ids is None:
            doc_ids = [f'doc-{i}' for i in range(n)]
        elif len(doc_ids) != n:
            raise ValueError(
                f'wire block carries {n} documents, got '
                f'{len(doc_ids)} doc ids')
        doc_col = np.asarray(block.doc)
        shard_of_pos = np.empty(n, np.int64)
        for pos, doc_id in enumerate(doc_ids):
            shard_of_pos[pos] = self.shard_of(doc_id) \
                if doc_id in self._fences else self._ensure(doc_id)
        for s in sorted(set(int(x) for x in shard_of_pos)):
            positions = np.flatnonzero(shard_of_pos == s)
            fenced = [p for p in positions
                      if doc_ids[p] in self._fences]
            for p in fenced:
                sel = np.flatnonzero(doc_col == p)
                if len(sel):
                    unit = _take_block(block, sel, 1,
                                       np.zeros(len(sel), np.int32))
                    self._fences[doc_ids[p]].append(('block', unit))
                    _metrics.bump('placement_fenced_changes',
                                  len(sel))
            live = [p for p in positions if doc_ids[p]
                    not in self._fences]
            if not live:
                continue
            shard = self.shards[s]
            idx_of_pos = np.full(n, -1, np.int32)
            for p in live:
                idx_of_pos[p] = shard._index(doc_ids[p], create=True)
            sel = np.flatnonzero(np.isin(doc_col, live)) \
                if len(doc_col) else np.zeros(0, np.int64)
            sub = _take_block(block, sel, shard.capacity,
                              idx_of_pos[doc_col[sel]]
                              if len(sel) else np.zeros(0, np.int32))
            with _metrics.trace_span(
                    'doc_set.apply_wire', docs=len(live), shard=s):
                _general.apply_general_block(shard.store, sub,
                                             options=shard._options)
            shard._note_births([doc_ids[p] for p in live])
            for p in live:
                self._note_load(s, doc_ids[p],
                                max(int((doc_col == p).sum()), 1))
        _metrics.observe('sync_apply_ms',
                         (_time.perf_counter() - t0) * 1e3)
        out = []
        for doc_id in doc_ids:
            if doc_id in self._fences:
                out.append(None)
                continue
            doc = self.get_doc(doc_id)
            out.append(doc)
            self._fire({doc_id: doc})
        return out

    applyWire = apply_wire

    def apply_states(self, payload_by_doc):
        out = {}
        for s, ids in self._group(payload_by_doc, create=True).items():
            out.update(self.shards[s].apply_states(
                {d: payload_by_doc[d] for d in ids}))
        self._fire(out)
        return out

    applyStates = apply_states

    def apply_state(self, doc_id, payload):
        return self.apply_states({doc_id: payload}).get(doc_id)

    applyState = apply_state

    def serve_state_payload(self, doc_id):
        s = self.shard_of(doc_id)
        return self.shards[s].serve_state_payload(doc_id)

    serveStatePayload = serve_state_payload

    def retry_quarantined(self, doc_ids=None):
        out = {}
        for shard in self.shards:
            held = [d for d in (doc_ids or shard.quarantined)
                    if d in shard.quarantined]
            if held:
                out.update(shard.retry_quarantined(held))
        return out

    # -- reads ---------------------------------------------------------------

    def materialize(self, doc_id):
        s = self.shard_of(doc_id)
        return self.shards[s].materialize(doc_id)

    def materialize_many(self, doc_ids):
        """Trees aligned with ``doc_ids`` (the batched read path),
        each shard's cut materialized in one vectorized pass on its
        own device."""
        by_doc = {}
        for s, ids in self._group(doc_ids).items():
            trees = self.shards[s].materialize_many(ids)
            by_doc.update(zip(ids, trees))
        return [by_doc[d] for d in doc_ids]

    def materialize_all(self):
        ids = list(self._doc_shard)
        return dict(zip(ids, self.materialize_many(ids)))

    def clock_of_id(self, doc_id):
        return self.shards[self.shard_of(doc_id)].clock_of_id(doc_id)

    def digest_of_id(self, doc_id):
        return self.shards[self.shard_of(doc_id)].digest_of_id(doc_id)

    def heartbeat_digests(self):
        out = {}
        for s, shard in enumerate(self.shards):
            for doc_id, dig in shard.heartbeat_digests().items():
                if self._doc_shard.get(doc_id) == s:
                    out[doc_id] = dig
        return out

    def note_divergence(self, doc_id, peer=None, local_digest=None,
                        remote_digest=None):
        return self.shards[self.shard_of(doc_id)].note_divergence(
            doc_id, peer=peer, local_digest=local_digest,
            remote_digest=remote_digest)

    def clear_divergence(self, doc_id=None):
        for shard in self.shards:
            shard.clear_divergence(doc_id)

    # -- park / eviction (shard-local) --------------------------------------

    def extract_doc_state(self, doc_ids):
        out = {}
        for s, ids in self._group(doc_ids).items():
            out.update(self.shards[s].extract_doc_state(ids))
        return out

    def drop_doc_state(self, doc_ids, chunk_docs=512):
        for s, ids in self._group(doc_ids).items():
            self.shards[s].drop_doc_state(ids, chunk_docs=chunk_docs)

    # -- connections / handlers ---------------------------------------------

    def register_connection(self, peer_id, conn):
        self.connections[peer_id] = conn

    registerConnection = register_connection

    def unregister_connection(self, peer_id, conn):
        if self.connections.get(peer_id) is conn:
            del self.connections[peer_id]

    unregisterConnection = unregister_connection

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers = self.handlers + [handler]

    registerHandler = register_handler

    def unregister_handler(self, handler):
        self.handlers = [h for h in self.handlers if h != handler]

    unregisterHandler = unregister_handler

    # -- live migration ------------------------------------------------------

    def migrate_doc(self, doc_id, dst_shard, verify=True):
        """Move one doc to ``dst_shard`` (see :meth:`migrate_docs`)."""
        return self.migrate_docs({doc_id: dst_shard},
                                 verify=verify) == 1

    def migrate_docs(self, plan, dst_shard=None, verify=True):
        """Live-migrate docs per ``plan`` (``{doc_id: dst_shard}``, or
        a list of doc ids with one ``dst_shard``); returns how many
        moved. Per doc: fence on → extract (state snapshot + retained
        tail + causal queue) → ship as a checksummed unit → absorb on
        the destination device → digest-verify against the source →
        placement flip → source drop (ONE store rebuild per source for
        the whole plan — a plan spreading docs over many destinations
        costs the same rebuilds as one destination) → fence flush
        re-routes anything that arrived mid-flight. A verify failure
        or absorb fault rolls the destination back and the source
        keeps the doc; quarantined docs refuse to travel (their held
        changes live in the source's quarantine registry)."""
        if not isinstance(plan, dict):
            plan = {doc_id: dst_shard for doc_id in plan}
        for dst in set(plan.values()):
            if dst is None or not 0 <= dst < self.n_shards:
                raise ValueError(
                    f'shard {dst} out of range [0, {self.n_shards})')
        moving = []                    # (doc_id, src, dst)
        for doc_id, dst in plan.items():
            src = self._doc_shard.get(doc_id)
            if src is None or src == dst \
                    or doc_id in self._fences \
                    or doc_id in self.shards[src].quarantined:
                continue
            moving.append((doc_id, src, dst))
        if not moving:
            return 0
        t0 = _time.perf_counter()
        moved = []                     # (doc_id, src, dst)
        by_src = {}
        for doc_id, src, dst in moving:
            by_src.setdefault(src, []).append(doc_id)
            # fence BEFORE the extract: anything arriving from here on
            # buffers and re-routes after the flip
            self._fences[doc_id] = []
        records = {}
        for src, ids in by_src.items():
            src_set = self.shards[src]
            resident = getattr(src_set, 'ensure_resident', None)
            if resident is not None:
                resident(ids)
            records.update(src_set.extract_doc_state(ids))
        for doc_id, src, dst in moving:
            src_set = self.shards[src]
            dst_set = self.shards[dst]
            try:
                unit = encode_migration_unit(records[doc_id])
                rec = decode_migration_unit(unit)
                if 'state' in rec:
                    dst_set.apply_states(
                        {doc_id: base64.b64decode(rec['state'])})
                else:
                    dst_set.apply_changes_batch(
                        {doc_id: rec.get('changes', [])})
                if rec.get('queued'):
                    dst_set.apply_changes_batch(
                        {doc_id: rec['queued']})
                if verify:
                    want = src_set.digest_of_id(doc_id)
                    got = dst_set.digest_of_id(doc_id)
                    if want is not None and got is not None \
                            and int(want) != int(got):
                        raise RuntimeError(
                            f'migration digest mismatch for '
                            f'{doc_id!r}: src={want} dst={got}')
            except Exception:
                # roll the destination back; the source never
                # released the doc, so it simply keeps serving
                if doc_id in dst_set.id_of:
                    dst_set.drop_doc_state([doc_id])
                dst_set.quarantined.pop(doc_id, None)
                self._flush_fence(doc_id)
                raise
            _metrics.bump('placement_migrations')
            _metrics.bump('placement_migrated_bytes', len(unit))
            moved.append((doc_id, src, dst))
        # atomic flips: placement answers switch doc-by-doc BEFORE the
        # source drop, so nothing ever routes into the dropped state
        for doc_id, src, dst in moved:
            self._doc_shard[doc_id] = dst
            self.placement.pin(doc_id, dst)
            self._migrations_out[src] += 1
            self._migrations_in[dst] += 1
        for src, ids in by_src.items():
            gone = [d for d in ids
                    if self._doc_shard.get(d) != src]
            if gone:
                self.shards[src].drop_doc_state(gone)
        for doc_id, _, _ in moved:
            self._flush_fence(doc_id)
        _metrics.observe('placement_migrate_ms',
                         (_time.perf_counter() - t0) * 1e3)
        if _metrics.active:
            _metrics.emit('docs_migrated',
                          plan={d: dst for d, _, dst in moved})
        return len(moved)

    migrateDoc = migrate_doc

    def _flush_fence(self, doc_id):
        from ..device import general as _general
        from ..device.blocks import ChangeBlock
        pending = self._fences.pop(doc_id, None)
        if not pending:
            return
        for kind, item in pending:
            if kind == 'changes':
                self.apply_changes_batch({doc_id: item})
            else:                      # single-doc wire sub-block
                s = self._ensure(doc_id)
                shard = self.shards[s]
                idx = shard._index(doc_id, create=True)
                remap = np.full(len(item.doc), idx, np.int32)
                widened = ChangeBlock(
                    shard.capacity, remap, item.actor, item.seq,
                    item.dep_ptr, item.dep_actor, item.dep_seq,
                    item.op_ptr, item.action, item.key, item.value,
                    item.actors, item.keys, item.values,
                    dup_keys=None, obj=item.obj,
                    key_kind=item.key_kind, key_elem=item.key_elem,
                    elem=item.elem, objs=item.objs)
                _general.apply_general_block(
                    shard.store, widened, options=shard._options)
                self._note_load(s, doc_id, max(len(item.doc), 1))

    # -- load telemetry / maintenance ---------------------------------------

    def shard_load(self):
        """Per-shard load vectors the placement knob steers on: the
        LAST completed window's admitted ops, live resident-plane
        bytes, live doc counts and migration tallies."""
        from ..device.general import mirror_bytes
        resident = [mirror_bytes(getattr(getattr(s, 'store', None),
                                         'pool', None) and
                                 s.store.pool.mirror)
                    for s in self.shards]
        docs = np.zeros(self.n_shards, np.int64)
        for s in self._doc_shard.values():
            docs[s] += 1
        return {'apply_ops': self._last_window.tolist(),
                'resident_bytes': [int(b or 0) for b in resident],
                'docs': docs.tolist(),
                'migrations_in': self._migrations_in.tolist(),
                'migrations_out': self._migrations_out.tolist(),
                'imbalance': self._imbalance}

    def hottest_docs(self, shard, k=4):
        """Top-``k`` docs of ``shard`` by decayed apply heat —
        migration candidates for the placement knob (fenced and
        quarantined docs never travel)."""
        held = self.shards[shard].quarantined
        docs = [(heat, d) for d, heat in self._heat.items()
                if self._doc_shard.get(d) == shard
                and d not in self._fences and d not in held]
        docs.sort(key=lambda t: (-t[0], t[1]))
        return [d for _, d in docs[:k]]

    def tick(self):
        """One maintenance quantum: close the load window (the
        controller's placement rule reads the completed window), decay
        doc heat, refresh the imbalance gauge, evaluate health and
        drive the attached controller."""
        self._last_window = self._window.copy()
        self._window[:] = 0
        total = int(self._last_window.sum())
        if total and self.n_shards > 1:
            self._imbalance = float(
                self._last_window.max() * self.n_shards / total)
            _metrics.set_gauge('shard_imbalance_ratio',
                               round(self._imbalance, 4))
        for doc_id in list(self._heat):
            heat = self._heat[doc_id] * 0.5
            if heat < 0.5:
                del self._heat[doc_id]
            else:
                self._heat[doc_id] = heat
        health = self.evaluate_health()
        if self.controller is not None:
            self.controller.on_quantum(health)
        return health

    # -- health (borrowed rollup code path) ---------------------------------

    _link_lag = GeneralDocSet._link_lag
    _connection_statuses = GeneralDocSet._connection_statuses
    _convergence_summary = GeneralDocSet._convergence_summary
    _health_signals = GeneralDocSet._health_signals
    evaluate_health = GeneralDocSet.evaluate_health
    evaluateHealth = evaluate_health
    health = GeneralDocSet.health

    # -- operator surface ----------------------------------------------------

    def fleet_status(self, docs=True):
        """The fleet operator surface with the placement dimension:
        shard-summed totals/memory via the
        :func:`~automerge_tpu_torch.parallel.general_shard.fleet_rollup`
        cross-shard reduction (psum over a multi-entry mesh), the
        ``placement`` block (per-shard residency/apply-rate/migration
        rows + imbalance), and per-doc rows carrying their shard id."""
        from ..device.general import mirror_bytes
        from ..parallel.general_shard import fleet_rollup
        docs_per = np.zeros(self.n_shards, np.int64)
        for s in self._doc_shard.values():
            docs_per[s] += 1
        stats = np.zeros((self.n_shards, 7), np.int64)
        for s, shard in enumerate(self.shards):
            store = shard.store
            n = len(shard.ids)
            stats[s, 0] = int((shard._view_ver[:n] !=
                               store._doc_version[:n]).sum()) if n else 0
            stats[s, 1] = len(shard.quarantined)
            stats[s, 2] = len(shard.diverged)
            mir = getattr(getattr(store, 'pool', None), 'mirror', None)
            stats[s, 3] = mirror_bytes(mir)
            stats[s, 4] = getattr(store, '_wire_cache_bytes', 0)
            stats[s, 5] = store.state_snapshot_bytes() \
                if hasattr(store, 'state_snapshot_bytes') else 0
            stats[s, 6] = len(getattr(store, 'horizon', ()))
        totals = fleet_rollup(self.mesh, stats)
        out = {
            'totals': {'docs': len(self._doc_shard),
                       'capacity': self.capacity,
                       'quarantined': int(totals[1]),
                       'diverged': int(totals[2]),
                       'dirty': int(totals[0])},
            'connections': self._connection_statuses(),
            'latency': _latency_quantiles(
                ('sync_apply_ms', 'sync_flush_ms',
                 'sync_convergence_ms', 'placement_migrate_ms',
                 'device_dispatch_ms', 'device_run_ms')),
            'memory': {'device_plane_bytes': int(totals[3]),
                       'wire_cache_bytes': int(totals[4]),
                       'state_snapshot_bytes': int(totals[5]),
                       'compacted_docs': int(totals[6])},
            'convergence': self._convergence_summary(),
            'health': self.evaluate_health(),
            'placement': {
                'n_shards': self.n_shards,
                'mesh_devices': self.mesh.devices.size,
                'overrides': len(self.placement.pins),
                'imbalance': round(self._imbalance, 4),
                'migrations': int(self._migrations_in.sum()),
                'per_shard': [
                    {'shard': s,
                     'device': str(self.devices[s])
                     if self.devices[s] is not None else None,
                     'docs': int(docs_per[s]),
                     'resident_bytes': int(stats[s, 3]),
                     'apply_ops': int(self._last_window[s]),
                     'quarantined': int(stats[s, 1]),
                     'dirty': int(stats[s, 0]),
                     'migrations_in': int(self._migrations_in[s]),
                     'migrations_out': int(self._migrations_out[s])}
                    for s in range(self.n_shards)]}}
        if docs:
            doc_map = {}
            for s, shard in enumerate(self.shards):
                clocks = shard.store.clocks_all()
                for idx, doc_id in enumerate(shard.ids):
                    if self._doc_shard.get(doc_id) != s:
                        continue       # migrated-away ghost entry
                    held = shard.quarantined.get(doc_id)
                    doc_map[doc_id] = {
                        'clock': dict(clocks.get(idx, {})),
                        'quarantined': held['error'] if held else None,
                        'dirty': bool(shard._view_ver[idx] !=
                                      shard.store._doc_version[idx]),
                        'shard': s}
            out['docs'] = doc_map
        return out

    fleetStatus = fleet_status

    # -- packed snapshot -----------------------------------------------------

    def save_snapshot(self):
        return json.dumps({
            'format': _SNAP_FORMAT,
            'placement': self.placement.snapshot(),
            'capacity': self.capacity,
            'doc_shard': dict(self._doc_shard),
            'shards': [base64.b64encode(
                s.save_snapshot()).decode('ascii')
                for s in self.shards],
        }).encode('utf-8')

    saveSnapshot = save_snapshot

    @classmethod
    def load_snapshot(cls, data, options=None, mesh=None, device=None):
        """Rebuild a fleet from :meth:`save_snapshot` bytes (either
        package's: the format is shared); shard *i* resumes on
        ``shard_device(mesh, i)``, the mesh defaulting as in the
        constructor."""
        snap = json.loads(bytes(data).decode('utf-8'))
        if snap.get('format') != _SNAP_FORMAT:
            raise ValueError(
                f'unknown snapshot format {snap.get("format")!r}')
        place = PlacementMap.restore(snap['placement'])
        out = cls(snap['capacity'], n_shards=place.n_shards,
                  mesh=mesh, options=options, device=device)
        out.placement = place
        out._doc_shard = {d: int(s)
                          for d, s in snap['doc_shard'].items()}
        out.shards = [GeneralDocSet.load_snapshot(
            base64.b64decode(s), options=options, device=dev)
            for s, dev in zip(snap['shards'], out.devices)]
        return out

    loadSnapshot = load_snapshot
