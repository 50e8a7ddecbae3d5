"""General bulk engine: sequences, nested objects and links on the
million-op block path.

The flat block engine (:mod:`.blocks`) covers root-map documents; this
module is the same architecture — vectorized causal admission, ONE fused
device program, columnar patches — for the FULL op set of the reference
backend (`applyOps`, op_set.js:221-238): ``makeMap/makeList/makeText``,
``ins``, ``set/del/link`` on any object. A million-keystroke text
history with causal deps, nested object graphs across thousands of
documents, and plain map batches all take the same path.

Representation choices that make it columnar:

* **Objects** are store rows interned per (doc, uuid); the object table
  carries type/doc/inbound. Object count is bounded by 2^22 (same as
  the doc key space).
* **Field keys** pack into one int64: ``(obj_row << 32) | (is_elem <<
  31) | id`` where ``id`` is an interned string key (maps) or the
  element's LOCAL NODE INDEX in its object's insertion tree (node
  indexes are append-only, hence stable) — so field identity, touched-
  set membership and segment grouping are plain sorts/searchsorted on
  one integer column, never string or tuple comparisons.
* **Insertion trees** live POOLED across all sequence objects as
  store-level node columns (:class:`_SeqPool`) with a sorted
  (obj, local) position index — appends, elemId lookups, dup checks and
  RGA job-plane packing are whole-batch array passes over every dirty
  object at once, not per-object loops. The device-side RGA kernel
  (:mod:`.sequence`) orders each dirty object in O(log n) parallel
  rounds, replacing the reference's per-element skip-list walks
  (op_set.js:379-425, skip_list.js).
* **Resolution** of every touched field of every document is one flat
  segment-reduction program (:mod:`.merge`), with element visibility
  derived on device and every dirty sequence re-ordered in the same
  jitted call — the general-path analogue of the per-doc backend's
  fused step (backend.py `_fused_step`).

Conformance: same contracts as the flat path — causal buffering with
retry (op_set.js:267-283), duplicate verification (op_set.js:243-248),
self-conflicts for within-change double assignment, winner = highest
actor rank with stable first-op tie-break (op_set.js:211). Sequence
diffs are the compacted remove/insert/set stream of the per-doc backend
(remove at old indexes descending, insert at final indexes ascending,
then sets), plus the ``maxElem`` extension. A malformed block (unknown
object, duplicate creation, duplicate elemId, unknown parent element)
raises and leaves the store EXACTLY as it was — admission effects
(clock, log, queue, retained blocks, interned tables) roll back, so a
valid retry is never mis-dropped as a duplicate.

Undo/redo and local-change requests stay per-document: this engine is
the bulk ingestion path behind ``applyChanges`` — exactly the role
`DocSet.applyChanges` plays in the reference (src/doc_set.js:25-33), at
block scale.

This is the PyTorch port of ``automerge_tpu/device/general.py``. The
host staging (admission, the pool, the native stager, the wire buffer)
is the JAX package's code, copied; the device programs are PyTorch
functions on the store's ``device`` (CUDA unless the caller asks for
the CPU), and the patch read's edit stream runs the hand-written CUDA
kernel of :mod:`.cuda_view` on the card. All three mirror formats are
ported (packed, wide and cols, converted in place when a store crosses
a format bound), with both order updates: the whole-object REBUILD of a
dirty sequence (the RGA kernel) and the INCREMENTAL index update of the
persistent 'tp' plane (the RGA kernel's delta mode), optionally bounded
to a suffix window; ``_INDEX_MODE`` and ``_WINDOW_MODE`` pick the arms
as in the reference. The async apply (:func:`apply_general_block_async`)
runs applies on a per-store applier thread.
"""

import threading

import numpy as np
import torch

from ..common import ROOT_ID
from ..config import resolve_device
from ..utils.metrics import metrics
from . import engine as _engine
from . import profiler as _profiler
from . import blocks as _blocks
from .blocks import (
    ChangeBlock, BlockStore, ValueTable, _intern, _span_indices,
    _admit_and_stage, check_block_ranges,
    _SET, _DEL, _INS, _LINK, _MAKE_MAP, _MAKE_LIST, _MAKE_TEXT,
    _GEN_ACTION_NAMES, _KEY_STR, _KEY_ELEM, _KEY_HEAD, _KEY_NONE)

_TYPE_MAP, _TYPE_LIST, _TYPE_TEXT = 0, 1, 2
_MAKE_TYPE = {_MAKE_MAP: _TYPE_MAP, _MAKE_LIST: _TYPE_LIST,
              _MAKE_TEXT: _TYPE_TEXT}
_TYPE_NAME = {_TYPE_MAP: 'map', _TYPE_LIST: 'list', _TYPE_TEXT: 'text'}

_ELEM_BIT = np.int64(1) << 31
_HEAD_KEY = np.int64(-1) << 32        # pool key of a head node (actor -1)


class _SeqPool:
    """ALL sequence objects' insertion trees, pooled into store-level
    node columns (the batch-vectorized replacement for per-object
    states; VERDICT r3 #1).

    Columns are global over every node of every list/text object:
    ``obj`` (owning object row), ``local`` (node index within the
    object; 0 is the virtual head), ``parent`` (LOCAL index), ``actor``
    (store actor id, -1 for heads), ``elemc`` (elem counter), and the
    CURRENT visibility/order (``visible``/``vis_index``, -1 hidden).
    ``pos_row`` holds global row ids sorted by the packed (obj << 32 |
    local) position key (``pos_sorted``) — so any set of objects'
    node rows gather as contiguous spans, in local order, with one
    searchsorted: per-object views, elemId resolution tables and RGA
    job planes are all single vectorized gathers.

    The trees are DEVICE-RESIDENT between applies (``mirror``): the
    node columns live in HBM in POSITION order (obj-major, so every
    object's nodes are one contiguous slice), each apply ships only the
    NEW nodes plus their insert positions, and the fused program
    rebuilds the order, gathers its own job planes, and scatters the
    updated visibility back — a growing collab session ships O(block)
    bytes per apply, not O(total tree). The host visibility columns
    materialize lazily from the mirror (``sync``), so an apply-only
    pipeline never pays a D2H. Appends come in whole-batch calls
    (obj-grouped, local-ascending), merged into the position index with
    one searchsorted + insert.
    """

    __slots__ = ('obj', 'local', 'parent', 'actor', 'elemc', 'visible',
                 'vis_index', 'tpos', 'idx_ok', 'idx_linear',
                 'pos_sorted', 'pos_row',
                 'n_of', 'max_elem_of', 'max_tree', 'max_elem',
                 'mirror', '_epoch', '_host_epoch', '_tpos_epoch',
                 '_lock', '_elem_cache')

    def __init__(self):
        # host lock shared with the owning store: serializes the apply
        # host phase, the deferred commit and this sync against patch
        # extraction running on another thread (apply_general_block_async)
        self._lock = threading.RLock()
        z32 = np.zeros(0, np.int32)
        self.obj = z32
        self.local = z32
        self.parent = z32
        self.actor = z32
        self.elemc = z32
        self.visible = np.zeros(0, bool)
        self.vis_index = z32
        # host materialization of the device-resident ORDER index
        # (tree_pos per node; fetched on demand by sync_index — the
        # snapshot/compaction path, never the per-tick read path)
        self.tpos = z32
        # per-OBJECT: the mirror's 'tp' plane holds this object's true
        # tree positions (the incremental-update eligibility bit; False
        # forces a whole-object _rga_order rebuild on next touch)
        self.idx_ok = np.zeros(0, bool)
        # per-OBJECT: the tree is a pure chain (parent[local] ==
        # local - 1 for every real node), so tree position == local
        # and a suffix of locals is a suffix of tree positions — the
        # eligibility bit of the suffix-bounded visibility renumber.
        # Maintained in O(appended) by _append; never un-falsed (a
        # branch is permanent until compaction rebuilds the object).
        self.idx_linear = np.zeros(0, bool)
        # per-OBJECT staging cache: obj -> [keys_sorted, locals], the
        # sorted (actor << 32 | elem) -> local index both stagers
        # consult in O(delta) instead of re-tabulating every node of
        # every dirty object per tick. Built post-apply for dirty
        # objects, extended in place by append_batch, dropped
        # wholesale on rollback (see _Txn) and on snapshot restore
        # (fresh pool). Heads are excluded (never a lookup target).
        self._elem_cache = {}
        self.pos_sorted = np.zeros(0, np.int64)
        self.pos_row = np.zeros(0, np.int64)
        self.n_of = np.zeros(0, np.int64)        # per OBJECT row
        self.max_elem_of = np.zeros(0, np.int64)
        self.max_tree = 0        # pool-wide max n_of (packed-fmt guard)
        self.max_elem = 0        # pool-wide max elemc (packed-fmt guard)
        # device mirror: {'cap', 'n', 'parent', 'elemc', 'actor',
        # 'visible', 'vis_index' (device arrays, POS order), 'rank_n'}
        # (+ 'tp': int32 tree_pos per node on packed/wide — the
        # persistent order-statistic index the incremental update
        # maintains across ticks)
        self.mirror = None
        self._epoch = 0          # bumped per apply that dirtied trees
        self._host_epoch = 0     # host visible/vis_index currency
        self._tpos_epoch = 0     # host tpos currency (sync_index)

    @property
    def n_nodes(self):
        return len(self.obj)

    def grow_objects(self, n_objs):
        if len(self.n_of) < n_objs:
            pad = n_objs - len(self.n_of)
            self.n_of = np.concatenate(
                [self.n_of, np.zeros(pad, np.int64)])
            self.max_elem_of = np.concatenate(
                [self.max_elem_of, np.zeros(pad, np.int64)])
            # a fresh object has no device-resident index yet
            self.idx_ok = np.concatenate(
                [self.idx_ok, np.zeros(pad, bool)])
            self.idx_linear = np.concatenate(
                [self.idx_linear, np.zeros(pad, bool)])

    def _append(self, obj, local, parent, actor, elemc):
        base = len(self.obj)
        n = len(obj)
        self.obj = np.concatenate([self.obj, obj])
        self.local = np.concatenate([self.local, local])
        self.parent = np.concatenate([self.parent, parent])
        self.actor = np.concatenate([self.actor, actor])
        self.elemc = np.concatenate([self.elemc, elemc])
        self.visible = np.concatenate([self.visible, np.zeros(n, bool)])
        self.vis_index = np.concatenate(
            [self.vis_index, np.full(n, -1, np.int32)])
        self.tpos = np.concatenate([self.tpos, np.zeros(n, np.int32)])
        keys = (obj.astype(np.int64) << 32) | local
        new_rows = base + np.arange(n, dtype=np.int64)
        m = len(self.pos_sorted)
        if (m == 0 or keys[0] > self.pos_sorted[-1]) and \
                (n == 1 or (keys[1:] > keys[:-1]).all()):
            # tail append (sequential typing): skip np.insert's fancy
            # index handling — a plain concat keeps the order
            self.pos_sorted = np.concatenate([self.pos_sorted, keys])
            self.pos_row = np.concatenate([self.pos_row, new_rows])
        else:
            pos = np.searchsorted(self.pos_sorted, keys)
            self.pos_sorted = np.insert(self.pos_sorted, pos, keys)
            self.pos_row = np.insert(self.pos_row, pos, new_rows)
        # chain-shape maintenance, O(appended): any node whose parent
        # is not its predecessor permanently branches the object
        ok_chain = (local == 0) | (parent == local - 1)
        np.logical_and.at(self.idx_linear, obj, ok_chain)

    def create_heads(self, rows):
        """Batch-create the virtual head node of NEW sequence objects
        (`rows` ascending)."""
        if not len(rows):
            return
        self.grow_objects(int(rows.max()) + 1)
        z = np.zeros(len(rows), np.int32)
        self._append(rows.astype(np.int32), z, z,
                     np.full(len(rows), -1, np.int32), z)
        self.n_of[rows] = 1
        self.idx_linear[rows] = True     # a lone head is a chain
        self.max_tree = max(self.max_tree, 1)

    def append_batch(self, obj, local, parent_local, actor, elemc):
        """Append new nodes, whole batch: `obj` ascending, `local`
        ascending within each object (= n_of[obj] + position)."""
        if not len(obj):
            return
        self._append(obj.astype(np.int32), local.astype(np.int32),
                     parent_local.astype(np.int32), actor.astype(np.int32),
                     elemc.astype(np.int32))
        run_start = np.concatenate([[True], obj[1:] != obj[:-1]])
        starts = np.flatnonzero(run_start)
        ends = np.append(starts[1:], len(obj)) - 1
        uo = obj[starts]
        self.n_of[uo] = local[ends] + 1
        seg_max = np.maximum.reduceat(elemc, starts)
        self.max_elem_of[uo] = np.maximum(self.max_elem_of[uo], seg_max)
        self.max_tree = max(self.max_tree, int(local[ends].max()) + 1)
        self.max_elem = max(self.max_elem, int(seg_max.max()))
        # staging-cache upkeep in O(new): resident per-object elemId
        # indexes absorb the appended nodes (sequential typing appends
        # ascending keys — a pure tail concat)
        if self._elem_cache:
            for k, o in enumerate(uo.tolist()):
                ent = self._elem_cache.get(o)
                if ent is None:
                    continue
                s, e = starts[k], ends[k] + 1
                nk = (actor[s:e].astype(np.int64) << 32) | \
                    elemc[s:e].astype(np.int64)
                nl = local[s:e].astype(np.int64)
                if len(nk) > 1 and not (nk[1:] > nk[:-1]).all():
                    o2 = np.argsort(nk, kind='stable')
                    nk, nl = nk[o2], nl[o2]
                keys0, locs0 = ent
                if not len(keys0) or nk[0] > keys0[-1]:
                    ent[0] = np.concatenate([keys0, nk])
                    ent[1] = np.concatenate([locs0, nl])
                else:
                    p = np.searchsorted(keys0, nk)
                    ent[0] = np.insert(keys0, p, nk)
                    ent[1] = np.insert(locs0, p, nl)

    def rows_of_objs(self, objs):
        """(global rows, node counts): all nodes of `objs`, grouped in
        the given object order, local-ascending within each."""
        objs = np.asarray(objs, np.int64)
        lo = np.searchsorted(self.pos_sorted, objs << 32)
        counts = self.n_of[objs]
        return self.pos_row[_span_indices(lo, counts)], counts

    def row_at(self, obj, local):
        """Global row of one (obj, local) node."""
        pos = np.searchsorted(self.pos_sorted,
                              (np.int64(obj) << 32) | np.int64(local))
        return int(self.pos_row[pos])

    def node_keys(self, rows):
        """Packed (actor << 32 | elem) elemId keys of `rows` (heads get
        the _HEAD_KEY sentinel, distinct from every real key)."""
        return (self.actor[rows].astype(np.int64) << 32) | \
            self.elemc[rows].astype(np.int64)

    def elem_index(self, obj):
        """The staging cache of one object: sorted ``(actor << 32 |
        elem)`` keys and their node locals (heads excluded). Builds
        once in O(n_of[obj]); ``append_batch`` extends resident
        entries in O(new), so warm-doc stagers resolve parents and
        check duplicates in O(delta log n)."""
        ent = self._elem_cache.get(obj)
        if ent is None:
            rows, _ = self.rows_of_objs(np.asarray([obj], np.int64))
            real = self.actor[rows] >= 0
            rows = rows[real]
            keys = (self.actor[rows].astype(np.int64) << 32) | \
                self.elemc[rows].astype(np.int64)
            order = np.argsort(keys, kind='stable')
            ent = [keys[order],
                   self.local[rows][order].astype(np.int64)]
            self._elem_cache[obj] = ent
        return ent

    def sync(self):
        """Materialize the device mirror's visibility/order into the
        host columns (once per apply epoch; idempotent). The mirror is
        pos-ordered; ``pos_row`` maps it back to global row coords.
        Nodes appended since the mirror's last apply keep their
        initial (hidden) host state — the mirror rows cover exactly
        the first ``mirror['n']`` positions."""
        with self._lock:
            if self._host_epoch == self._epoch or self.mirror is None:
                return
            self._host_epoch = self._epoch
            n = self.mirror['n']
            fmt = self.mirror.get('fmt')
            if fmt == 'packed':
                # ONE 4B/node fetch; the vis word host-unpacks for free
                w2 = _to_host(self.mirror['w2'][:n])
                vis, idx = unpack_w2_word(w2)
            elif fmt == 'wide':
                # same 4B/node fetch: W2 carries visible + vis_index
                w2 = _to_host(self.mirror['w2'][:n])
                vis, idx = unpack_wide_word(w2)
            else:
                vis, idx = _fetch((self.mirror['visible'][:n],
                                   self.mirror['vis_index'][:n]))
            # the mirror's OWN pos_row snapshot: appends since the apply
            # (e.g. single obj_row creates) must not shift the mapping
            rows = self.mirror['pos_row'][:n]
            self.visible[rows] = np.asarray(vis)
            self.vis_index[rows] = np.asarray(idx)

    def sync_index(self):
        """Materialize the device-resident ORDER index (the mirror's
        'tp' tree_pos plane) into the host ``tpos`` column — the
        snapshot/compaction counterpart of :meth:`sync`, fetched on
        demand so the per-tick read path never pays the extra D2H.
        Host ``tpos`` values are meaningful exactly for objects whose
        ``idx_ok`` bit is set (the same validity contract as the
        device plane)."""
        with self._lock:
            if self.mirror is None or 'tp' not in self.mirror:
                return
            if self._tpos_epoch == self._epoch:
                return
            self._tpos_epoch = self._epoch
            n = self.mirror['n']
            tp = _to_host(self.mirror['tp'][:n])
            rows = self.mirror['pos_row'][:n]
            self.tpos[rows] = tp


def _exact_lookup(t_obj, t_key, t_val, q_obj, q_key, n_objs):
    """Exact-match (obj, key) -> val lookup, whole batch: `t_*` is an
    UNSORTED table with unique (obj, key) rows, `*_obj` are DENSE object
    indexes < n_objs. One composite sort when the pair packs into
    uint64, one lexsort otherwise. Returns per-query val (-1 miss) and
    a within-table duplicate flag (True if the table itself held two
    equal (obj, key) rows — the caller's dup check)."""
    q = len(q_key)
    n = len(t_key)
    out = np.full(q, -1, np.int64)
    if n == 0:
        return out, False
    # keys shift to >= 0: real keys are >= 0, the head sentinel maps to 0
    t_k = np.where(t_key == _HEAD_KEY, 0, t_key + 1)
    q_k = np.where(q_key == _HEAD_KEY, 0, q_key + 1)
    kmax = max(int(t_k.max()), int(q_k.max()) if q else 0)
    if n_objs <= (1 << 11) and kmax < (1 << 53):
        # composite: key < 2^53 (actor < 2^21, elem < 2^31), obj < 2^11
        t_comp = (t_obj.astype(np.uint64) << np.uint64(53)) | \
            t_k.astype(np.uint64)
        order = np.argsort(t_comp, kind='stable')
        t_sorted = t_comp[order]
        dup = bool(n > 1 and (t_sorted[1:] == t_sorted[:-1]).any())
        if q:
            q_comp = (q_obj.astype(np.uint64) << np.uint64(53)) | \
                q_k.astype(np.uint64)
            pos = np.minimum(np.searchsorted(t_sorted, q_comp), n - 1)
            hit = t_sorted[pos] == q_comp
            out[hit] = t_val[order[pos[hit]]]
        return out, dup
    # wide path: objects do not fit the packed composite
    isq = np.zeros(n + q, bool)
    isq[n:] = True
    obj = np.concatenate([t_obj, q_obj])
    key = np.concatenate([t_k, q_k])
    order = np.lexsort((isq, key, obj))
    is_t = ~isq[order]
    t_pos = np.flatnonzero(is_t)
    dup = bool(len(t_pos) > 1 and
               ((obj[order[t_pos[1:]]] == obj[order[t_pos[:-1]]]) &
                (key[order[t_pos[1:]]] == key[order[t_pos[:-1]]])).any())
    if q:
        last_t = np.maximum.accumulate(
            np.where(is_t, np.arange(n + q), -1))
        qsel = np.flatnonzero(isq[order])
        cand = last_t[qsel]
        qidx = order[qsel] - n
        ok = cand >= 0
        cnd = order[np.maximum(cand, 0)]
        ok &= (obj[cnd] == q_obj[qidx]) & (key[cnd] == q_k[qidx])
        out[qidx[ok]] = t_val[cnd[ok]]
    return out, dup


class _Txn:
    """Rollback snapshot for the store-intact-on-error contract: a
    malformed block that fails validation AFTER admission merged it into
    the clock/log must leave the store exactly as before the apply (else
    a later valid retry is silently dropped as a duplicate — the r3
    advisor's data-loss finding). Capture is O(changed-state refs) plus
    two small copies (clock seqs, pool per-object counters)."""

    def __init__(self, store):
        pool = store.pool
        self.pending = store._pending_commit
        self.pool_mirror = pool.mirror
        self.pool_epochs = (pool._epoch, pool._host_epoch)
        self.queue = list(store.queue)
        # clock rollback is journaled, not copied: clock_merge records
        # (positions, old seqs, old purity, array refs) for every
        # in-place scatter, so the snapshot is the refs + an empty
        # journal — O(delta) per apply instead of O(clock table)
        self.c_doc, self.c_actor = store.c_doc, store.c_actor
        self.c_seq, self.c_pure = store.c_seq, store.c_pure
        store._c_journal = []
        self.log = (store.l_key, store.l_order, store._l_sorted,
                    list(store._l_pending), store.l_dep_ptr,
                    store.l_dep_actor, store.l_dep_seq)
        self.n_retained = len(store.retained)
        self.n_actors = len(store.actors)
        self.n_keys = len(store.keys)
        self.v_mark = store.values._mark()
        self.n_objs = len(store.obj_uuid)
        self.root_row = store._root_row.copy()
        self.entries = (store.e_doc, store.e_obj, store.e_key,
                        store.e_actor, store.e_seq, store.e_value,
                        store.e_link, store.e_change)
        self.pool_cols = (pool.obj, pool.local, pool.parent, pool.actor,
                          pool.elemc, pool.visible, pool.vis_index,
                          pool.tpos, pool.pos_sorted, pool.pos_row)
        self.pool_n = (pool.n_of.copy(), pool.max_elem_of.copy(),
                       pool.max_tree, pool.max_elem,
                       pool.idx_ok.copy(), pool._tpos_epoch,
                       pool.idx_linear.copy())
        # digest fold is copy-on-fold and reads never interleave an
        # apply, so the array REFERENCE plus the pending length is a
        # complete rollback record — no per-apply copy
        self.digest = store._digest
        self.n_digest_pending = len(store._digest_pending)

    def rollback(self, store):
        pool = store.pool
        # restore the deferred-commit record alongside the entry refs:
        # the store returns to "previous apply dispatched, uncommitted",
        # and the (idempotent) commit replays on the next entry read
        store._pending_commit = self.pending
        # the device mirror is only replaced AFTER the (raise-free)
        # dispatch, but restore it — and the sync epochs — anyway so a
        # partially-staged apply leaves the resident state exactly as
        # found (an intervening pool.sync() was committed-state
        # materialization and stays correct under the restored refs)
        store.pool.mirror = self.pool_mirror
        store.pool._epoch, store.pool._host_epoch = self.pool_epochs
        store.queue = self.queue
        # undo the journaled in-place clock scatters (each entry
        # carries its own array refs, so undo is correct even after
        # the miss path replaced the store's arrays), then restore
        for ph, old_seq, old_pure, arr_seq, arr_pure in \
                reversed(store._c_journal):
            arr_seq[ph] = old_seq
            arr_pure[ph] = old_pure
        store._c_journal = []
        store.c_doc, store.c_actor, store.c_seq = (self.c_doc,
                                                   self.c_actor,
                                                   self.c_seq)
        store.c_pure = self.c_pure
        (store.l_key, store.l_order, store._l_sorted, store._l_pending,
         store.l_dep_ptr, store.l_dep_actor, store.l_dep_seq) = self.log
        del store.retained[self.n_retained:]
        store._body_index_cache = (0, None)
        for s in store.actors[self.n_actors:]:
            del store.actor_of[s]
        del store.actors[self.n_actors:]
        for s in store.keys[self.n_keys:]:
            del store.key_of[s]
        del store.keys[self.n_keys:]
        store.values._restore(self.v_mark)
        for d, u in zip(store.obj_doc[self.n_objs:],
                        store.obj_uuid[self.n_objs:]):
            del store.obj_of[(d, u)]
        del store.obj_uuid[self.n_objs:]
        del store.obj_doc[self.n_objs:]
        del store.obj_type[self.n_objs:]
        store._root_row = self.root_row
        store._obj_arr_cache = (0, None, None)
        store._wire_obj_cache = None
        (store.e_doc, store.e_obj, store.e_key, store.e_actor,
         store.e_seq, store.e_value, store.e_link,
         store.e_change) = self.entries
        (pool.obj, pool.local, pool.parent, pool.actor, pool.elemc,
         pool.visible, pool.vis_index, pool.tpos, pool.pos_sorted,
         pool.pos_row) = self.pool_cols
        (pool.n_of, pool.max_elem_of, pool.max_tree,
         pool.max_elem, pool.idx_ok, pool._tpos_epoch,
         pool.idx_linear) = self.pool_n
        # the staging caches may hold nodes the rollback just unminted
        # — drop them wholesale (cold rebuild on next touch)
        pool._elem_cache.clear()
        store._digest = self.digest
        store._e_sorted = None
        del store._digest_pending[self.n_digest_pending:]


class GeneralStore(BlockStore):
    """Struct-of-arrays state for a batch of FULL documents (maps,
    lists, text, nested objects). Extends the flat BlockStore's
    admission machinery (clock, queue, retained log) with an object
    table, packed general field keys and the pooled insertion trees
    (:class:`_SeqPool`). The device mirror and every fused output live
    on ``device`` (:func:`~..config.resolve_device`: CUDA by default)."""

    def __init__(self, n_docs, retain_log=True, device=None):
        super().__init__(n_docs, retain_log=retain_log, device=device)
        self.e_key = np.zeros(0, np.int64)       # packed general keys
        self.e_obj = np.zeros(0, np.int32)       # store object row
        self.e_link = np.zeros(0, bool)          # entry value is a link
        # object table
        self.obj_of = {}                         # (doc, uuid) -> row
        self.obj_uuid = []
        self.obj_doc = []
        self.obj_type = []
        self.obj_inbound = {}                    # row -> [(parent_row, key)]
        self.pool = _SeqPool()                   # all insertion trees
        self._host_lock = self.pool._lock        # one lock, store-wide
        self._root_row = np.full(n_docs, -1, np.int64)
        self._obj_arr_cache = (0, None, None)
        self._wire_obj_cache = None
        # per-document applied version: bumped for exactly the doc
        # indexes an apply touched (the dirty-doc signal view caches
        # key on — see GeneralDocSet materialization). Monotone per
        # store; a failed apply rolls back BEFORE the bump, so cached
        # views stay valid across the rollback path.
        self._doc_version = np.zeros(n_docs, np.int64)
        self._apply_seq = 0
        # deferred survivor commit of the LAST apply: the entry update
        # waits on a 33KB device fetch, so it is postponed until the
        # next reader of the entry columns — host staging of block n+1
        # overlaps device resolution of block n (the async
        # frontend/backend overlap of SURVEY §2 P3, engine-side)
        self._pending_commit = None
        # sorted packed-field index over the entry columns:
        # (e_obj ref anchor, field keys ascending, entry rows aligned).
        # The prior-entry match consults it in O(touched log E) instead
        # of re-packing every entry's field key per tick; the commit
        # maintains it in O(delta log E) and drops it (None) whenever
        # a cheap in-place update isn't possible — next apply rebuilds.
        # The ref anchor invalidates it for free on rollback/restore
        # (those replace e_obj wholesale).
        self._e_sorted = None

    def _commit_pending(self, _surv_u8=None):
        """Fetch the pending apply's survivor bits and fold its entry
        update into the store (idempotent; replayable after rollback).
        ``_surv_u8`` lets a reader that already fetched the survivor
        bytes (batched into its own round trip) pass them in."""
        with self._host_lock:
            return self._commit_pending_locked(_surv_u8)

    def _commit_pending_locked(self, _surv_u8=None):
        pc = self._pending_commit
        if pc is None:
            return
        self._pending_commit = None
        n_rows = pc['n_rows']
        surviving = np.unpackbits(np.asarray(
            _surv_u8 if _surv_u8 is not None
            else _to_host(pc['surv_u8_dev'])))[:n_rows] \
            .astype(bool)
        s_rows = np.flatnonzero(surviving)
        patch = pc['patch']
        raw = patch._raw
        if raw is not None:
            raw['surviving'] = surviving
            raw['s_rows'] = s_rows
        cat, order = pc['cat'], pc['order']
        if cat['link'].any():       # link bookkeeping: rare
            _update_inbound(self, patch, pc['touched_fields'], surviving,
                            pc['r_seg'], cat['link'][order],
                            cat['value'][order], s_rows)
        prior_rows = pc['prior_rows']
        n_e0 = pc['n_entries']
        sel = order[s_rows]          # survivor rows, in cat coordinates
        n_drop = len(prior_rows)
        if n_drop == 0:
            def upd(col, tail):
                return np.concatenate([col, tail])
        elif n_drop > 512:
            # bulk replace (resync-scale): one boolean pass
            keep_e = np.ones(n_e0, bool)
            keep_e[prior_rows] = False

            def upd(col, tail):
                return np.concatenate([col[keep_e], tail])
        else:
            # warm tick: a handful of dropped rows — kept-segment
            # slices instead of an O(entries) boolean gather per column
            starts = np.concatenate([[0], prior_rows + 1]).tolist()
            ends = np.append(prior_rows, n_e0).tolist()

            def upd(col, tail):
                parts = [col[s:e] for s, e in zip(starts, ends)]
                parts.append(tail)
                return np.concatenate(parts)
        self.e_doc = upd(self.e_doc, cat['doc'][sel])
        old_e_obj = self.e_obj
        self.e_obj = upd(self.e_obj, cat['obj'][sel])
        self.e_key = upd(self.e_key, cat['key'][sel])
        self.e_actor = upd(self.e_actor, cat['actor'][sel])
        self.e_seq = upd(self.e_seq, cat['seq'][sel])
        self.e_value = upd(self.e_value, cat['value'][sel])
        self.e_link = upd(self.e_link, cat['link'][sel])
        self.e_change = upd(self.e_change, cat['change'][sel])

        # sorted field-index upkeep in O(delta log E): drop the prior
        # entries at their (already known) sorted positions, compact
        # the surviving row ids, insert the appended entries. Any
        # shape this can't do cheaply drops the index — the next
        # commit rebuilds it once.
        srt = self._e_sorted
        drop_pos = pc.get('srt_drop_pos')
        if (srt is not None and drop_pos is not None
                and srt[0] is old_e_obj
                and n_drop <= 4096 and len(sel) <= 65536):
            if n_drop:
                vals_k = np.delete(srt[1], drop_pos)
                rows_k = np.delete(srt[2], drop_pos)
                rows_k = rows_k - np.searchsorted(prior_rows, rows_k)
            else:
                vals_k, rows_k = srt[1], srt[2]
            new_vals = (cat['obj'][sel].astype(np.int64) << 32) | \
                cat['key'][sel]
            new_rows = (n_e0 - n_drop) + \
                np.arange(len(sel), dtype=np.int64)
            if len(new_vals) and len(vals_k) \
                    and new_vals[0] > vals_k[-1] \
                    and (len(new_vals) == 1
                         or (new_vals[1:] >= new_vals[:-1]).all()):
                # fresh fields sort past every resident one (interned
                # key ids grow monotonically) — pure tail extension
                self._e_sorted = (self.e_obj,
                                  np.concatenate([vals_k, new_vals]),
                                  np.concatenate([rows_k, new_rows]))
            else:
                p = np.searchsorted(vals_k, new_vals)
                self._e_sorted = (self.e_obj,
                                  np.insert(vals_k, p, new_vals),
                                  np.insert(rows_k, p, new_rows))
        elif _blocks._delta_host_on():
            ef = (self.e_obj.astype(np.int64) << 32) | self.e_key
            ordv = np.argsort(ef, kind='stable')
            self._e_sorted = (self.e_obj, ef[ordv],
                              ordv.astype(np.int64))
        else:
            self._e_sorted = None

    # -- packed snapshot -----------------------------------------------------

    def save_snapshot(self):
        """Serialize the WHOLE store — entries, object table, pooled
        insertion trees (host-synced visibility), clock, closure CSR,
        interned tables, causal buffer — to bytes. Resume is
        replay-free (O(state)); change bodies are dropped, so a
        resumed store serves peers forward from here only (same
        contract as the dense-store snapshot and the per-doc
        device snapshot — SURVEY §5 checkpoint/resume)."""
        import io
        import json as _json2
        self._commit_pending()
        self.pool.sync()
        self.pool.sync_index()       # order index rides the snapshot:
        #                              resume skips the per-object
        #                              _rga_order rebuild
        self.log_sorted_keys()       # fold pending appends into l_order
        self._fold_digests()         # change bodies are dropped below —
        #                              the digest must be folded NOW
        pool = self.pool
        meta = {'format': 'automerge-tpu-general-snapshot@1',
                'n_docs': self.n_docs,
                'retain_log': self.retain_log,
                'actors': self.actors, 'keys': self.keys,
                'values': list(self.values), 'queue': self.queue,
                'obj_uuid': self.obj_uuid, 'obj_doc': self.obj_doc,
                'obj_type': self.obj_type,
                'obj_inbound': {str(k): v for k, v in
                                self.obj_inbound.items()}}
        extra = {}
        if self.horizon:
            # tiered container (v2): the compaction horizon records
            # (per-doc state snapshots + clocks + digests) and the
            # retained TAIL bodies ride along, so a resumed store is
            # `state + tail` — fully servable and evictable, never
            # blunt-truncated. The format string stays @1 (older
            # readers load the state columns and simply remain
            # truncated — the v-stamp is meta['tiers']).
            meta['tiers'] = 2
            meta['horizon'] = {
                str(d): {'clock': rec['clock'],
                         'digest': rec['digest']}
                for d, rec in self.horizon.items()}
            hdocs = sorted(self.horizon)
            blobs = [self.horizon[d].get('state') or b''
                     for d in hdocs]
            offsets = np.zeros(len(blobs) + 1, np.int64)
            if blobs:
                np.cumsum([len(b) for b in blobs], out=offsets[1:])
            extra['hz_doc'] = np.asarray(hdocs, np.int64)
            extra['hz_off'] = offsets
            extra['hz_blob'] = np.frombuffer(b''.join(blobs),
                                             dtype=np.uint8)
            tail = {}
            for block, rows, docs in self.retained:
                for c, d in zip(rows.tolist(), docs.tolist()):
                    tail.setdefault(str(d), []).append(
                        block.change_dict(int(c)))
            meta['tail'] = tail
        buf = io.BytesIO()
        np.savez_compressed(
            buf, **extra,
            e_doc=self.e_doc, e_obj=self.e_obj, e_key=self.e_key,
            e_actor=self.e_actor, e_seq=self.e_seq,
            e_value=self.e_value, e_link=self.e_link,
            e_change=self.e_change,
            c_doc=self.c_doc, c_actor=self.c_actor, c_seq=self.c_seq,
            l_key=self.l_key, l_order=self.l_order,
            l_dep_ptr=self.l_dep_ptr, l_dep_actor=self.l_dep_actor,
            l_dep_seq=self.l_dep_seq,
            root_row=self._root_row,
            p_obj=pool.obj, p_local=pool.local, p_parent=pool.parent,
            p_actor=pool.actor, p_elemc=pool.elemc,
            p_visible=pool.visible, p_vis_index=pool.vis_index,
            p_tpos=pool.tpos, p_idx_ok=pool.idx_ok,
            p_pos_sorted=pool.pos_sorted, p_pos_row=pool.pos_row,
            p_n_of=pool.n_of, p_max_elem_of=pool.max_elem_of,
            digest=self._digest,
            meta=np.frombuffer(_json2.dumps(meta).encode(),
                               dtype=np.uint8))
        return buf.getvalue()

    @classmethod
    def load_snapshot(cls, data, device=None):
        """Rebuild a store from :meth:`save_snapshot` bytes (this
        package's or the JAX package's — the format is shared) on
        ``device``, with no replay: the packed, wide or cols mirror is
        rebuilt from the restored host columns. A compacted (tiered) snapshot
        restores its horizon records and retained tail through
        :mod:`..compaction`, so the store stays servable."""
        import io
        import json as _json2
        with np.load(io.BytesIO(data)) as z:
            meta = _json2.loads(bytes(z['meta']).decode())
            if meta.get('format') != \
                    'automerge-tpu-general-snapshot@1':
                raise ValueError('not a general-store snapshot')
            store = cls(meta['n_docs'],
                        retain_log=meta.get('retain_log', True),
                        device=device)
            store.actors = list(meta['actors'])
            store.actor_of = {a: i for i, a in
                              enumerate(store.actors)}
            store.keys = list(meta['keys'])
            store.key_of = {k: i for i, k in enumerate(store.keys)}
            store.values = ValueTable()
            store.values.extend(meta['values'])
            store.queue = [(d, ch) for d, ch in meta['queue']]
            store.obj_uuid = list(meta['obj_uuid'])
            store.obj_doc = list(meta['obj_doc'])
            store.obj_type = list(meta['obj_type'])
            store.obj_of = {(d, u): i for i, (d, u) in enumerate(
                zip(store.obj_doc, store.obj_uuid))}
            store.obj_inbound = {
                int(k): [(r, key) for r, key in v]
                for k, v in meta['obj_inbound'].items()}
            for name in ('e_doc', 'e_obj', 'e_key', 'e_actor',
                         'e_seq', 'e_value', 'e_link', 'e_change',
                         'c_doc', 'c_actor', 'c_seq',
                         'l_key', 'l_order', 'l_dep_ptr',
                         'l_dep_actor', 'l_dep_seq'):
                setattr(store, name, z[name])
            # purity is an optimization hint; resumed chains re-derive
            # it conservatively
            store.c_pure = np.zeros(len(store.c_doc), bool)
            store._root_row = z['root_row']
            pool = store.pool
            pool.obj = z['p_obj']
            pool.local = z['p_local']
            pool.parent = z['p_parent']
            pool.actor = z['p_actor']
            pool.elemc = z['p_elemc']
            pool.visible = z['p_visible']
            pool.vis_index = z['p_vis_index']
            # order-index planes: present since the incremental-index
            # format; a pre-index snapshot resumes with idx_ok all
            # False (first touch of each object rebuilds its order)
            if 'p_tpos' in z:
                pool.tpos = z['p_tpos']
                pool.idx_ok = z['p_idx_ok'].astype(bool)
            else:
                pool.tpos = np.zeros(len(pool.obj), np.int32)
                pool.idx_ok = np.zeros(len(z['p_n_of']), bool)
            pool.pos_sorted = z['p_pos_sorted']
            pool.pos_row = z['p_pos_row']
            pool.n_of = z['p_n_of']
            pool.max_elem_of = z['p_max_elem_of']
            # chain-shape bit re-derives from the restored tree
            # columns (not serialized): one O(nodes) pass per resume
            pool.idx_linear = np.zeros(len(pool.n_of), bool)
            if len(pool.obj):
                ok = (pool.local == 0) | (pool.parent == pool.local - 1)
                lin = np.ones(len(pool.n_of), bool)
                np.logical_and.at(lin, pool.obj, ok)
                has = np.zeros(len(pool.n_of), bool)
                has[pool.obj] = True
                pool.idx_linear = lin & has
            pool.max_tree = int(pool.n_of.max()) if len(pool.n_of) \
                else 0
            pool.max_elem = int(pool.elemc.max()) \
                if len(pool.elemc) else 0
            # change bodies are not serialized: peers sync forward
            # from here, not across the snapshot boundary — UNLESS the
            # store was compacted (meta['tiers'] >= 2): then the
            # horizon records + tail bodies restore below and the
            # store stays fully servable (state for peers behind the
            # horizon, tail replay for everyone else)
            store.log_truncated = True
            if meta.get('tiers', 1) >= 2 and 'horizon' in meta:
                hz_meta = meta['horizon']
                hz_doc = z['hz_doc']
                hz_off = z['hz_off']
                hz_blob = z['hz_blob'].tobytes()
                for i, d in enumerate(hz_doc.tolist()):
                    rec = hz_meta[str(d)]
                    blob = hz_blob[int(hz_off[i]):int(hz_off[i + 1])]
                    store.horizon[int(d)] = {
                        'clock': dict(rec['clock']),
                        'digest': rec['digest'],
                        'state': blob or None}
                from .. import compaction as _compaction
                store.retained = _compaction._encode_retained(
                    store, {int(d): ch
                            for d, ch in meta.get('tail',
                                                  {}).items()})
                store.log_truncated = False
                from ..utils.metrics import metrics as _metrics2
                _metrics2.set_gauge('mem_state_snapshot_bytes',
                                    store.state_snapshot_bytes())
            # state digests ride the snapshot (they cannot be refolded
            # once the bodies are gone); a pre-digest snapshot resumes
            # with digests INVALID — it must not advertise zeros
            if 'digest' in z:
                store._digest = z['digest']
            else:
                store._digest_valid = False
            # the device mirror must carry the RESTORED visibility: the
            # lazy first-apply path treats a None mirror as an empty
            # store and would re-stage every node hidden (r5 review:
            # silent loss of pre-resume list/text elements)
            store._materialize_mirror()
        return store

    def _materialize_mirror(self):
        """Build the device-resident mirror from the HOST pool columns
        (pos-ordered) on the store's device — the resume counterpart of
        the fused programs' incremental mirror updates."""
        pool = self.pool
        n = pool.n_nodes
        if n == 0:
            return
        opts = _engine.as_options(None)
        cap = opts.pad_nodes(max(n, 8))
        rows = pool.pos_row.astype(np.int64)
        n_act = len(self.actors)
        # per-doc actor-slot width from the clock rows (sorted by doc):
        # the apply-time pick packs actor slots into uint8, so a store
        # whose widest document exceeds 256 actors must start on the
        # cols format instead of building a packed mirror the first
        # apply immediately downgrades
        if len(self.c_doc):
            starts = np.searchsorted(self.c_doc,
                                     np.arange(self.n_docs + 1))
            a_width = int(np.diff(starts).max())
        else:
            a_width = 1
        a_pad = opts.pad_actors(max(a_width, 1))
        # the persistent order index rides along for every object whose
        # idx_ok bit survived (snapshot resume / state absorb): those
        # objects skip the whole-object _rga_order rebuild and go
        # straight to incremental updates. tpos is a host column, so
        # this needs no device fetch; objects with idx_ok False carry
        # garbage slots that are never read.
        tp = np.zeros(cap, np.int32)
        tp[:n] = pool.tpos[rows]
        dev = self.device
        if _packed_mirror_guard(pool, n_act, a_pad):
            ranks = np.asarray(self.actor_str_ranks())
            actor = pool.actor[rows]
            rank1 = np.where(actor >= 0,
                             ranks[np.maximum(actor, 0)] + 1, 0) \
                .astype(np.int32)
            w1 = np.zeros(cap, np.int32)
            w1[:n] = (pool.parent[rows].astype(np.int32) << 16) | rank1
            w2 = np.zeros(cap, np.int32)
            w2[:n] = (pool.visible[rows].astype(np.int32)
                      << _W2_VIS_SHIFT) | \
                ((pool.vis_index[rows].astype(np.int32) + 1)
                 << _W2_IDX_SHIFT) | pool.elemc[rows]
            self.pool.mirror = {
                'fmt': 'packed', 'cap': cap, 'n': n,
                'w1': _dev(w1, dev), 'w2': _dev(w2, dev),
                'tp': _dev(tp, dev),
                'ranks': ranks.copy(), 'pos_row': pool.pos_row}
        elif _wide_mirror_guard(pool, n_act, a_pad):
            # a resumed long-text store builds the wide mirror
            # DIRECTLY — it must not start on cols and upgrade later
            actor1 = pool.actor[rows].astype(np.int32) + 1
            w1 = np.zeros(cap, np.int32)
            w1[:n] = (pool.parent[rows].astype(np.int32)
                      << _WIDE_PARENT_SHIFT) | (actor1 & _WIDE_ALO_MASK)
            w2 = np.zeros(cap, np.int32)
            w2[:n] = ((actor1 >> 10) << _WIDE_AHI_SHIFT) | \
                (pool.visible[rows].astype(np.int32)
                 << _WIDE_VIS_SHIFT) | \
                (pool.vis_index[rows].astype(np.int32) + 1)
            w3 = np.zeros(cap, np.int32)
            w3[:n] = pool.elemc[rows]
            self.pool.mirror = {
                'fmt': 'wide', 'cap': cap, 'n': n,
                'w1': _dev(w1, dev), 'w2': _dev(w2, dev),
                'w3': _dev(w3, dev), 'tp': _dev(tp, dev),
                'rank_n': n_act, 'rank_table': _rank_table(self, opts),
                'pos_row': pool.pos_row}
        else:
            def col(src, fill, dtype):
                out = np.full(cap, fill, dtype)
                out[:n] = src[rows]
                return _dev(out, dev)

            # the cols fallback never runs the incremental update — it
            # carries no 'tp' plane, and the idx_ok claims must drop
            # with it
            pool.idx_ok[:] = False
            self.pool.mirror = {
                'fmt': 'cols', 'cap': cap, 'n': n,
                'parent': col(pool.parent, 0, np.int32),
                'elemc': col(pool.elemc, 0, np.int32),
                'actor': col(pool.actor, -1, np.int32),
                'visible': col(pool.visible, False, bool),
                'vis_index': col(pool.vis_index, -1, np.int32),
                'rank_n': n_act,
                'rank_table': _rank_table(self, opts),
                'pos_row': pool.pos_row}

    # -- capacity ------------------------------------------------------------

    def grow_docs(self, n_docs):
        """Widen the document axis in place. The store's per-document
        state is sparse (COO clock rows, doc-tagged entries, per-row
        object table), so growth only extends the root-row table — an
        existing fleet keeps its indexes and its resident mirror."""
        if n_docs <= self.n_docs:
            return
        if n_docs >= (1 << 22):
            raise ValueError('store exceeds the 4M-document key space')
        with self._host_lock:
            pad = n_docs - self.n_docs
            self._root_row = np.concatenate(
                [self._root_row, np.full(pad, -1, np.int64)])
            self._doc_version = np.concatenate(
                [self._doc_version, np.zeros(pad, np.int64)])
            self._digest = np.concatenate(
                [self._digest, np.zeros(pad, np.uint64)])
            self.n_docs = n_docs

    # -- objects -------------------------------------------------------------

    def _bump_doc_versions(self, docs):
        """Mark ``docs`` (sorted/unique doc indexes) dirty for view
        caches — called once per successful apply, after every raise
        point, so a rolled-back apply never invalidates a view."""
        if len(docs):
            self._apply_seq += 1
            self._doc_version[docs] = self._apply_seq

    def doc_version(self, d):
        """The doc's applied version — equal versions guarantee the
        materialized view is unchanged."""
        return int(self._doc_version[d])

    def clocks_all(self):
        """``{doc index: {actor: seq}}`` for every document with a
        non-empty clock, in ONE pass over the sorted clock rows. The
        fleet surfaces (``fleet_status``, anti-entropy heartbeats) want
        every clock at once; looping :meth:`clock_of` per doc pays a
        searchsorted per document instead."""
        out = {}
        d_l = self.c_doc.tolist()
        a_l = self.c_actor.tolist()
        s_l = self.c_seq.tolist()
        actors = self.actors
        for d, a, s in zip(d_l, a_l, s_l):
            if s > 0:
                out.setdefault(d, {})[actors[a]] = s
        return out

    # rough per-row costs for the residency estimate: an entry is 7
    # int32/int64 columns + a bool (~40B host) plus its share of the
    # value table; a pool node is ~11 host columns plus 2-3 packed
    # device mirror words; a retained change body is a small dict of
    # dicts (~128B dominates small ops). The estimate steers the
    # eviction policy — it only needs to be proportional, not exact.
    _EST_ENTRY_BYTES = 48
    _EST_NODE_BYTES = 96
    _EST_CHANGE_BYTES = 128

    def doc_byte_estimates(self):
        """Estimated resident bytes PER DOCUMENT (host columns + device
        mirror + retained change bodies), as an int64 array over the
        doc axis — the signal the serving layer's memory budget and
        ``fleet_status`` residency report key on. One bincount pass per
        state family; O(state), no per-doc loops."""
        self._commit_pending()
        self.pool.sync()
        n = self.n_docs
        est = np.zeros(n, np.int64)
        if len(self.e_doc):
            est += np.bincount(self.e_doc, minlength=n)[:n] * \
                self._EST_ENTRY_BYTES
        pool = self.pool
        if pool.n_nodes:
            obj_doc_arr, _ = self.obj_arrays()
            node_docs = obj_doc_arr[pool.obj[:pool.n_nodes]]
            est += np.bincount(node_docs, minlength=n)[:n] * \
                self._EST_NODE_BYTES
        for _, _, docs in self.retained:
            if len(docs):
                est += np.bincount(docs, minlength=n)[:n] * \
                    self._EST_CHANGE_BYTES
        return est

    def obj_arrays(self):
        """(obj_doc, obj_type) as int32 arrays, cached per table size."""
        n = len(self.obj_uuid)
        if self._obj_arr_cache[0] != n:
            self._obj_arr_cache = (n,
                                   np.asarray(self.obj_doc, np.int32),
                                   np.asarray(self.obj_type, np.int32))
        return self._obj_arr_cache[1], self._obj_arr_cache[2]

    def wire_obj_tables(self):
        """The object tables marshalled for the native wire codec
        (uuid blob + offsets, doc/type arrays), cached per table
        length — the tables are append-only, so a prefix of a given
        length never changes (a rollback truncation resets the cache
        explicitly in ``_Txn.rollback``, like ``_obj_arr_cache``). A
        steady-state receive tick re-parses against a large object
        table; without this the codec edge re-encodes every uuid per
        flush."""
        n = len(self.obj_uuid)
        cache = self._wire_obj_cache
        if cache is not None and cache[0] == n:
            return cache[1:]
        encoded = [u.encode('utf-8') for u in self.obj_uuid]
        blob = b''.join(encoded)
        offsets = np.zeros(n + 1, np.int64)
        if encoded:
            np.cumsum([len(e) for e in encoded], out=offsets[1:])
        doc_arr = np.asarray(self.obj_doc, np.int32) if n else \
            np.zeros(1, np.int32)
        type_arr = np.asarray(self.obj_type, np.int8) if n else \
            np.zeros(1, np.int8)
        self._wire_obj_cache = (n, blob, offsets, doc_arr, type_arr)
        return blob, offsets, doc_arr, type_arr

    def obj_row(self, d, uuid, create_type=None):
        row = self.obj_of.get((d, uuid))
        if row is None:
            if create_type is None:
                return -1
            row = len(self.obj_uuid)
            if row >= (1 << 22):
                raise ValueError('object table exceeds the 4M key space')
            self.obj_of[(d, uuid)] = row
            self.obj_uuid.append(uuid)
            self.obj_doc.append(d)
            self.obj_type.append(create_type)
            if uuid == ROOT_ID:
                self._root_row[d] = row
            if create_type in (_TYPE_LIST, _TYPE_TEXT):
                self.pool.create_heads(np.asarray([row], np.int64))
            else:
                self.pool.grow_objects(row + 1)
        return row

    def root_row(self, d):
        return self.obj_row(d, ROOT_ID, create_type=_TYPE_MAP)

    def is_seq(self, row):
        return self.obj_type[row] in (_TYPE_LIST, _TYPE_TEXT)

    # -- encode (the dict edge) ---------------------------------------------

    def encode_changes(self, changes_per_doc, extra_types=None,
                       n_docs=None):
        """Encode reference-format dict changes into a general
        :class:`~.blocks.ChangeBlock`, resolving key kinds against this
        store's object types (plus objects created within the batch, and
        ``extra_types`` — creations known from elsewhere, e.g. the
        incoming block a queued change is being merged with).

        Ops on objects unknown to all of those (their change is
        necessarily causally unready — the creation has not arrived)
        encode with string keys; such changes buffer in the queue and
        re-encode on retry, when the creation is known.

        ``n_docs`` widens the block's document space beyond
        ``len(changes_per_doc)`` (a sparse tick touching few documents
        of a large store need not materialize one list per document).
        """
        actors, actor_of = [], {}
        keys, key_of = [], {}
        objs, obj_idx = [ROOT_ID], {ROOT_ID: 0}
        values = []
        doc, actor, seq = [], [], []
        dep_ptr, dep_actor, dep_seq = [0], [], []
        op_ptr, action, key, value = [0], [], [], []
        obj_col, kind_col, key_elem, elem_col = [], [], [], []

        # pass 1: objects created anywhere in the batch
        created = dict(extra_types) if extra_types else {}
        for d, changes in enumerate(changes_per_doc):
            for change in changes:
                for op in change['ops']:
                    a = op['action']
                    if a in ('makeMap', 'makeList', 'makeText'):
                        created[(d, op['obj'])] = _MAKE_TYPE[
                            _GEN_ACTION_NAMES[a]]

        def obj_type_of(d, uuid):
            if uuid == ROOT_ID:
                return _TYPE_MAP
            row = self.obj_of.get((d, uuid))
            if row is not None:
                return self.obj_type[row]
            return created.get((d, uuid))       # None = unknown

        def check_seq_i32(v, what):
            if not isinstance(v, int) or isinstance(v, bool) or \
                    not 0 <= v <= 0x7FFFFFFF:
                raise ValueError(
                    f'{what} {v!r} out of range (must fit int32)')
            return v

        dup_keys = False
        for d, changes in enumerate(changes_per_doc):
            for change in changes:
                if 'deps' not in change:
                    raise ValueError('change requires actor, seq and deps')
                doc.append(d)
                actor.append(_intern(actors, actor_of, change['actor']))
                seq.append(check_seq_i32(change['seq'], 'change seq'))
                for da, ds in change['deps'].items():
                    dep_actor.append(_intern(actors, actor_of, da))
                    dep_seq.append(check_seq_i32(ds, 'dep seq'))
                dep_ptr.append(len(dep_actor))
                change_fields = set()
                for op in change['ops']:
                    a = op['action']
                    code = _GEN_ACTION_NAMES.get(a)
                    if code is None:
                        raise ValueError(f'Unknown operation type {a}')
                    uuid = op['obj']
                    action.append(code)
                    obj_col.append(_intern(objs, obj_idx, uuid))
                    if code in (_MAKE_MAP, _MAKE_LIST, _MAKE_TEXT):
                        kind_col.append(_KEY_NONE)
                        key.append(-1)
                        key_elem.append(0)
                        elem_col.append(0)
                        value.append(-1)
                        continue
                    k = op['key']
                    otype = obj_type_of(d, uuid)
                    as_elem = (otype in (_TYPE_LIST, _TYPE_TEXT))
                    if as_elem and k == '_head':
                        if code != _INS:
                            raise ValueError('assignment to _head')
                        kind_col.append(_KEY_HEAD)
                        key.append(-1)
                        key_elem.append(0)
                    elif as_elem:
                        ka, _, ke = k.rpartition(':')
                        try:
                            ke = int(ke)
                        except ValueError:
                            raise ValueError(
                                f'malformed element id {k!r}') from None
                        kind_col.append(_KEY_ELEM)
                        key.append(_intern(actors, actor_of, ka))
                        key_elem.append(ke)
                    else:
                        kind_col.append(_KEY_STR)
                        key.append(_intern(keys, key_of, k))
                        key_elem.append(0)
                    if code == _INS:
                        elem_col.append(op['elem'])
                        value.append(-1)
                    else:
                        elem_col.append(0)
                        if code in (_SET, _LINK):
                            value.append(len(values))
                            values.append(op.get('value'))
                        else:
                            value.append(-1)
                        fk = (uuid, k)
                        if fk in change_fields:
                            dup_keys = True
                        change_fields.add(fk)
                op_ptr.append(len(action))

        return ChangeBlock(
            n_docs if n_docs is not None else len(changes_per_doc),
            np.asarray(doc, np.int32), np.asarray(actor, np.int32),
            np.asarray(seq, np.int32), np.asarray(dep_ptr, np.int32),
            np.asarray(dep_actor, np.int32), np.asarray(dep_seq, np.int32),
            np.asarray(op_ptr, np.int32), np.asarray(action, np.int8),
            np.asarray(key, np.int32), np.asarray(value, np.int32),
            actors, keys, values, dup_keys=dup_keys,
            obj=np.asarray(obj_col, np.int32),
            key_kind=np.asarray(kind_col, np.int8),
            key_elem=np.asarray(key_elem, np.int32),
            elem=np.asarray(elem_col, np.int32), objs=objs)

    def merge_queued_into(self, block):
        """Re-encode the buffered queue (kinds resolve against the
        now-current object table PLUS the incoming block's creations)
        and concatenate column-wise."""
        extra = {}
        if block.is_general() and block.n_ops:
            mk = np.flatnonzero(block.action >= _MAKE_MAP)
            if len(mk):
                op_doc = np.repeat(block.doc, np.diff(block.op_ptr))
                for j in mk.tolist():
                    extra[(int(op_doc[j]), block.objs[block.obj[j]])] = \
                        _MAKE_TYPE[int(block.action[j])]
        per_doc = [[] for _ in range(self.n_docs)]
        for d, change in self.queue:
            per_doc[d].append(change)
        qblock = self.encode_changes(per_doc, extra_types=extra)
        return _concat_general(block, qblock)

    # -- inspection ----------------------------------------------------------

    def doc_fields(self, d):
        """{(obj uuid, key string): [(actor, value), ...]} winner first —
        the test/inspection surface (general-key aware)."""
        self._commit_pending()
        pool = self.pool
        out = {}
        for j in np.flatnonzero(self.e_doc == d):
            obj_row = int(self.e_obj[j])
            packed = int(self.e_key[j])
            if packed & (1 << 31):
                node = packed & 0x7FFFFFFF
                row = pool.row_at(obj_row, node)
                key = (f'{self.actors[pool.actor[row]]}:'
                       f'{int(pool.elemc[row])}')
            else:
                key = self.keys[packed & 0x7FFFFFFF]
            out.setdefault((self.obj_uuid[obj_row], key), []).append(
                (self.actors[self.e_actor[j]],
                 self.values[self.e_value[j]] if self.e_value[j] >= 0
                 else None))
        return {k: sorted(v, key=lambda t: t[0], reverse=True)
                for k, v in out.items()}


def _concat_general(a, b):
    """Column-wise concatenation of two general blocks (b's table
    references remapped into a's tables)."""
    if not b.n_changes:
        return a
    if not a.is_general():
        a = _upgrade_to_general(a)
    actors = list(a.actors)
    actor_of = {s: i for i, s in enumerate(actors)}
    keys = list(a.keys)
    key_of = {s: i for i, s in enumerate(keys)}
    objs = list(a.objs)
    obj_of = {s: i for i, s in enumerate(objs)}
    amap = np.asarray([_intern(actors, actor_of, s) for s in b.actors]
                      or [0], np.int32)
    kmap = np.asarray([_intern(keys, key_of, s) for s in b.keys]
                      or [0], np.int32)
    omap = np.asarray([_intern(objs, obj_of, s) for s in b.objs]
                      or [0], np.int32)
    values = ValueTable()
    values.extend(a.values)
    v_base = len(values)
    values.extend(b.values)

    def col(xa, xb):
        return np.concatenate([xa, xb])

    new_key = np.full(b.n_ops, -1, np.int32)
    if b.n_ops:
        str_m = b.key_kind == _KEY_STR
        elem_m = b.key_kind == _KEY_ELEM
        new_key[str_m] = kmap[b.key[str_m]]
        new_key[elem_m] = amap[b.key[elem_m]]

    if a._dup_keys or b._dup_keys:
        dup_keys = True
    elif a._dup_keys is None or b._dup_keys is None:
        dup_keys = None
    else:
        dup_keys = False

    return ChangeBlock(
        a.n_docs, col(a.doc, b.doc), col(a.actor, amap[b.actor]),
        col(a.seq, b.seq),
        col(a.dep_ptr, a.dep_ptr[-1] + b.dep_ptr[1:]),
        col(a.dep_actor, amap[b.dep_actor] if len(b.dep_actor)
            else b.dep_actor),
        col(a.dep_seq, b.dep_seq),
        col(a.op_ptr, a.op_ptr[-1] + b.op_ptr[1:]),
        col(a.action, b.action),
        col(a.key, new_key),
        col(a.value, np.where(b.value >= 0, b.value + v_base, -1)
            .astype(np.int32) if b.n_ops else b.value),
        actors, keys, values, dup_keys=dup_keys,
        obj=col(a.obj, omap[b.obj] if b.n_ops else b.obj),
        key_kind=col(a.key_kind, b.key_kind),
        key_elem=col(a.key_elem, b.key_elem),
        elem=col(a.elem, b.elem), objs=objs)


def _upgrade_to_general(block):
    """A flat root-map block viewed through the general schema."""
    n = block.n_ops
    return ChangeBlock(
        block.n_docs, block.doc, block.actor, block.seq, block.dep_ptr,
        block.dep_actor, block.dep_seq, block.op_ptr, block.action,
        block.key, block.value, block.actors, block.keys, block.values,
        dup_keys=block._dup_keys,
        obj=np.zeros(n, np.int32),
        key_kind=np.full(n, _KEY_STR, np.int8),
        key_elem=np.zeros(n, np.int32),
        elem=np.zeros(n, np.int32), objs=[ROOT_ID])


def init_store(n_docs, device=None):
    """An empty general store of ``n_docs`` documents on ``device``
    (None: CUDA; raises when no card is available)."""
    return GeneralStore(n_docs, device=device)


# -- fused device step -------------------------------------------------------
#
# The JAX package jits these programs; here they are plain PyTorch
# functions on the store's device, run eagerly. Every scatter whose
# target the reference drops (``mode='drop'``) writes into a sink slot
# that is sliced off, so no index ever leaves its tensor (torch raises
# on an out-of-range index, and on CUDA that is a device-side assert);
# every integer plane stays int32 (torch widens bool/int32 sums).

_I32 = torch.int32


def _dev(a, device):
    """A host numpy array (or scalar) as a tensor on ``device`` — one
    host-to-device copy, dtype preserved."""
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _sync(t):
    """Block until the device work producing ``t`` has finished."""
    if isinstance(t, torch.Tensor) and t.device.type == 'cuda':
        torch.cuda.synchronize(t.device)


def _to_host(t):
    """One tensor as a numpy array (one device-to-host copy)."""
    return t.detach().cpu().numpy()


def _fetch(items):
    """Device tensors (or tuples of them) -> the same structure of numpy
    arrays, in ONE device-to-host transfer: every tensor widens to int32
    into a single flat buffer on the device, the buffer crosses once,
    and each piece is sliced back to its own shape and dtype."""
    flat = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            return tuple(walk(y) for y in x)
        flat.append(x)
        return len(flat) - 1

    shape = [walk(x) for x in items]
    if all(t.device.type == 'cpu' for t in flat):
        host = [t.detach().numpy() for t in flat]
    else:
        buf = torch.cat([t.reshape(-1).to(_I32) for t in flat]).cpu() \
            .numpy()
        host = []
        o = 0
        for t in flat:
            n = t.numel()
            np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            host.append(buf[o:o + n].astype(np_dtype).reshape(t.shape))
            o += n

    def build(s):
        if isinstance(s, tuple):
            return tuple(build(y) for y in s)
        return host[s]

    return [build(s) for s in shape]


def _unpack_bits(u8, n):
    """MSB-first bit unpack (matches np.packbits) to bool[n]."""
    i = torch.arange(n, device=u8.device)
    return ((u8[i >> 3].to(_I32) >> (7 - (i & 7))) & 1).to(torch.bool)


def _pack_bits(b):
    """bool[n] (n a multiple of 8) -> MSB-first uint8[n >> 3]."""
    w = (1 << torch.arange(7, -1, -1, device=b.device, dtype=_I32))
    return (b.reshape(-1, 8).to(_I32) * w).sum(dim=1, dtype=_I32) \
        .to(torch.uint8)


def _sink_index(idx, n):
    """Flat int64 scatter indexes with every one outside [0, n) moved to
    the sink slot n (the reference's ``mode='drop'``)."""
    idx = idx.reshape(-1).to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def _scatter_set(base, idx, vals):
    """``base.at[idx].set(vals, mode='drop')`` for 1-D ``base``: indexes
    outside [0, len) land in a sink slot that is sliced off."""
    n = base.shape[0]
    buf = torch.cat([base, base.new_zeros(1)])
    return buf.scatter(0, _sink_index(idx, n),
                       vals.reshape(-1).to(base.dtype))[:n]


def _scatter_reduce(base, idx, vals, reduce):
    """``base.at[idx].add/max(vals, mode='drop')`` for 1-D ``base``
    (``reduce`` 'sum' or 'amax'), with the same sink slot."""
    n = base.shape[0]
    buf = torch.cat([base, base.new_zeros(1)])
    return buf.scatter_reduce(0, _sink_index(idx, n),
                              vals.reshape(-1).to(base.dtype), reduce,
                              include_self=True)[:n]


# shared staging idioms of the fused programs (packed, wide, cols) —
# one definition so the variants stay in lockstep by construction

def _insert_counts(d_pos, cap):
    """cnt[i] = #new nodes at insert positions <= i, for non-decreasing
    d_pos (cap-padded): one scatter-max + cummax."""
    d = d_pos.shape[0]
    tgt = d_pos.to(torch.int64)
    tgt = torch.where((tgt >= 0) & (tgt < cap), tgt, torch.full_like(tgt, cap))
    out = torch.zeros(cap + 1, dtype=_I32, device=d_pos.device)
    out = out.scatter_reduce(
        0, tgt, torch.arange(1, d + 1, dtype=_I32, device=d_pos.device),
        'amax', include_self=True)
    return torch.cummax(out[:cap], dim=0).values


def _build_clock(actor, seq, a_pad, coo_row, coo_col, coo_val):
    """Dense [n, a_pad] closure clock: the own-actor entry is always
    seq-1 (elementwise — no scatter), cross-actor exceptions overlay
    from COO (rows past n — the padding — are dropped)."""
    n = actor.shape[0]
    dev = actor.device
    ar = torch.arange(a_pad, dtype=_I32, device=dev)
    clock = torch.where(actor[:, None] == ar[None, :], (seq - 1)[:, None],
                        torch.zeros((), dtype=_I32, device=dev))
    r = coo_row.to(torch.int64)
    c = coo_col.to(torch.int64)
    ok = (r >= 0) & (r < n) & (c >= 0) & (c < a_pad)
    flat = torch.where(ok, r * a_pad + c, torch.full_like(r, n * a_pad))
    return _scatter_set(clock.reshape(-1), flat, coo_val.to(_I32)) \
        .reshape(n, a_pad)


def _vis_grid(row_slot, valid, surviving, k, m_pad):
    """(touched, vis_hit) planes from the per-row slots with ONE packed
    scatter: max over {0, 2, 3} of valid<<1|surviving recovers both
    bits (surviving implies valid)."""
    n = k * m_pad
    slot = row_slot.to(torch.int64)
    flat = torch.where((slot >= 0) & (slot < n), slot,
                       torch.full_like(slot, n))
    packed = (valid.to(_I32) << 1) | surviving.to(_I32)
    grid = torch.zeros(n + 1, dtype=_I32, device=row_slot.device) \
        .scatter_reduce(0, flat, packed, 'amax', include_self=True)
    grid = grid[:n].reshape(k, m_pad)
    return grid >= 2, grid == 3


def _fold(col, dcol, tgt_old, tgt_new, fill):
    """The pos-order-preserving merge of the resident column ``col``
    (old rows to ``tgt_old``) and this apply's new rows ``dcol`` (to
    ``tgt_new``) into a fresh ``cap``-long column; ``tgt_old`` None
    means an empty mirror."""
    out = torch.full((col.shape[0],), fill, dtype=col.dtype,
                     device=col.device)
    if tgt_old is not None:
        out = _scatter_set(out, tgt_old, col)
    return _scatter_set(out, tgt_new, dcol.to(col.dtype))


def _job_planes(job_start, job_n, m_pad, cap):
    """(pos_mat, valid_plane, pos_c): each dirty object's nodes are one
    contiguous pos slice, local-ascending; ``pos_c`` is the clamped
    gather index."""
    dev = job_start.device
    l = torch.arange(m_pad, dtype=_I32, device=dev)
    pos_mat = job_start.to(_I32)[:, None] + l[None, :]
    valid_plane = l[None, :] < job_n.to(_I32)[:, None]
    pos_c = torch.where(valid_plane, pos_mat,
                        torch.zeros_like(pos_mat)).clamp(max=cap - 1) \
        .to(torch.int64)
    return pos_mat, valid_plane, pos_c


def _resolve_rows(flags_u8, ops_actor, ops_seq, n_rows, a_pad, coo_row,
                  coo_col, coo_val, num_segments):
    """Field resolution of the field-sorted staged rows (scan-based
    segment reductions): returns (valid, resolve outputs)."""
    from .merge import _resolve_sorted
    n = ops_actor.shape[0]
    nb = n >> 3
    boundary = _unpack_bits(flags_u8[:nb], n)
    is_del = _unpack_bits(flags_u8[nb:], n)
    valid = torch.arange(n, device=ops_actor.device) < n_rows
    actor = ops_actor.to(_I32)
    seq = ops_seq.to(_I32)
    clock = _build_clock(actor, seq, a_pad, coo_row, coo_col, coo_val)
    return valid, _resolve_sorted(boundary, actor, seq, clock, is_del,
                                  valid, num_segments)


def _fused_general_resident(m_parent, m_elemc, m_actor, m_visible,
                            m_visidx, d_parent, d_elemc, d_actor, d_pos,
                            n_old, job_start, job_n, rank_table,
                            ops_actor, ops_seq, ops_slot, flags_u8,
                            n_rows, coo_row, coo_col, coo_val, *,
                            num_segments, a_pad, m_pad):
    """One apply of the general engine against DEVICE-RESIDENT trees
    (the cols format): fold this apply's new nodes into the pos-ordered
    mirror, gather the dirty objects' job planes from it, resolve every
    touched field, derive element visibility, re-order every dirty
    sequence, and scatter the new visibility back into the mirror.
    Outputs: the updated mirror columns, bit-packed survivors, the
    per-field winner, and the prior/new visibility+order planes."""
    from .sequence import _rga_order_batched
    cap = m_parent.shape[0]
    dev = m_parent.device

    # ---- fold the new nodes in (pos-order preserving insert) ----
    i = torch.arange(cap, dtype=_I32, device=dev)
    cnt = _insert_counts(d_pos, cap)
    tgt_old = torch.where(i < n_old, i + cnt, torch.full_like(i, cap))
    tgt_new = d_pos.to(_I32) + torch.arange(d_pos.shape[0], dtype=_I32,
                                            device=dev)
    parent_p = _fold(m_parent, d_parent, tgt_old, tgt_new, 0)
    elemc_p = _fold(m_elemc, d_elemc, tgt_old, tgt_new, 0)
    actor_p = _fold(m_actor, d_actor, tgt_old, tgt_new, -1)
    visible_p = _fold(m_visible, torch.zeros_like(d_parent, dtype=torch.bool),
                      tgt_old, tgt_new, False)
    visidx_p = _fold(m_visidx, torch.full_like(d_parent, -1, dtype=_I32),
                     tgt_old, tgt_new, -1)

    # ---- job planes gathered from the resident columns ----
    pos_mat, valid_plane, pos_c = _job_planes(job_start, job_n, m_pad, cap)
    s_parent = parent_p[pos_c]
    s_elem = elemc_p[pos_c]
    r_idx = (actor_p[pos_c].to(torch.int64) + 1) \
        .clamp(0, rank_table.shape[0] - 1)
    s_rank = rank_table[r_idx]
    prior_vis = visible_p[pos_c] & valid_plane
    prior_idx = torch.where(valid_plane, visidx_p[pos_c],
                            torch.full_like(s_parent, -1))

    # ---- field resolution (scan-based; rows arrive field-sorted) ----
    valid, out = _resolve_rows(flags_u8, ops_actor, ops_seq, n_rows, a_pad,
                               coo_row, coo_col, coo_val, num_segments)

    # ---- element visibility + RGA ordering ----
    k = job_start.shape[0]
    touched, vis_hit = _vis_grid(ops_slot, valid, out['surviving'], k,
                                 m_pad)
    visible = torch.where(touched, vis_hit, prior_vis) & valid_plane
    ordered = _rga_order_batched(s_parent, s_elem, s_rank, visible,
                                 valid_plane)

    # ---- scatter the new visibility/order back into the mirror ----
    scatter_pos = torch.where(valid_plane, pos_mat,
                              torch.full_like(pos_mat, cap))
    visible_p = _scatter_set(visible_p, scatter_pos, visible)
    visidx_p = _scatter_set(visidx_p, scatter_pos, ordered['vis_index'])
    surv_u8 = _pack_bits(out['surviving'])
    return (parent_p, elemc_p, actor_p, visible_p, visidx_p,
            surv_u8, out['winner'], prior_vis, visible, prior_idx,
            ordered['vis_index'])


# -- packed fused step -------------------------------------------------------
#
# The wire-packed variant of the resident program: the mirror packs into
# two int32 words per node and every staged input rides ONE uint8 buffer
# (one host-to-device copy, sliced + reinterpreted on device), with the
# field resolution on segment reductions over the field-sorted rows.
#
# 'packed' — 2 words/node, the small-tree fast path:
#   W1 = parent << 16 | (rank+1)      rank = actor string rank; head = 0
#   W2 = visible << 30 | (vis_index+1) << 15 | elemc
#   Guards: tree size <= 32767 nodes, elemc < 32768, actor count
#   < 65535, per-doc actor slots <= 256, seq < 32768, coo seq < 32768.
#
# 'wide' — 3 words/node, the long-text format (the bounds lift): trees
# to 2^22 - 1 nodes, elemc and seq bounded only by int32. The words
# carry the STABLE actor id (+1; 0 = head) split 10/6 across W1/W2
# instead of the rank, so a growing actor table never remaps the
# mirror — the RGA rank comes from the small rank_table gather instead:
#   W1 = parent << 10 | (actor+1) & 0x3FF
#   W2 = ((actor+1) >> 10) << 23 | visible << 22 | (vis_index+1)
#   W3 = elemc
#   Guards: tree size <= 2^22 - 1 nodes, actor count < 65535, per-doc
#   actor slots <= 256 (the u8 row-staging dtype). seq/coo seq ride
#   int32 wire sections, elemc is a full int32 word.
#
# The unpacked `_fused_general_resident` (cols) remains the fallback
# for shapes past both (>4M-node trees, >65535 actors, >256 per-doc
# actor slots), and the independent cross-check of the packed FORMATS
# (bit fields, wire layout, dtype narrowing). A store crossing a bound
# mid-stream converts its resident mirror in place (`_mirror_convert`)
# — packed -> wide is the boundary a long text document crosses.

_W2_ELEM = 0x7FFF
_W2_VIS_SHIFT = 30
_W2_IDX_SHIFT = 15

# wide-format bit layout (see the comment above)
_WIDE_IDX_MASK = (1 << 22) - 1       # vis_index+1 (W2) / parent width
_WIDE_VIS_SHIFT = 22
_WIDE_AHI_SHIFT = 23
_WIDE_AHI_BITS = 0x3F << _WIDE_AHI_SHIFT
_WIDE_ALO_MASK = (1 << 10) - 1
_WIDE_PARENT_SHIFT = 10
_WIDE_MAX_TREE = (1 << 22) - 1


def unpack_vis_word(v_u32):
    """Host-side unpack of the packed vis output plane
    (`_fused_general_packed`'s vis_packed, viewed as uint32):
    (prior_vis, visible, prior_idx, new_idx)."""
    pv = (v_u32 >> 31).astype(bool)
    nv = ((v_u32 >> _W2_VIS_SHIFT) & 1).astype(bool)
    pi = (((v_u32 >> _W2_IDX_SHIFT) & _W2_ELEM).astype(np.int64) - 1)
    ni = (v_u32 & _W2_ELEM).astype(np.int64) - 1
    return pv, nv, pi, ni


def unpack_w2_word(w2):
    """Host-side unpack of a mirror W2 word: (visible, vis_index)."""
    vis = ((w2 >> _W2_VIS_SHIFT) & 1).astype(bool)
    idx = (((w2 >> _W2_IDX_SHIFT) & _W2_ELEM) - 1).astype(np.int32)
    return vis, idx


def unpack_wide_word(w):
    """Host-side unpack of a WIDE visibility word — the mirror W2 and
    the wide program's vis output planes share the layout
    ``visible << 22 | (idx + 1)``: (visible, vis_index)."""
    vis = ((w >> _WIDE_VIS_SHIFT) & 1).astype(bool)
    idx = ((w & _WIDE_IDX_MASK) - 1).astype(np.int32)
    return vis, idx


# test/dryrun hook: called once per apply with the staged planes and the
# fused outputs (whichever variant ran) — the sharded-step equality
# gates consume this instead of monkeypatching a program symbol
_STAGE_CAPTURE = None

# native-staging switch: None = auto (use the C++ stager when the
# library loads and the block is fully admitted), False = numpy only,
# True = REQUIRE native (tests: fail loudly instead of silently
# falling back)
_NATIVE_STAGING = None

# incremental-index switch: None = auto (take the incremental path
# whenever the eligibility gate holds), 'rebuild' = always run the
# whole-object rebuild variant (the A/B arm and the parity oracle),
# 'require' = raise when an apply with dirty sequences cannot go
# incremental (tests: an invalidation path that silently falls back is a
# bug)
_INDEX_MODE = None

# edit-stream read switch (GeneralPatch._ensure): one device launch
# compacts the tick's edits into pre-ordered delta-sized buffers
# (cuda_view.dispatch_edit_stream) and the read fetches THOSE instead
# of the full O(doc) vis planes. A CUDA store takes the kernel for
# every whole-plane apply (a windowed apply hands the read only its
# suffix planes, which the host unpacks, as in the reference); the
# switch only picks a CPU store's arm: None/False = host path, True =
# the plain PyTorch edit stream. False on a CUDA store raises.
_EDIT_STREAM = None

# suffix-window switch for the incremental index update: None = auto
# (bound each eligible chain-shaped job's renumber to the suffix
# window containing every delta anchor and touched node), 'off' =
# always renumber the whole plane (the whole-plane A/B arm), 'require'
# = raise when an incremental apply with dirty sequences cannot window
# (tests: a silent fallback on the end-typing shape is a bug)
_WINDOW_MODE = None

# staging-cache switch (delta admit/stage): None = auto (keep per-
# object sorted elemId -> local indexes across applies and let both
# stagers consult them), False = off (cold-stage every tick — the
# whole-plane A/B arm / parity oracle)
_STAGE_CACHE = None


def _edit_stream_on(device):
    if device.type == 'cuda':
        if _EDIT_STREAM is False:
            raise ValueError(
                '_EDIT_STREAM=False is a CPU-store switch; a CUDA store '
                'reads its whole-plane patches through the edit-stream '
                'kernel')
        return True
    return bool(_EDIT_STREAM)


def _packed_mirror_guard(pool, n_act, a_pad=None):
    """The packed 2-word mirror format's bit-field bounds — ONE
    definition shared by the apply-time variant pick and the resume-
    time `_materialize_mirror`, so a store the apply path would
    immediately downgrade (e.g. >256 per-doc actors) never builds a
    packed mirror it cannot keep. ``a_pad`` is the padded per-doc
    actor-slot width when known (must fit the uint8 staging dtype)."""
    return (pool.max_tree <= 0x7FFF
            and pool.max_elem < (1 << 15)
            and n_act < 65535
            and (a_pad is None or a_pad <= 256))


def _wide_mirror_guard(pool, n_act, a_pad=None):
    """The WIDE 3-word mirror format's bounds — the packed program for
    everything the 2-word format cannot hold short of the cols
    fallback: trees to 2^22 - 1 nodes; elemc, seq and closure seqs
    bounded only by int32 (they ride full int32 wire sections). Shared
    by the apply-time pick, `_materialize_mirror` (a resumed long-text
    store builds the wide mirror DIRECTLY) and `_mirror_convert`."""
    return (pool.max_tree <= _WIDE_MAX_TREE
            and n_act < 65535
            and (a_pad is None or a_pad <= 256))


def _wire_sizes(d_pad, n_pad, K, nnz_pad):
    """Total byte count of the single staged wire buffer. Section
    offsets are not centralized: the host packing loop in
    `_apply_general` and the device slicing in `_fused_general_packed`
    must list the sections in THIS order (4-byte-aligned first):
    i32: w1_new[d_pad] d_pos[d_pad] row_slot[n_pad] coo_row[nnz_pad]
         job_start[K] job_n[K]
    i16: w2e[d_pad] seq[n_pad] coo_val[nnz_pad]
    u8:  actor[n_pad] flags[2*(n_pad>>3)] coo_col[nnz_pad]
    """
    i32_n = 2 * d_pad + n_pad + nnz_pad + 2 * K
    i16_n = d_pad + n_pad + nnz_pad
    u8_n = n_pad + 2 * (n_pad >> 3) + nnz_pad
    return 4 * i32_n + 2 * i16_n + u8_n


def _wire_sizes_wide(d_pad, n_pad, K, nnz_pad):
    """Byte count of the WIDE program's wire buffer. Same contract as
    `_wire_sizes`: the host packing loop, the C++ `amst_fill_wire_wide`
    and the device slicing in `_parse_wire_wide` must list the sections
    in THIS order (seq/coo_val widen to int32 — a long-lived actor's seq
    exceeds 32767 at exactly the history length whose tree needs this
    format):
    i32: w1_new[d_pad] w3_new[d_pad] d_pos[d_pad] row_slot[n_pad]
         seq[n_pad] coo_row[nnz_pad] coo_val[nnz_pad]
         job_start[K] job_n[K]
    u8:  ahi_new[d_pad] actor[n_pad] flags[2*(n_pad>>3)]
         coo_col[nnz_pad]
    """
    i32_n = 3 * d_pad + 2 * n_pad + 2 * nnz_pad + 2 * K
    u8_n = d_pad + n_pad + 2 * (n_pad >> 3) + nnz_pad
    return 4 * i32_n + u8_n


def _wire_cut(vec, state, cnt):
    o = state[0]
    state[0] = o + cnt
    return vec[o:o + cnt]


def _parse_wire_packed(wire, sizes):
    """Slice the PACKED wire buffer (a uint8 device tensor) into its
    typed sections — must stay in lockstep with `_wire_sizes`, the host
    packing loop and the C++ `amst_fill_wire`. The int32 and int16
    sections start at byte offsets that are multiples of their widths,
    so each is a reinterpreting view, not a copy. Returns
    (w1d, d_pos, row_slot, coo_row, job_start, job_n,
     w2e, seq, coo_val, actor, flags_u8, coo_col)."""
    d_pad, n_pad, K, nnz_pad = sizes
    i32_n = 2 * d_pad + n_pad + nnz_pad + 2 * K
    i16_n = d_pad + n_pad + nnz_pad
    i32v = wire[:4 * i32_n].view(torch.int32)
    i16v = wire[4 * i32_n:4 * i32_n + 2 * i16_n].view(torch.int16)
    u8v = wire[4 * i32_n + 2 * i16_n:]
    s32, s16, s8 = [0], [0], [0]
    w1d = _wire_cut(i32v, s32, d_pad)
    d_pos = _wire_cut(i32v, s32, d_pad)
    row_slot = _wire_cut(i32v, s32, n_pad)
    coo_row = _wire_cut(i32v, s32, nnz_pad)
    job_start = _wire_cut(i32v, s32, K)
    job_n = _wire_cut(i32v, s32, K)
    w2e = _wire_cut(i16v, s16, d_pad).to(_I32)
    seq = _wire_cut(i16v, s16, n_pad).to(_I32)
    coo_val = _wire_cut(i16v, s16, nnz_pad).to(_I32)
    actor = _wire_cut(u8v, s8, n_pad).to(_I32)
    flags_u8 = _wire_cut(u8v, s8, 2 * (n_pad >> 3))
    coo_col = _wire_cut(u8v, s8, nnz_pad).to(_I32)
    return (w1d, d_pos, row_slot, coo_row, job_start, job_n, w2e, seq,
            coo_val, actor, flags_u8, coo_col)


def _parse_wire_wide(wire, sizes):
    """The WIDE counterpart of `_parse_wire_packed` (section order of
    `_wire_sizes_wide` / `amst_fill_wire_wide`). Returns
    (w1d, w3d, d_pos, row_slot, seq, coo_row, coo_val, job_start,
     job_n, d_ahi, actor, flags_u8, coo_col)."""
    d_pad, n_pad, K, nnz_pad = sizes
    i32_n = 3 * d_pad + 2 * n_pad + 2 * nnz_pad + 2 * K
    i32v = wire[:4 * i32_n].view(torch.int32)
    u8v = wire[4 * i32_n:]
    s32, s8 = [0], [0]
    w1d = _wire_cut(i32v, s32, d_pad)
    w3d = _wire_cut(i32v, s32, d_pad)
    d_pos = _wire_cut(i32v, s32, d_pad)
    row_slot = _wire_cut(i32v, s32, n_pad)
    seq = _wire_cut(i32v, s32, n_pad)
    coo_row = _wire_cut(i32v, s32, nnz_pad)
    coo_val = _wire_cut(i32v, s32, nnz_pad)
    job_start = _wire_cut(i32v, s32, K)
    job_n = _wire_cut(i32v, s32, K)
    d_ahi = _wire_cut(u8v, s8, d_pad).to(_I32)
    actor = _wire_cut(u8v, s8, n_pad).to(_I32)
    flags_u8 = _wire_cut(u8v, s8, 2 * (n_pad >> 3))
    coo_col = _wire_cut(u8v, s8, nnz_pad).to(_I32)
    return (w1d, w3d, d_pos, row_slot, seq, coo_row, coo_val,
            job_start, job_n, d_ahi, actor, flags_u8, coo_col)


def _take(table, idx):
    """``table[idx]`` with the index clamped into the table (the
    reference's in-range small-table gathers: rank tables, remaps)."""
    return table[idx.to(torch.int64).clamp(0, table.shape[0] - 1)]


def _fused_general_packed(w1m, w2m, tpm, wire, n_old, n_rows,
                          rank_remap, *, sizes, num_segments, a_pad,
                          m_pad, has_remap, has_old):
    """One apply against the PACKED device-resident mirror — the
    whole-object REBUILD variant: every dirty sequence re-orders from
    scratch via `_rga_order_batched`, and the fresh tree positions
    (re)initialize the persistent 'tp' index plane. Outputs:
    (w1', w2', tp', surv_u8, winner[S], vis_packed[K, m_pad]) where
    vis_packed = prior_vis<<31 | visible<<30 | (prior_idx+1)<<15
    | (new_idx+1) — the host unpacks via a uint32 view."""
    from .sequence import _rga_order_batched
    d_pad, n_pad, K, nnz_pad = sizes
    cap = w1m.shape[0]
    dev = w1m.device

    (w1d, d_pos, row_slot, coo_row, job_start, job_n, w2e, seq,
     coo_val, actor, flags_u8, coo_col) = _parse_wire_packed(wire, sizes)

    if has_remap:
        r_idx = (w1m & 0xFFFF).to(torch.int64) \
            .clamp(max=rank_remap.shape[0] - 1)
        w1m = (w1m & ~0xFFFF) | rank_remap[r_idx].to(_I32)

    # ---- fold the new nodes into the pos-ordered mirror ----
    tgt_new = d_pos + torch.arange(d_pad, dtype=_I32, device=dev)
    if has_old:
        i = torch.arange(cap, dtype=_I32, device=dev)
        cnt = _insert_counts(d_pos, cap)
        tgt_old = torch.where(i < n_old, i + cnt, torch.full_like(i, cap))
    else:
        # first resident apply: the mirror is empty, nothing merges
        tgt_old = None
    w1f = _fold(w1m, w1d, tgt_old, tgt_new, 0)
    w2f = _fold(w2m, w2e, tgt_old, tgt_new, 0)   # new nodes: hidden
    tpf = _fold(tpm, torch.zeros(d_pad, dtype=_I32, device=dev), tgt_old,
                tgt_new, 0)

    # ---- job planes ----
    pos_mat, valid_plane, pos_c = _job_planes(job_start, job_n, m_pad, cap)
    w1p = w1f[pos_c]
    w2p = w2f[pos_c]
    s_parent = w1p >> 16
    s_rank = w1p & 0xFFFF            # rank+1 — same order as rank
    s_elem = w2p & _W2_ELEM
    prior_vis = ((w2p >> _W2_VIS_SHIFT) & 1).to(torch.bool) & valid_plane
    prior_idx = torch.where(valid_plane,
                            ((w2p >> _W2_IDX_SHIFT) & _W2_ELEM) - 1,
                            torch.full_like(w2p, -1))

    # ---- field resolution (scan-based; rows arrive field-sorted) ----
    valid, out = _resolve_rows(flags_u8, actor, seq, n_rows, a_pad,
                               coo_row, coo_col, coo_val, num_segments)

    # ---- element visibility ----
    touched, vis_hit = _vis_grid(row_slot, valid, out['surviving'], K,
                                 m_pad)
    visible = torch.where(touched, vis_hit, prior_vis) & valid_plane
    ordered = _rga_order_batched(s_parent, s_elem, s_rank, visible,
                                 valid_plane)
    new_idx = ordered['vis_index']

    # ---- scatter the updated vis word + tree positions back ----
    w2n = (visible.to(_I32) << _W2_VIS_SHIFT) | \
        ((new_idx + 1) << _W2_IDX_SHIFT) | s_elem
    scatter_pos = torch.where(valid_plane, pos_mat,
                              torch.full_like(pos_mat, cap))
    w2f = _scatter_set(w2f, scatter_pos, w2n)
    tpf = _scatter_set(tpf, scatter_pos, ordered['tree_pos'])

    surv_u8 = _pack_bits(out['surviving'])
    vis_packed = (prior_vis.to(_I32) << 31) | \
        (visible.to(_I32) << 30) | \
        ((prior_idx + 1) << _W2_IDX_SHIFT) | (new_idx + 1)
    return w1f, w2f, tpf, surv_u8, out['winner'], vis_packed


def _fused_general_wide(w1m, w2m, w3m, tpm, wire, n_old, n_rows,
                        rank_table, *, sizes, num_segments, a_pad,
                        m_pad, has_old):
    """One apply against the WIDE 3-word packed mirror (trees to
    2^22 - 1 nodes; elemc/seq bounded only by int32). Same program
    shape as `_fused_general_packed` with the wide bit layout, int32
    seq/coo wire sections and actor ids (stable) in the words instead
    of ranks — the RGA rank rides the small `rank_table` gather, so a
    growing actor table never remaps the mirror. The whole-object
    REBUILD variant: fresh tree positions (re)initialize the
    persistent 'tp' index plane. Outputs: (w1', w2', w3', tp',
    surv_u8, winner[S], vis_prior[K, m_pad], vis_new[K, m_pad]);
    each vis plane word is ``visible << 22 | (idx + 1)``
    (`unpack_wide_word`)."""
    from .sequence import _rga_order_batched
    d_pad, n_pad, K, nnz_pad = sizes
    cap = w1m.shape[0]
    dev = w1m.device

    (w1d, w3d, d_pos, row_slot, seq, coo_row, coo_val, job_start,
     job_n, d_ahi, actor, flags_u8, coo_col) = _parse_wire_wide(wire, sizes)

    # ---- fold the new nodes into the pos-ordered mirror ----
    tgt_new = d_pos + torch.arange(d_pad, dtype=_I32, device=dev)
    if has_old:
        i = torch.arange(cap, dtype=_I32, device=dev)
        cnt = _insert_counts(d_pos, cap)
        tgt_old = torch.where(i < n_old, i + cnt, torch.full_like(i, cap))
    else:
        tgt_old = None
    w1f = _fold(w1m, w1d, tgt_old, tgt_new, 0)
    # new nodes: hidden, vis_index+1 = 0, actor-hi bits ride along
    w2f = _fold(w2m, d_ahi << _WIDE_AHI_SHIFT, tgt_old, tgt_new, 0)
    w3f = _fold(w3m, w3d, tgt_old, tgt_new, 0)
    tpf = _fold(tpm, torch.zeros(d_pad, dtype=_I32, device=dev), tgt_old,
                tgt_new, 0)

    # ---- job planes ----
    pos_mat, valid_plane, pos_c = _job_planes(job_start, job_n, m_pad, cap)
    w1p = w1f[pos_c]
    w2p = w2f[pos_c]
    s_elem = w3f[pos_c]
    s_parent = (w1p >> _WIDE_PARENT_SHIFT) & _WIDE_IDX_MASK
    actor1 = (w1p & _WIDE_ALO_MASK) | \
        (((w2p >> _WIDE_AHI_SHIFT) & 0x3F) << 10)
    s_rank = _take(rank_table, actor1)
    prior_vis = ((w2p >> _WIDE_VIS_SHIFT) & 1).to(torch.bool) & valid_plane
    prior_idx = torch.where(valid_plane, (w2p & _WIDE_IDX_MASK) - 1,
                            torch.full_like(w2p, -1))

    # ---- field resolution (scan-based; rows arrive field-sorted) ----
    valid, out = _resolve_rows(flags_u8, actor, seq, n_rows, a_pad,
                               coo_row, coo_col, coo_val, num_segments)

    # ---- element visibility ----
    touched, vis_hit = _vis_grid(row_slot, valid, out['surviving'], K,
                                 m_pad)
    visible = torch.where(touched, vis_hit, prior_vis) & valid_plane
    ordered = _rga_order_batched(s_parent, s_elem, s_rank, visible,
                                 valid_plane)
    new_idx = ordered['vis_index']

    # ---- scatter the updated vis word + tree positions back ----
    w2n = (w2p & _WIDE_AHI_BITS) | \
        (visible.to(_I32) << _WIDE_VIS_SHIFT) | (new_idx + 1)
    scatter_pos = torch.where(valid_plane, pos_mat,
                              torch.full_like(pos_mat, cap))
    w2f = _scatter_set(w2f, scatter_pos, w2n)
    tpf = _scatter_set(tpf, scatter_pos, ordered['tree_pos'])

    surv_u8 = _pack_bits(out['surviving'])
    vis_prior = (prior_vis.to(_I32) << _WIDE_VIS_SHIFT) | (prior_idx + 1)
    vis_new = (visible.to(_I32) << _WIDE_VIS_SHIFT) | (new_idx + 1)
    return w1f, w2f, w3f, tpf, surv_u8, out['winner'], vis_prior, vis_new


def _fused_general_incr(w1m, w2m, w3m, tpm, wire, jd_base, ws, n_old,
                        n_rows, aux, *, fmt, sizes, num_segments,
                        a_pad, m_pad, dm_pad, has_remap):
    """One apply as an INCREMENTAL index update (Jiffy-style batch
    insert) against the packed/WIDE resident mirror: instead of
    re-deriving every dirty sequence's order from scratch, this merges
    the tick's delta into the PERSISTENT tree-position plane ('tp'):

    1. the delta nodes order among THEMSELVES with
       `_rga_delta_order_batched` over [K, dm_pad+1] planes (the RGA
       kernel's delta mode on the card) — independent of tree size;
    2. ONE prefix-sum pass over the [K, m_pad] planes splices them in:
       old node at position p shifts by #{delta anchors < p}, delta
       node with group anchor a and delta rank r lands at a + r + 1;
    3. the visibility index rebuilds with a scatter + cumsum + gather
       (deletes/sets are pure visibility flips — zero sort work).

    Valid only under the host-checked FRONT-INSERT precondition (every
    delta root's elem exceeds its object's pre-tick max elem) and only
    for objects whose 'tp' plane is current (`pool.idx_ok`); the host
    falls back to the rebuild variant otherwise. ``aux`` is the packed
    format's rank_remap (`has_remap`) or the wide format's rank_table.

    SUFFIX WINDOW (``ws``, int32[K]): for chain-shaped objects the host
    may bound each job to the suffix window [ws_j, n_j) that contains
    every delta anchor and every touched node: ``job_start`` arrives
    rebased by ws_j, ``jd_base`` arrives window-RELATIVE, m_pad is the
    padded WINDOW width, and the plane holds only the window's nodes.
    Inside the program tp VALUES stay absolute while plane INDICES are
    window-relative (offset by ws_j); the visible count the window
    skips (``pvis``) reads from the folded mirror's own vis bits.
    ``ws = 0`` reduces every rebase to the identity. Below-window
    mirror words are never rewritten.

    Same wire layout, resolution pipeline and output contract as the
    matching rebuild variant. Returns the uniform 8-tuple (w1', w2',
    w3', tp', surv_u8, winner, visA, visB): packed sets w3' = w3m (None)
    and visA = visB = vis_packed; wide returns vis_prior/vis_new."""
    from .sequence import _rga_delta_order_batched
    d_pad, n_pad, K, nnz_pad = sizes
    cap = w1m.shape[0]
    dev = w1m.device

    # ---- wire parse: the rebuild variants' section layouts ----
    if fmt == 'packed':
        (w1d, d_pos, row_slot, coo_row, job_start, job_n, w2e, seq,
         coo_val, actor, flags_u8, coo_col) = _parse_wire_packed(wire, sizes)
        if has_remap:
            w1m = (w1m & ~0xFFFF) | _take(aux, w1m & 0xFFFF).to(_I32)
    else:
        (w1d, w3d, d_pos, row_slot, seq, coo_row, coo_val, job_start,
         job_n, d_ahi, actor, flags_u8, coo_col) = \
            _parse_wire_wide(wire, sizes)

    # ---- fold the new nodes in (an existing mirror is a precondition
    # of the incremental path). Inverse-gather formulation: each output
    # slot GATHERS its source through one prefix sum over the delta-slot
    # marks, and only the d_pad delta values scatter. ----
    i = torch.arange(cap, dtype=_I32, device=dev)
    tgt_new = d_pos + torch.arange(d_pad, dtype=_I32, device=dev)
    in_new = _scatter_set(torch.zeros(cap + 1, dtype=torch.bool,
                                      device=dev), tgt_new,
                          torch.ones(d_pad, dtype=torch.bool,
                                     device=dev))[:cap]
    d_before = torch.cumsum(in_new.to(_I32), dim=0, dtype=_I32)
    src = (i - d_before).clamp(0, cap - 1).to(torch.int64)

    def fold(col, dcol):
        base = torch.where(in_new, torch.zeros_like(col), col[src])
        return _scatter_set(base, tgt_new, dcol)

    w1f = fold(w1m, w1d)
    if fmt == 'packed':
        w2f = fold(w2m, w2e)
        w3f = w3m
    else:
        w2f = fold(w2m, d_ahi << _WIDE_AHI_SHIFT)
        w3f = fold(w3m, w3d)
    tpf = fold(tpm, torch.zeros(d_pad, dtype=_I32, device=dev))

    # ---- suffix-window prefix: #visible nodes each job skips below its
    # window, straight off the folded mirror (positions [job_start - ws,
    # job_start) hold exactly the skipped locals [0, ws); new nodes
    # splice above them and carry vis bit 0). ws = 0 gives pvis = 0. ----
    vshift = _W2_VIS_SHIFT if fmt == 'packed' else _WIDE_VIS_SHIFT
    visbit = ((w2f >> vshift) & 1).to(_I32)
    vcum = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                      torch.cumsum(visbit, dim=0, dtype=_I32)])
    pvis = vcum[job_start.to(torch.int64).clamp(0, cap)] - \
        vcum[(job_start - ws).to(torch.int64).clamp(0, cap)]

    # ---- job planes ----
    l = torch.arange(m_pad, dtype=_I32, device=dev)
    rowi = torch.arange(K, dtype=torch.int64, device=dev)[:, None]
    pos_mat, valid_plane, pos_c = _job_planes(job_start, job_n, m_pad, cap)
    w1p = w1f[pos_c]
    w2p = w2f[pos_c]
    tpp = tpf[pos_c]
    if fmt == 'packed':
        s_parent = w1p >> 16
        s_rank = w1p & 0xFFFF
        s_elem = w2p & _W2_ELEM
        prior_vis = ((w2p >> _W2_VIS_SHIFT) & 1).to(torch.bool) \
            & valid_plane
        prior_idx = torch.where(valid_plane,
                                ((w2p >> _W2_IDX_SHIFT) & _W2_ELEM) - 1,
                                torch.full_like(w2p, -1))
    else:
        s_elem = w3f[pos_c]
        s_parent = (w1p >> _WIDE_PARENT_SHIFT) & _WIDE_IDX_MASK
        actor1 = (w1p & _WIDE_ALO_MASK) | \
            (((w2p >> _WIDE_AHI_SHIFT) & 0x3F) << 10)
        s_rank = _take(aux, actor1)
        prior_vis = ((w2p >> _WIDE_VIS_SHIFT) & 1).to(torch.bool) \
            & valid_plane
        prior_idx = torch.where(valid_plane, (w2p & _WIDE_IDX_MASK) - 1,
                                torch.full_like(w2p, -1))

    # ---- field resolution (identical to the rebuild variants) ----
    valid, out = _resolve_rows(flags_u8, actor, seq, n_rows, a_pad,
                               coo_row, coo_col, coo_val, num_segments)

    # ---- element visibility ----
    touched, vis_hit = _vis_grid(row_slot, valid, out['surviving'], K,
                                 m_pad)
    visible = torch.where(touched, vis_hit, prior_vis) & valid_plane

    # ---- incremental order update: delta ordering + ONE prefix-sum
    # merge against the persistent 'tp' plane ----
    jd = jd_base[:, None]
    wsc = ws[:, None]
    is_old_node = (l[None, :] < jd) & valid_plane
    dj = torch.arange(dm_pad, dtype=_I32, device=dev)
    dcols = jd + dj[None, :]
    dvalid = dj[None, :] < (job_n - jd_base)[:, None]
    dcols_c = torch.where(dvalid, dcols, torch.zeros_like(dcols)) \
        .clamp(0, m_pad - 1).to(torch.int64)
    dparent = torch.gather(s_parent, 1, dcols_c)
    delem = torch.gather(s_elem, 1, dcols_c)
    drank = torch.gather(s_rank, 1, dcols_c)
    # a delta node whose parent pre-existed is a delta ROOT; its anchor
    # is the parent's OLD tree position (front-insert: the whole group
    # splices immediately after the anchor). dparent is an absolute
    # local index; the window plane rebases it by ws.
    dparent_rel = dparent - wsc
    p_old = dvalid & (dparent_rel < jd)
    anchor = torch.gather(tpp, 1,
                          dparent_rel.clamp(0, m_pad - 1).to(torch.int64))
    zero = torch.zeros_like(anchor)

    def pad1(x, fill):
        return torch.cat([torch.full((K, 1), fill, dtype=x.dtype,
                                     device=dev), x], dim=1)

    anch1 = pad1(torch.where(p_old, anchor, zero), 0)
    dpos = _rga_delta_order_batched(
        pad1(torch.where(p_old, zero, dparent_rel - jd + 1), 0),
        anch1, pad1(delem, 0), pad1(drank, 0), pad1(dvalid, True))
    dm1 = dm_pad + 1
    is_root1 = pad1(p_old, False)
    dvalid1 = pad1(dvalid, False)
    dpos_c = dpos.clamp(0, dm1 - 1).to(torch.int64)
    # group anchor per delta DFS position: roots scatter theirs, the
    # running max propagates it over each root's (contiguous) subtree —
    # anchors ascend across groups by construction of the sort
    anch_at = torch.zeros((K, dm1), dtype=_I32, device=dev).scatter_reduce(
        1, torch.where(is_root1, dpos_c, torch.zeros_like(dpos_c)),
        torch.where(is_root1, anch1, torch.zeros_like(anch1)), 'amax',
        include_self=True)
    a_pos = torch.cummax(anch_at, dim=1).values
    a_of = torch.gather(a_pos, 1, dpos_c)
    d_tp = a_of + dpos                 # final position: a + r + 1
    # old-node shift = #{delta anchors < old position}: scatter-add the
    # anchors, one cumsum — THE merge prefix-sum (anchor tp values are
    # absolute; the plane index is window-relative)
    a_col = torch.where(dvalid1, (a_of - wsc).clamp(0, m_pad - 1),
                        torch.zeros_like(a_of)).to(torch.int64)
    cnt_a = torch.zeros((K, m_pad), dtype=_I32, device=dev).scatter_add(
        1, a_col, dvalid1.to(_I32))
    cum_a = torch.cumsum(cnt_a, dim=1, dtype=_I32)
    tpp_c = (tpp - wsc).clamp(0, m_pad - 1).to(torch.int64)
    shift = torch.gather(cum_a, 1, tpp_c) - torch.gather(cnt_a, 1, tpp_c)
    tp_new = torch.where(is_old_node, tpp + shift, torch.zeros_like(tpp))
    dslot = torch.where(dvalid1, pad1(dcols, 0),
                        torch.full_like(a_of, m_pad)).to(torch.int64)
    tp_new = torch.cat([tp_new, torch.zeros((K, 1), dtype=_I32,
                                            device=dev)], dim=1) \
        .scatter(1, dslot, d_tp)[:, :m_pad]

    # ---- visibility index over the updated order (one flat permutation
    # scatter + cumsum + gather; tp_new is injective per job over the
    # chain). Windowed jobs renumber only the suffix: relative positions
    # start at 0 and the skipped prefix re-enters as the pvis offset. ----
    on_chain = valid_plane & (tp_new > 0) & (tp_new >= wsc)
    tp_rel = torch.where(on_chain, tp_new - wsc, torch.zeros_like(tp_new))
    flat_tp = torch.where(on_chain, rowi.to(_I32) * m_pad + tp_rel,
                          torch.full_like(tp_rel, K * m_pad))
    vis_ord = _scatter_set(
        torch.zeros(K * m_pad + 1, dtype=torch.bool, device=dev), flat_tp,
        visible & on_chain)[:K * m_pad].reshape(K, m_pad)
    vo = vis_ord.to(_I32)
    vis_rank = torch.cumsum(vo, dim=1, dtype=_I32) - vo
    new_idx = torch.gather(vis_rank, 1,
                           tp_rel.clamp(max=m_pad - 1).to(torch.int64)) + \
        pvis[:, None]
    new_idx = torch.where(visible & on_chain, new_idx,
                          torch.full_like(new_idx, -1))

    # ---- write the updated vis word + tree positions back: every job's
    # nodes are ONE contiguous pos window, so window membership and the
    # owning job come from K-sized mark scatters + one prefix max, and
    # each mirror slot gathers its updated value ----
    if fmt == 'packed':
        w2n = (visible.to(_I32) << _W2_VIS_SHIFT) | \
            ((new_idx + 1) << _W2_IDX_SHIFT) | s_elem
    else:
        w2n = (w2p & _WIDE_AHI_BITS) | \
            (visible.to(_I32) << _WIDE_VIS_SHIFT) | (new_idx + 1)
    real_job = job_n > 0
    capv = torch.full_like(job_start, cap)
    one = real_job.to(_I32)
    marks = torch.zeros(cap + 1, dtype=_I32, device=dev)
    marks = _scatter_reduce(marks, torch.where(real_job, job_start, capv),
                            one, 'sum')
    marks = _scatter_reduce(marks, torch.where(real_job, job_start + job_n,
                                               capv), -one, 'sum')
    in_win = torch.cumsum(marks[:cap], dim=0, dtype=_I32) > 0
    job_mark = _scatter_reduce(
        torch.zeros(cap + 1, dtype=_I32, device=dev),
        torch.where(real_job, job_start, capv),
        torch.arange(1, K + 1, dtype=_I32, device=dev), 'amax')
    job_at = torch.cummax(job_mark[:cap], dim=0).values - 1
    job_c = job_at.clamp(min=0).to(torch.int64)
    l_at = (i - job_start[job_c]).clamp(0, m_pad - 1).to(torch.int64)
    flat_at = job_c * m_pad + l_at

    def write_back(col, plane):
        return torch.where(in_win, plane.reshape(-1)[flat_at], col)

    w2f = write_back(w2f, w2n)
    tpf = write_back(tpf, tp_new)

    surv_u8 = _pack_bits(out['surviving'])
    if fmt == 'packed':
        vis_packed = (prior_vis.to(_I32) << 31) | \
            (visible.to(_I32) << 30) | \
            ((prior_idx + 1) << _W2_IDX_SHIFT) | (new_idx + 1)
        vis_a = vis_b = vis_packed
    else:
        vis_a = (prior_vis.to(_I32) << _WIDE_VIS_SHIFT) | (prior_idx + 1)
        vis_b = (visible.to(_I32) << _WIDE_VIS_SHIFT) | (new_idx + 1)
    return w1f, w2f, w3f, tpf, surv_u8, out['winner'], vis_a, vis_b


def _mirror_tp_in(mir, cap, n_total, device):
    """The persistent 'tp' plane as this apply's input: grown with the
    mirror capacity; zeros when absent (first mirror) — the rebuild
    variant then (re)writes the dirty objects' slots and validates
    them."""
    if mir is None or 'tp' not in mir:
        return torch.zeros(cap, dtype=_I32, device=device)
    if mir['cap'] < n_total:
        return torch.cat([mir['tp'], torch.zeros(cap - mir['cap'],
                                                 dtype=_I32,
                                                 device=device)])
    return mir['tp']


def _pick_incremental(pool, mir, dirty, n_j, nof_pre, mel_pre, n_old,
                      n_total, m_pad, opts, parent_d, elemc_d):
    """Mode switch + eligibility + counters for one packed/wide apply.
    Returns the eligibility tuple or None (rebuild)."""
    incr = None
    if (_INDEX_MODE != 'rebuild' and mir is not None
            and 'tp' in mir and n_old > 0 and len(dirty)):
        incr = _incr_eligibility(pool, dirty, n_j, nof_pre, mel_pre,
                                 n_old, n_total, m_pad, parent_d,
                                 elemc_d, opts)
    if incr is not None:
        metrics.bump('device_idx_incremental_applies')
        metrics.bump('device_idx_delta_nodes', int(n_total - n_old))
    else:
        if len(dirty):
            metrics.bump('device_idx_rebuild_applies')
        if _INDEX_MODE == 'require' and len(dirty):
            # loud, with store rollback via the apply txn: an
            # invalidation path that silently falls back is a bug the
            # tests must see
            raise RuntimeError(
                "incremental index path required (_INDEX_MODE="
                "'require') but this apply is ineligible")
    return incr


def _incr_eligibility(pool, dirty, n_j, nof_pre, mel_pre, n_old,
                      n_total, m_pad, parent_d, elemc_d, opts):
    """Host gate of the incremental-index path: O(delta) checks that
    every dirty object's persistent 'tp' plane is current
    (``pool.idx_ok``) and that every delta node with a PRE-EXISTING
    parent is a front insert (elem strictly above the object's
    pre-tick max elem, hence above every existing sibling — the
    sequential-typing and concurrent-append shape). A late/concurrent
    interleaving insert, a first-sight object or an oversized delta
    returns None: the apply takes the whole-object rebuild variant,
    which re-validates the index for its dirty set. Returns
    ``(dm_pad, jd_base, min_rp)`` on success, where ``min_rp[j]`` is
    the smallest PRE-EXISTING parent local any of job j's delta nodes
    anchors to (``jd_base[j]`` when none) — the anchor bound the
    suffix-window pick (`_apply_window`) intersects with the touched
    rows."""
    K_jobs = len(dirty)
    if K_jobs == 0:
        return None
    hi_obj = int(dirty.max())
    if hi_obj >= len(pool.idx_ok) or hi_obj >= len(nof_pre):
        return None
    if not pool.idx_ok[dirty].all():
        metrics.bump('device_idx_invalidations')
        return None
    old_nof = nof_pre[dirty]
    if (old_nof < 1).any():
        return None
    jd_n = n_j - old_nof
    if (jd_n < 0).any():
        return None
    dm = int(jd_n.max()) if K_jobs else 0
    if dm and 2 * dm > int(n_j.max()):
        # the delta approaches the tree size (bulk load, first fill):
        # the rebuild is no more work and re-validates the index
        return None
    dm_pad = opts.pad_nodes(max(dm, 8))
    d_n = n_total - n_old
    min_rp = old_nof.astype(np.int64).copy()
    if d_n:
        # delta obj column in pos order == the sorted append-order
        # column (pos order sorts by (obj, local); within one object
        # the values are identical, so alignment with the d planes
        # holds rowwise)
        obj_d = np.sort(pool.obj[n_old:n_total]).astype(np.int64)
        pos = np.searchsorted(dirty, obj_d)
        safe = np.minimum(pos, K_jobs - 1)
        in_dirty = (pos < K_jobs) & (dirty[safe] == obj_d)
        if in_dirty.any():
            par = np.asarray(parent_d[:d_n])[in_dirty]
            base = old_nof[safe[in_dirty]]
            rooted = par < base
            if rooted.any():
                mel = mel_pre[obj_d[in_dirty][rooted]]
                el = np.asarray(elemc_d[:d_n])[in_dirty][rooted] \
                    .astype(np.int64)
                if (el <= mel).any():
                    metrics.bump('device_idx_invalidations')
                    return None
                np.minimum.at(min_rp, safe[in_dirty][rooted],
                              par[rooted].astype(np.int64))
    return dm_pad, old_nof.astype(np.int32), min_rp


def _apply_window(lin_pre, dirty, n_j, jd_base, min_rp, row_slot_v,
                  job_start_v, job_n_v, m_pad, n_rows, K, opts):
    """Suffix-window gate + in-place wire rewrite for an incremental
    apply. A job windows when its pre-append tree is a pure chain
    (``pool.idx_linear``: parent[local] == local-1 for every real
    node, so tree position == local and any suffix of locals is a
    suffix of tree positions) — then nothing below
    ``ws = min(min rooted delta parent, min touched node local)``
    can change visibility or index, and the device only needs the
    plane columns [ws, n). Rewrites the HOST wire's job_start (+= ws),
    job_n (-= ws) and row_slot (rebased to window columns with the
    shrunk per-job stride ``w_pad``) sections IN PLACE, through numpy
    views, before the wire crosses to the device as one copy. Returns
    ``(w_pad, ws_k, jd_rel, win_n)`` or None (dispatch whole-plane):
    only engages when the windowed plane is a strictly smaller bucket
    than the full one — zeros in ``ws_k`` padding rows keep the
    program's math an identity there."""
    kj = len(dirty)
    if kj == 0 or int(dirty.max()) >= len(lin_pre):
        return None
    if not lin_pre[dirty].all():
        return None
    ws = np.minimum(jd_base.astype(np.int64), min_rp)
    rs = np.asarray(row_slot_v[:n_rows])
    ok = rs >= 0
    loc = nd = None
    if ok.any():
        loc = rs[ok].astype(np.int64) // m_pad
        nd = rs[ok].astype(np.int64) % m_pad
        np.minimum.at(ws, loc, nd)
    ws = np.maximum(ws, 0)
    win_n = n_j.astype(np.int64) - ws
    w_pad = opts.pad_nodes(max(int(win_n.max()), 8))
    if w_pad >= m_pad:
        return None
    if loc is not None:
        row_slot_v[:n_rows][ok] = \
            (loc * w_pad + (nd - ws[loc])).astype(np.int32)
    job_start_v[:kj] = job_start_v[:kj] + ws.astype(np.int32)
    job_n_v[:kj] = win_n.astype(job_n_v.dtype)
    jd_rel = (jd_base.astype(np.int64) - ws).astype(np.int32)
    ws_k = np.zeros(K, np.int32)
    ws_k[:kj] = ws
    return w_pad, ws_k, jd_rel, win_n


def _pick_window(lin_pre, dirty, n_j, jd_base, min_rp, rs_v, js_v, jn_v,
                 m_pad, n_rows, K, opts):
    """Mode switch + counter around `_apply_window` for one incremental
    apply: returns ``(window or None, ws_k)`` — ``ws_k`` all zeros when
    the apply dispatches whole-plane. ``_WINDOW_MODE='require'`` raises
    where the window cannot engage."""
    win = None
    if _WINDOW_MODE != 'off' and _blocks._delta_host_on():
        win = _apply_window(lin_pre, dirty, n_j, jd_base, min_rp, rs_v,
                            js_v, jn_v, m_pad, n_rows, K, opts)
    if win is not None:
        metrics.bump('device_idx_window_applies')
        return win, win[1]
    if _WINDOW_MODE == 'require' and len(dirty):
        raise RuntimeError(
            "suffix-window path required (_WINDOW_MODE="
            "'require') but this apply cannot window")
    return None, np.zeros(K, np.int32)


def _mirror_pack(parent, elemc, actor, visible, visidx, rank_table):
    """cols -> packed mirror (format upgrade when the guards pass)."""
    rank1 = _take(rank_table, actor + 1) + 1
    rank1 = torch.where(actor < 0, torch.zeros_like(rank1), rank1)
    w1 = (parent << 16) | rank1
    w2 = (visible.to(_I32) << _W2_VIS_SHIFT) | \
        ((visidx + 1) << _W2_IDX_SHIFT) | elemc
    return w1, w2


def _mirror_unpack(w1, w2, rank_to_actor):
    """packed -> cols mirror (format downgrade before a fallback
    apply). `rank_to_actor[rank+1]` = actor id (-1 at 0/head)."""
    parent = w1 >> 16
    actor = _take(rank_to_actor, w1 & 0xFFFF)
    elemc = w2 & _W2_ELEM
    visible = ((w2 >> _W2_VIS_SHIFT) & 1).to(torch.bool)
    visidx = ((w2 >> _W2_IDX_SHIFT) & _W2_ELEM) - 1
    return parent, elemc, actor, visible, visidx


def _mirror_pack_wide(parent, elemc, actor, visible, visidx):
    """cols -> WIDE mirror words (stable actor ids, no rank table)."""
    actor1 = actor + 1                       # head (-1) -> 0
    w1 = (parent << _WIDE_PARENT_SHIFT) | (actor1 & _WIDE_ALO_MASK)
    w2 = ((actor1 >> 10) << _WIDE_AHI_SHIFT) | \
        (visible.to(_I32) << _WIDE_VIS_SHIFT) | (visidx + 1)
    return w1, w2, elemc


def _mirror_unpack_wide(w1, w2, w3):
    """WIDE -> cols mirror pieces."""
    parent = (w1 >> _WIDE_PARENT_SHIFT) & _WIDE_IDX_MASK
    actor1 = (w1 & _WIDE_ALO_MASK) | \
        (((w2 >> _WIDE_AHI_SHIFT) & 0x3F) << 10)
    actor = actor1 - 1
    visible = ((w2 >> _WIDE_VIS_SHIFT) & 1).to(torch.bool)
    visidx = (w2 & _WIDE_IDX_MASK) - 1
    return parent, w3, actor, visible, visidx


def _rank_table(store, opts):
    """actor-id -> string-rank device table, 1-BASED (slot 0 is the
    head sentinel) — the layout `_mirror_pack`/the cols program index
    with `actor + 1`."""
    n_act = len(store.actors)
    rt = np.zeros(opts.pad_actors(n_act + 1), np.int32)
    rt[1:n_act + 1] = store.actor_str_ranks()
    return _dev(rt, store.device)


def _mirror_convert(mir, to_fmt, store, opts):
    """Convert a resident mirror between the packed/wide/cols formats
    (a store crossing a format guard mid-stream — e.g. a text document
    growing past 32767 nodes upgrades packed -> wide IN PLACE and keeps
    riding a fused packed program). Elementwise device ops plus
    small-table gathers, on the mirror's device; same cap/n/pos_row.
    Every conversion bumps a `general_mirror_convert_<from>_to_<to>`
    counter so a fleet silently living on a slower format is visible."""
    n_act = len(store.actors)
    from_fmt = mir.get('fmt', 'cols')
    metrics.bump('general_mirror_converts')
    metrics.bump(f'general_mirror_convert_{from_fmt}_to_{to_fmt}')
    if from_fmt == 'packed':
        old_ranks = mir['ranks']
        inv = np.full(opts.pad_actors(len(old_ranks) + 2), -1, np.int32)
        inv[old_ranks + 1] = np.arange(len(old_ranks))
        parent, elemc, actor, visible, visidx = _mirror_unpack(
            mir['w1'], mir['w2'], _dev(inv, store.device))
    elif from_fmt == 'wide':
        parent, elemc, actor, visible, visidx = _mirror_unpack_wide(
            mir['w1'], mir['w2'], mir['w3'])
    else:
        parent, elemc, actor, visible, visidx = (
            mir['parent'], mir['elemc'], mir['actor'], mir['visible'],
            mir['vis_index'])
    base = {'cap': mir['cap'], 'n': mir['n'], 'pos_row': mir['pos_row']}
    # the order index is format-independent (tree_pos per node): it
    # carries through packed<->wide conversions untouched, so idx_ok
    # claims survive a format crossing; the cols fallback drops it (no
    # incremental program there — the caller resets idx_ok)
    if to_fmt in ('packed', 'wide') and 'tp' in mir:
        base['tp'] = mir['tp']
    if to_fmt == 'packed':
        ranks = np.asarray(store.actor_str_ranks())
        w1, w2 = _mirror_pack(parent, elemc, actor, visible, visidx,
                              _rank_table(store, opts))
        return {'fmt': 'packed', 'w1': w1, 'w2': w2,
                'ranks': ranks.copy(), **base}
    if to_fmt == 'wide':
        w1, w2, w3 = _mirror_pack_wide(parent, elemc, actor, visible,
                                       visidx)
        return {'fmt': 'wide', 'w1': w1, 'w2': w2, 'w3': w3,
                'rank_n': n_act, 'rank_table': _rank_table(store, opts),
                **base}
    return {'fmt': 'cols',
            'parent': parent, 'elemc': elemc, 'actor': actor,
            'visible': visible, 'vis_index': visidx,
            'rank_n': n_act, 'rank_table': _rank_table(store, opts),
            **base}


# Estimated device bytes per resident mirror row, by format: packed =
# two int32 words + the int32 tree_pos index plane, wide = three + the
# index plane, cols = parent/elemc/actor/vis_index int32 + visible
# bool (no index plane — the cols fallback always rebuilds). Host
# arithmetic only — memory accounting must never force a device sync.
_MIRROR_ROW_BYTES = {'packed': 12, 'wide': 16, 'cols': 17}


def mirror_bytes(mir):
    """Estimated device-plane bytes of a resident mirror dict (0 when
    no mirror has materialized) — the per-store read behind the
    ``fleet_status()['memory']`` block and the process-wide
    ``mem_device_plane_bytes`` gauge."""
    if not mir:
        return 0
    return _MIRROR_ROW_BYTES.get(mir.get('fmt'), 17) * \
        int(mir.get('cap', 0))


def _update_mirror_gauges(fmt, cap):
    """Refresh the device-plane memory gauges after an apply installed
    a mirror of ``fmt`` at capacity ``cap`` (last-applied store wins —
    the gauges are process-level; per-store truth lives in
    ``fleet_status()['memory']``). The non-active formats read 0 so a
    dashboard sees format transitions, and the peak watermark only
    ratchets up."""
    total = _MIRROR_ROW_BYTES[fmt] * cap
    metrics.set_gauge('mem_device_plane_bytes', total)
    metrics.set_gauge('mem_device_packed_bytes',
                      total if fmt == 'packed' else 0)
    metrics.set_gauge('mem_device_wide_bytes',
                      total if fmt == 'wide' else 0)
    metrics.set_gauge('mem_device_cols_bytes',
                      total if fmt == 'cols' else 0)
    metrics.ratchet('mem_device_plane_peak_bytes', total)


# -- apply -------------------------------------------------------------------

class GeneralPatch:
    """Patches from one general apply. The winner/visibility-dependent
    columns live on DEVICE until first use (`_ensure`) — an apply-only
    pipeline (the DocSet ingestion hot path) never fetches them;
    `diffs(d)` / `to_patches()` materialize reference-format dicts."""

    __slots__ = ('store', 'n_docs', 'creates', 'f_doc', 'f_obj', 'f_key',
                 'f_kind', 'f_has_winner', 'f_value', 'f_actor', 'f_link',
                 's_ptr', 's_actor', 's_value', 's_link', 'seq_edits',
                 'clock_rows', 'keys', 'values', 'actors', '_raw',
                 '_ready', '__weakref__')

    def __init__(self, store):
        self.store = store
        self.n_docs = store.n_docs
        self.creates = []        # (doc, obj uuid, type name) in op order
        self.seq_edits = {}      # obj_row -> dict of edit columns
        self.keys = store.keys
        self.values = store.values
        self.actors = store.actors
        # apply-time clock snapshot by REFERENCE: clock_merge only
        # replaces these arrays (miss path) or, while this patch is
        # alive (the weak registration below), copies c_seq before its
        # in-place scatter — so the hot path, which drops the patch
        # before the next tick, never pays an O(clock table) copy
        self.clock_rows = (store.c_doc, store.c_actor, store.c_seq)
        sharers = getattr(store, '_c_sharers', None)
        if sharers is None:
            import weakref
            sharers = store._c_sharers = weakref.WeakSet()
        sharers.add(self)
        self._raw = None
        self._ready = True       # empty patches need no device fetch

    def block_until_ready(self):
        """Wait for the full apply: device program AND the deferred
        entry commit (so timed one-shot applies pay everything)."""
        if self._raw is not None:
            self.store._commit_pending()
            _sync(self._raw['winner_dev'])
        return self

    def _ensure(self):
        """Fetch the device outputs and build the winner-dependent patch
        columns + sequence edit columns (once)."""
        if self._ready:
            return
        self._ready = True
        import time
        _t0 = time.perf_counter()
        store = self.store
        raw = self._raw
        F = len(self.f_obj)
        # ONE device-to-host transfer for everything this read needs
        # (_fetch) — each fetch pays a full round trip and a device
        # sync. When the pending commit is THIS apply's, its survivor
        # bytes join the same trip. The fetch itself runs OUTSIDE the
        # host lock (device outputs are never mutated) so only the
        # commit and the pool-ref capture lock, briefly.
        with store._host_lock:
            pc = store._pending_commit
            own_pc = pc is not None and pc.get('patch') is self
            surv_dev = pc['surv_u8_dev'] if own_pc else None
        # edit-stream read: ONE extra device launch compacts the
        # tick's sequence edits into pre-ordered [K, e_pad] buffers
        # (e_pad bounded by the tick's row count, never the tree
        # size) — the fetch below then moves O(delta) bytes instead
        # of the full O(doc) vis planes, and the per-object host
        # argsorts disappear
        # element-field index (field rows keyed by a sequence node),
        # shared by the edit-stream dispatch and both read branches
        elem_fi = np.flatnonzero(self.f_kind)
        ef_obj = self.f_obj[elem_fi] if len(elem_fi) else \
            np.zeros(0, np.int32)
        ef_node = (self.f_key[elem_fi] & 0x7FFFFFFF) \
            .astype(np.int64) if len(elem_fi) else \
            np.zeros(0, np.int64)
        es_dev = None
        if raw['vis_planes'] is not None \
                and _edit_stream_on(store.device) and raw.get('e_pad'):
            from . import cuda_view as _cview
            dirty_a = raw['dirty']
            m_pad = raw['m_pad']
            if raw['vis_fmt'] == 'packed':
                k_pl = int(raw['vis_planes'].shape[0])
            else:
                k_pl = int(raw['vis_planes'][0].shape[0])
            tb = np.zeros((k_pl, m_pad), bool)
            if len(elem_fi) and len(dirty_a):
                ji_t = np.searchsorted(dirty_a, ef_obj)
                ji_c = np.minimum(ji_t, len(dirty_a) - 1)
                ok_t = dirty_a[ji_c] == ef_obj
                tb[ji_c[ok_t], ef_node[ok_t]] = True
            es_dev = _cview.dispatch_edit_stream(
                raw['vis_fmt'], raw['vis_planes'],
                np.packbits(tb, axis=1), raw['e_pad'])
        fetch = [raw['winner_dev']]
        if es_dev is not None:
            fetch.append(es_dev)
        elif raw['vis_planes'] is not None:
            fetch.append(raw['vis_planes'])
        if own_pc:
            fetch.append(surv_dev)
        fetched = _fetch(fetch)
        w_row = np.asarray(fetched[0])[:F]
        fetched_planes = fetched[1] if raw['vis_planes'] is not None \
            else None
        if own_pc:
            with store._host_lock:
                # re-check under the lock: an async apply may have
                # committed OUR pending while we waited on the fetch and
                # installed ITS OWN — feeding it our survivor bytes
                # would fold the wrong mask into the entry columns
                if store._pending_commit is pc:
                    store._commit_pending_locked(_surv_u8=fetched[-1])
        # else: this patch's commit already ran — the pending apply (if
        # any) is a LATER one and committing it here would block on ITS
        # device program for no benefit
        surviving = raw['surviving']
        cat, rorder = raw['cat'], raw['order']
        r_value = cat['value'][rorder]
        r_actor = cat['actor'][rorder]
        r_link = cat['link'][rorder]
        r_seg = raw['r_seg']

        has_winner = w_row >= 0
        w_safe = np.maximum(w_row, 0)
        self.f_has_winner = has_winner
        self.f_value = np.where(has_winner, r_value[w_safe], -1) \
            .astype(np.int32)
        self.f_actor = np.where(has_winner, r_actor[w_safe], -1) \
            .astype(np.int32)
        self.f_link = np.where(has_winner, r_link[w_safe], False)

        s_rows = raw['s_rows']
        ent_is_loser = s_rows != w_row[r_seg[s_rows]]
        loser_rows = s_rows[ent_is_loser]
        loser_rows = loser_rows[np.argsort(r_seg[loser_rows],
                                           kind='stable')]
        s_counts = np.bincount(r_seg[loser_rows], minlength=F) if F \
            else np.zeros(0, np.int64)
        self.s_ptr = np.zeros(F + 1, np.int32)
        np.cumsum(s_counts, out=self.s_ptr[1:])
        self.s_actor = r_actor[loser_rows]
        self.s_value = r_value[loser_rows]
        self.s_link = r_link[loser_rows]

        # sequence edit columns per dirty object. Preferred path: the
        # edit-stream kernel already compacted each class in document
        # order on device — the loop below just slices delta-sized
        # buffers (no per-object argsorts, no O(doc) node-row gather).
        # Host path (CPU stores with _EDIT_STREAM not True, and every
        # windowed apply, whose planes are the suffix window only):
        # unpack the vis planes and re-derive.
        def fis_of(nodes, lo, span):
            # node ids -> field-row ids within one object's ef span
            # (-1 = node has no field row)
            if not len(nodes):
                return np.zeros(0, np.int64)
            if not len(span):
                return np.full(len(nodes), -1, np.int64)
            p = np.minimum(np.searchsorted(span, nodes),
                           len(span) - 1)
            return np.where(span[p] == nodes,
                            elem_fi[lo + p], -1)

        planes = fetched_planes
        if planes is not None and es_dev is not None:
            pool = store.pool
            with store._host_lock:
                pool_actor, pool_elemc = pool.actor, pool.elemc
            (rm_b, insn_b, insi_b, setn_b, seti_b,
             cnts_b) = [np.asarray(x) for x in planes]
            dirty = raw['dirty']
            gained = raw['gained_max_elem']
            ps_sorted, ps_row = raw['pos_snap']
            e_cap = rm_b.shape[1]
            for ji, obj_row in enumerate(dirty.tolist()):
                nrm, nins, nset = cnts_b[ji].tolist()
                if max(nrm, nins, nset) > e_cap:
                    raise RuntimeError(
                        'edit-stream buffer overflow (e_pad '
                        f'{e_cap} < {max(nrm, nins, nset)} edits)')
                ins_nodes = insn_b[ji, :nins].astype(np.int64)
                set_nodes = setn_b[ji, :nset].astype(np.int64)
                lo, hi = np.searchsorted(ef_obj,
                                         [obj_row, obj_row + 1])
                span = ef_node[lo:hi]
                rowsq = ps_row[np.searchsorted(
                    ps_sorted, (np.int64(obj_row) << 32) | ins_nodes)]
                self.seq_edits[obj_row] = {
                    'max_elem': gained.get(obj_row),
                    # device order is prior-idx ASC; the emit wants
                    # descending — one reversed view, no sort
                    'removes': rm_b[ji, :nrm][::-1].astype(np.int64),
                    'ins_idx': insi_b[ji, :nins].astype(np.int32),
                    'ins_fis': fis_of(ins_nodes, lo, span),
                    'ins_actor': pool_actor[rowsq],
                    'ins_elemc': pool_elemc[rowsq],
                    'set_idx': seti_b[ji, :nset].astype(np.int32),
                    'set_fis': fis_of(set_nodes, lo, span),
                }
        elif planes is not None:
            # host read path (CPU store, forced-off edit stream, or a
            # windowed apply):
            # ONE plane fetch, then O(m) vectorized masks + O(delta)
            # sorts/lookups per dirty object — no more O(doc)
            # node-row gathers or full field_at tables (the pre-index
            # read rebuilt both per tick)
            pool = store.pool
            with store._host_lock:
                pool_actor, pool_elemc = pool.actor, pool.elemc
            if raw.get('vis_fmt') == 'packed':
                pv, nv, pi, ni = unpack_vis_word(
                    np.asarray(planes).view(np.uint32))
            elif raw.get('vis_fmt') == 'wide':
                pv, pi = unpack_wide_word(np.asarray(planes[0]))
                nv, ni = unpack_wide_word(np.asarray(planes[1]))
            else:
                pv, nv, pi, ni = [np.asarray(x) for x in planes]
            dirty, n_j = raw['dirty'], raw['dirty_n']
            gained = raw['gained_max_elem']
            ps_sorted, ps_row = raw['pos_snap']
            win_ws = raw.get('win_ws')
            for ji, obj_row in enumerate(dirty.tolist()):
                n = int(n_j[ji])
                # windowed apply: plane column c is node local ws + c
                # (the renumber only shipped the suffix window; the
                # indexes IN the plane words stay absolute)
                wsj = int(win_ws[ji]) if win_ws is not None else 0
                new_vis = nv[ji, :n]
                new_idx = ni[ji, :n].astype(np.int32)
                prev_idx = pi[ji, :n].astype(np.int32)
                was_vis = pv[ji, :n]
                lo, hi = np.searchsorted(ef_obj, [obj_row, obj_row + 1])
                span = ef_node[lo:hi]
                sp = span - wsj if wsj else span
                removes = np.flatnonzero(was_vis & ~new_vis)
                rm_old = -np.sort(-prev_idx[removes])
                ins_cols = np.flatnonzero(new_vis & ~was_vis)
                ins_cols = ins_cols[np.argsort(new_idx[ins_cols],
                                               kind='stable')]
                ins_nodes = ins_cols + wsj
                # sets only exist among TOUCHED nodes: intersect the
                # delta-sized touched span instead of a full mask
                tn = sp[(new_vis[sp] & was_vis[sp])] \
                    if len(sp) else sp
                set_cols = tn[np.argsort(new_idx[tn],
                                         kind='stable')]
                set_nodes = set_cols + wsj
                rowsq = ps_row[np.searchsorted(
                    ps_sorted,
                    (np.int64(obj_row) << 32) | ins_nodes)]
                self.seq_edits[obj_row] = {
                    'max_elem': gained.get(obj_row),
                    'removes': rm_old.astype(np.int64),
                    'ins_idx': new_idx[ins_cols],
                    'ins_fis': fis_of(ins_nodes, lo, span),
                    'ins_actor': pool_actor[rowsq],
                    'ins_elemc': pool_elemc[rowsq],
                    'set_idx': new_idx[set_cols],
                    'set_fis': fis_of(set_nodes, lo, span),
                }
        # patch-read closes the tick path: one device fetch + the
        # winner-dependent column build, measured as a completed span
        # (the read may run on a different thread than the apply —
        # span_event parents it under whatever span that thread holds)
        dt_ms = (time.perf_counter() - _t0) * 1e3
        metrics.observe('general_patch_read_ms', dt_ms)
        # the device-phase series fleet_status()['latency'] reports
        # alongside admit/pack/dispatch/run — same value, the phase
        # taxonomy name (general_patch_read_ms stays for back-compat)
        metrics.observe('device_patch_read_ms', dt_ms)
        if metrics.active:
            metrics.span_event('device.patch_read', dt_ms,
                               fields=F)

    def _plain_mask(self, fis):
        """Fields whose payload is a bare value (no link flag, no
        conflict entries) — the ONE definition of what the vectorized
        emit fast path may skip; `_field_payload` is its per-field
        counterpart and any new payload-shaping field flag must join
        this mask."""
        return ~(self.f_link[fis]
                 | (self.s_ptr[fis + 1] > self.s_ptr[fis]))

    def _field_payload(self, fi):
        """(value, link, conflicts) of field fi from the patch columns."""
        value = self.values[self.f_value[fi]] if self.f_value[fi] >= 0 \
            else None
        lo, hi = self.s_ptr[fi], self.s_ptr[fi + 1]
        losers = [(self.actors[self.s_actor[j]],
                   self.values[self.s_value[j]]
                   if self.s_value[j] >= 0 else None,
                   bool(self.s_link[j]))
                  for j in range(lo, hi)]
        losers.sort(key=lambda t: t[0], reverse=True)
        conflicts = None
        if losers:
            conflicts = []
            for a, v, is_link in losers:
                entry = {'actor': a, 'value': v}
                if is_link:
                    entry['link'] = True
                conflicts.append(entry)
        return value, bool(self.f_link[fi]), conflicts

    def _path(self, obj_row):
        store = self.store
        pool = store.pool
        path = []
        seen = set()
        with store._host_lock:
            return self._path_locked(store, pool, obj_row, path, seen)

    def _path_locked(self, store, pool, obj_row, path, seen):
        while store.obj_uuid[obj_row] != ROOT_ID:
            if obj_row in seen:
                return None
            seen.add(obj_row)
            inbound = store.obj_inbound.get(obj_row)
            if not inbound:
                return None
            parent_row, key = inbound[0]
            if store.is_seq(parent_row):
                pool.sync()
                node = int(key) & 0x7FFFFFFF
                idx = int(pool.vis_index[pool.row_at(parent_row, node)])
                if idx < 0:
                    return None
                path.insert(0, idx)
            else:
                path.insert(0, store.keys[int(key) & 0x7FFFFFFF])
            obj_row = parent_row
        return path

    def diffs(self, d):
        self._ensure()
        store = self.store
        out = []
        for doc, uuid, tname, max_elem in self.creates:
            if doc == d:
                diff = {'action': 'create', 'obj': uuid, 'type': tname}
                out.append(diff)
        # map-field diffs
        for fi in np.flatnonzero(self.f_doc == d):
            obj_row = int(self.f_obj[fi])
            if self.f_kind[fi]:
                continue                      # element fields: seq edits
            obj_uuid = store.obj_uuid[obj_row]
            key = store.keys[int(self.f_key[fi]) & 0x7FFFFFFF]
            path = self._path(obj_row)
            if self.f_has_winner[fi]:
                value, link, conflicts = self._field_payload(fi)
                edit = {'action': 'set', 'type': 'map', 'obj': obj_uuid,
                        'key': key, 'path': path, 'value': value}
                if link:
                    edit['link'] = True
                if conflicts:
                    edit['conflicts'] = conflicts
            else:
                edit = {'action': 'remove', 'type': 'map',
                        'obj': obj_uuid, 'key': key, 'path': path}
            out.append(edit)
        # sequence edits
        for obj_row, ed in self.seq_edits.items():
            if store.obj_doc[obj_row] != d:
                continue
            out.extend(self._seq_diffs(obj_row, ed))
        return out

    def _seq_diffs(self, obj_row, ed):
        store = self.store
        obj_uuid = store.obj_uuid[obj_row]
        tname = _TYPE_NAME[store.obj_type[obj_row]]
        path = self._path(obj_row)
        diffs = []
        if ed['max_elem'] is not None:
            diffs.append({'action': 'maxElem', 'type': tname,
                          'obj': obj_uuid, 'value': ed['max_elem'],
                          'path': path})
        for idx in ed['removes']:
            diffs.append({'action': 'remove', 'type': tname,
                          'obj': obj_uuid, 'index': int(idx),
                          'path': path})
        actors = store.actors

        def emit(fis, idxs, action, e_actor=None, e_elemc=None):
            """Edits for one pre-ordered batch: winner values fetched
            with ONE vectorized ValueTable pass; the rare
            link/conflict rows fall back to the per-field payload.
            ``e_actor``/``e_elemc`` (ins only) carry the elemId
            source columns, aligned with the batch."""
            vals = self.values.take(self.f_value[fis])
            plain = self._plain_mask(fis)
            for k, idx in enumerate(idxs.tolist()):
                if plain[k]:
                    value, link, conflicts = vals[k], False, None
                else:
                    value, link, conflicts = self._field_payload(
                        int(fis[k]))
                edit = {'action': action, 'type': tname,
                        'obj': obj_uuid, 'index': int(idx),
                        'value': value, 'path': path}
                if e_actor is not None:
                    edit['elemId'] = (f'{actors[e_actor[k]]}:'
                                      f'{int(e_elemc[k])}')
                if link:
                    edit['link'] = True
                if conflicts:
                    edit['conflicts'] = conflicts
                diffs.append(edit)

        emit(ed['ins_fis'], ed['ins_idx'], 'insert',
             ed['ins_actor'], ed['ins_elemc'])
        emit(ed['set_fis'], ed['set_idx'], 'set')
        return diffs

    def clock_of(self, d):
        c_doc, c_actor, c_seq = self.clock_rows
        lo, hi = np.searchsorted(c_doc, [d, d + 1])
        return {self.actors[c_actor[j]]: int(c_seq[j])
                for j in range(lo, hi) if c_seq[j] > 0}

    def patch(self, d):
        clock = self.clock_of(d)
        return {'clock': clock, 'deps': dict(clock), 'canUndo': False,
                'canRedo': False, 'diffs': self.diffs(d)}

    def to_patches(self):
        return [self.patch(d) for d in range(self.n_docs)]


def apply_general_block(store, block, options=None, return_timing=False):
    """`applyChanges` for general blocks: one fused device program
    resolves every touched field and re-orders every dirty sequence of
    every document in the batch. Mutates `store`; returns a
    :class:`GeneralPatch`. On a validation error the store rolls back to
    its pre-apply state (clock, log, queue, tables, trees).

    The whole host phase runs under the store's host lock, so patch
    extraction of an EARLIER apply may proceed on another thread
    (:func:`apply_general_block_async`) while this one stages."""
    with store._host_lock:
        txn = _Txn(store)
        try:
            # the fused-apply span covers admit+stage+dispatch; the
            # stage/dispatch split is emitted as completed child spans
            # from the timing points _apply_general already records
            with metrics.trace_span('device.fused_apply'):
                return _apply_general(store, block, options,
                                      return_timing, txn=txn)
        except BaseException:
            # validation errors (ValueError/TypeError) AND unexpected
            # failures (a MemoryError in the native stager, the forced
            # _NATIVE_STAGING=True RuntimeError) can fire after
            # admission/object creation mutated the store — the
            # store-intact-on-error contract holds for all of them
            txn.rollback(store)
            metrics.bump('apply_rollbacks')
            raise


class AsyncGeneralPatch:
    """Future over an applier-thread apply: resolves to the real
    :class:`GeneralPatch` (or re-raises the apply's error — the store
    itself rolled back and stays usable). Read methods proxy through
    :meth:`result`."""

    __slots__ = ('_event', '_patch', '_error')

    def __init__(self):
        self._event = threading.Event()
        self._patch = None
        self._error = None

    def result(self):
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._patch

    def block_until_ready(self):
        return self.result().block_until_ready()

    def diffs(self, d):
        return self.result().diffs(d)

    def patch(self, d):
        return self.result().patch(d)

    def to_patches(self):
        return self.result().to_patches()


def apply_general_block_async(store, block, options=None):
    """Apply on the store's applier thread: the caller overlaps patch
    EXTRACTION of earlier applies (diff materialization is the
    remaining host cost once staging went native) with the staging +
    dispatch of this block — the card never idles behind a host that is
    busy reading patches.

    Returns an :class:`AsyncGeneralPatch`. Successive async applies are
    serialized by the applier queue; a failed apply rolls the store
    back (same contract as the sync path) and surfaces its error on the
    future. Synchronous `apply_general_block` calls interleave safely
    (the host lock serializes store mutation) but their ordering
    relative to queued async applies is the queue's; drain first
    (:func:`drain_general`) when order matters. Whole-store readers
    (materialize, snapshots) should also drain first."""
    import queue
    out = AsyncGeneralPatch()
    with store._host_lock:       # two first-callers must not both init
        if getattr(store, '_applier', None) is None:
            jobs = store._jobs = queue.Queue()

            def run(jobs=jobs):
                # closes over the QUEUE, not the store: a dropped store
                # is collectable even while its idle applier lingers
                while True:
                    j = jobs.get()
                    if j is None:
                        return
                    j()

            store._applier = threading.Thread(target=run, daemon=True)
            store._applier.start()

    def job():
        try:
            out._patch = apply_general_block(store, block, options)
        except BaseException as e:     # surfaced on result()
            out._error = e
        finally:
            out._event.set()

    with store._host_lock:
        if getattr(store, '_jobs', None) is None:
            # a concurrent close_general stopped the applier between
            # our init check and this put: restart it
            return apply_general_block_async(store, block, options)
        store._jobs.put(job)
        store._last_async = out
    return out


def drain_general(store):
    """Wait for every queued async apply (queue order; waiting on the
    last suffices). Does NOT raise for failed applies — each failure
    belongs to its own future, and the store rolled back past it.
    Safe to call from several threads: everyone waits; the record
    clears only after the wait completes."""
    p = getattr(store, '_last_async', None)
    if p is not None:
        p._event.wait()
        if getattr(store, '_last_async', None) is p:
            store._last_async = None


def close_general(store):
    """Drain and stop the store's applier thread. The store remains
    fully usable synchronously; a later async apply restarts it."""
    drain_general(store)
    with store._host_lock:
        applier = getattr(store, '_applier', None)
        if applier is None:
            return
        store._jobs.put(None)
        store._applier = None
        store._jobs = None
    applier.join()


def _apply_general(store, block, options, return_timing, txn=None):
    import time
    opts = _engine.as_options(options)
    if not block.is_general():
        block = _upgrade_to_general(block)
    t0 = time.perf_counter()
    pool = store.pool
    st = _admit_and_stage(store, block)
    block = st.block
    keep, oc = st.keep, st.oc
    t1 = time.perf_counter()

    patch = GeneralPatch(store)
    if len(oc) == 0:
        _finish_empty(patch)
        return (patch, {'admit': t1 - t0}) if return_timing else patch

    # ---- admitted op columns (no copies when every row is kept —
    # the common fully-admitted block saves 5 full-column passes) ----
    o_act = st.o_action
    o_doc = st.o_doc
    if keep.all():
        o_obj_blk = block.obj
        o_kind = block.key_kind
        o_key_raw = block.key
        o_key_elem = block.key_elem
        o_elem = block.elem
    else:
        o_obj_blk = block.obj[keep]
        o_kind = block.key_kind[keep]
        o_key_raw = block.key[keep]
        o_key_elem = block.key_elem[keep]
        o_elem = block.elem[keep]

    # pre-apply per-object tree geometry: the incremental-index
    # eligibility gate compares this apply's delta against what
    # existed BEFORE any node minting (create_heads/append_batch
    # mutate n_of/max_elem_of in place). The enclosing _Txn already
    # took these exact copies for rollback — alias them (read-only
    # here) instead of copying O(n_objects) again per apply
    if txn is not None:
        nof_pre, mel_pre = txn.pool_n[0], txn.pool_n[1]
        lin_pre = txn.pool_n[6]
    else:
        nof_pre = pool.n_of.copy()
        mel_pre = pool.max_elem_of.copy()
        lin_pre = pool.idx_linear.copy()

    # ---- object creation, whole batch (make ops + missing roots) ----
    make_rows = np.flatnonzero(o_act >= _MAKE_MAP)
    if len(make_rows):
        objs_list = block.objs
        mk_uuid = [objs_list[i] for i in o_obj_blk[make_rows].tolist()]
        mk_doc = o_doc[make_rows].tolist()
        mk_type = [_MAKE_TYPE[a] for a in o_act[make_rows].tolist()]
        base = len(store.obj_uuid)
        if base + len(make_rows) > (1 << 22):
            raise ValueError('object table exceeds the 4M key space')
        new_seq_rows = []
        row = base
        for u, d, t in zip(mk_uuid, mk_doc, mk_type):
            ok = (d, u)
            if ok in store.obj_of:
                raise ValueError('Duplicate creation of object ' + u)
            store.obj_of[ok] = row
            store.obj_uuid.append(u)
            store.obj_doc.append(d)
            store.obj_type.append(t)
            if u == ROOT_ID:
                store._root_row[d] = row
            if t != _TYPE_MAP:
                new_seq_rows.append(row)
            patch.creates.append((d, u, _TYPE_NAME[t], None))
            row += 1
        pool.grow_objects(row)
        pool.create_heads(np.asarray(new_seq_rows, np.int64))

    root_ops = o_obj_blk == 0
    if root_ops.any():
        docs = np.unique(o_doc[root_ops]).astype(np.int64)
        missing = docs[store._root_row[docs] < 0]
        if len(missing):
            base = len(store.obj_uuid)
            if base + len(missing) > (1 << 22):
                raise ValueError('object table exceeds the 4M key space')
            for i, d in enumerate(missing.tolist()):
                store.obj_of[(d, ROOT_ID)] = base + i
                store.obj_uuid.append(ROOT_ID)
                store.obj_doc.append(d)
                store.obj_type.append(_TYPE_MAP)
            store._root_row[missing] = base + np.arange(len(missing))
            pool.grow_objects(len(store.obj_uuid))

    # block obj table -> store rows. Non-root uuids are globally unique,
    # so the block obj index determines the row; ROOT is per document.
    # First-use doc per table entry comes from one reversed scatter
    # (last write wins = first occurrence) instead of a million-row
    # np.unique sort.
    first_doc = np.full(len(block.objs), -1, np.int64)
    if len(o_obj_blk):
        first_doc[o_obj_blk[::-1]] = o_doc[::-1]
    omap = np.full(len(block.objs), -1, np.int64)
    get_row = store.obj_of.get
    objs_list = block.objs
    for bo in range(1, len(objs_list)):
        if first_doc[bo] < 0:
            continue                     # unreferenced table entry
        r = get_row((int(first_doc[bo]), objs_list[bo]))
        if r is None:
            raise ValueError('Modification of unknown object '
                             + objs_list[bo])
        omap[bo] = r
    obj_doc_arr, obj_type_arr = store.obj_arrays()

    # ---- op partition; make-only batches finish here ----
    ins_rows = np.flatnonzero(o_act == _INS)
    a_rows = np.flatnonzero((o_act == _SET) | (o_act == _DEL)
                            | (o_act == _LINK))
    if len(a_rows) == 0 and not len(ins_rows):
        # make-only batch: object creation still counts as a touch
        # (conservative — a created-but-unlinked object is invisible,
        # but the root creation rides the same path)
        _finish_empty(patch)
        store._bump_doc_versions(np.unique(o_doc))
        return (patch, {'admit': t1 - t0}) if return_timing else patch

    la = st.la
    # per-CHANGE local actor slots (C << n ops); the native stager and
    # the clock-exception builder both gather from this
    chg_local = la.local_of(block.doc, st.b_actor) \
        if block.n_changes else np.zeros(0, np.int32)

    # ---- op resolution: the native stager computes the ins grouping,
    # node minting, elemId resolution (peepholes + duplicate check),
    # packed field keys and the STABLE field sort in one C++ pass for
    # fully-admitted blocks; `_resolve_ops_numpy` is the byte-identical
    # fallback (no native library, queued/dropped changes at admission,
    # late-bound string elemIds) ----
    ns = None
    if _NATIVE_STAGING is not False and st.keep.all() and block.n_ops:
        from .. import native as _amnative
        use_ec = (_STAGE_CACHE is not False and _blocks._delta_host_on()
                  and pool._elem_cache)
        ns = _amnative.stage_general_block(
            block, chg_local, st.a_tab, st.k_tab, omap,
            store._root_row, obj_doc_arr, obj_type_arr, pool,
            st.b_actor,
            pool.mirror['n'] if pool.mirror is not None else 0,
            obj_uuid=store.obj_uuid,
            elem_cache=pool._elem_cache if use_ec else None)
    if _NATIVE_STAGING is True and ns is None:
        raise RuntimeError('native staging required but unavailable')
    if ns is not None:
        a_rows = ns.a_rows
        f_new = ns.o_field
        a_node = ns.a_node
        a_objr = ns.a_objrow
        dirty = ns.dirty
        ins_objs = ns.dirty[ns.new_cnt > 0]
        if ns.n_ins:
            pool.append_batch(ns.g_obj, ns.g_local, ns.g_parent,
                              ns.g_actor, ns.g_elem)
    else:
        f_new, a_node, a_objr, dirty, ins_objs = _resolve_ops_numpy(
            store, block, st, omap, root_ops, obj_doc_arr,
            obj_type_arr, o_act, o_doc, o_obj_blk, o_kind, o_key_raw,
            o_key_elem, o_elem, ins_rows, a_rows)

    # ---- deferred-commit point: everything ABOVE here is independent
    # of the entry columns, so it ran while the PREVIOUS apply's device
    # program was still in flight; now fold that apply in (the wait, if
    # any, is the PREVIOUS device program still running — metered
    # separately from this block's staging time)
    tc0 = time.perf_counter()
    store._commit_pending()
    tc1 = time.perf_counter()

    # ---- touched fields + prior entries ----
    # one stable int64 field sort serves BOTH the unique-field
    # derivation and the field-sorted row order; the native stager
    # already ran it (radix) — numpy recomputes it otherwise
    if ns is not None:
        touched_fields = ns.touched
        seg_new = ns.seg_new
        order_new = ns.order
        r_seg_new = ns.r_seg
    else:
        order_new = np.argsort(f_new, kind='stable')
        f_sorted = f_new[order_new]
        n_new0 = len(f_sorted)
        bnd_new = np.empty(n_new0, bool)
        if n_new0:
            bnd_new[0] = True
            bnd_new[1:] = f_sorted[1:] != f_sorted[:-1]
        touched_fields = f_sorted[bnd_new]
        seg_sorted_new = np.cumsum(bnd_new) - 1
        seg_new = np.empty(n_new0, np.int64)
        seg_new[order_new] = seg_sorted_new
        r_seg_new = seg_sorted_new.astype(np.int32)
    # prior-entry match. Fast path: the store's sorted field index
    # (maintained across commits) answers "which entries hold a
    # touched field" in O(touched log E); the legacy path re-packs
    # every entry's field key and scans O(E) per tick. Both produce
    # prior_rows ASCENDING and seg_prior aligned — byte-identical
    # downstream row ordering.
    srt = store._e_sorted
    if srt is not None and srt[0] is not store.e_obj:
        srt = None
        store._e_sorted = None
    srt_drop_pos = None
    if srt is not None and _blocks._delta_host_on():
        vals_s, rows_s = srt[1], srt[2]
        if len(touched_fields):
            lo_s = np.searchsorted(vals_s, touched_fields, 'left')
            cnt_s = np.searchsorted(vals_s, touched_fields,
                                    'right') - lo_s
            srt_drop_pos = _span_indices(lo_s, cnt_s)
            pru = rows_s[srt_drop_pos]
            sgu = np.repeat(np.arange(len(touched_fields),
                                      dtype=np.int64), cnt_s)
            ordp2 = np.argsort(pru, kind='stable')
            prior_rows = pru[ordp2]
            seg_prior = sgu[ordp2]
        else:
            srt_drop_pos = np.zeros(0, np.int64)
            prior_rows = np.zeros(0, np.int64)
            seg_prior = np.zeros(0, np.int64)
    else:
        # packed (obj << 32 | key) per store entry, cached per
        # entry-table identity (columns are replaced at commit)
        cache = getattr(store, '_e_field_cache', None)
        if cache is not None and cache[0] is store.e_obj:
            e_field = cache[1]
        else:
            e_field = (store.e_obj.astype(np.int64) << 32) | \
                store.e_key
            store._e_field_cache = (store.e_obj, e_field)
        if len(e_field):
            pos = np.minimum(np.searchsorted(touched_fields, e_field),
                             max(len(touched_fields) - 1, 0))
            prior_mask = (touched_fields[pos] == e_field) \
                if len(touched_fields) else \
                np.zeros(len(e_field), bool)
            prior_rows = np.flatnonzero(prior_mask)
            seg_prior = pos[prior_rows]
        else:
            prior_rows = np.zeros(0, np.int64)
            seg_prior = np.zeros(0, np.int64)
    F = len(touched_fields)
    S = opts.pad_segments(max(F, 1))

    n_new, n_prior = len(a_rows), len(prior_rows)
    n_rows = n_new + n_prior
    n_pad = opts.pad_ops(max(n_rows, 8))    # >= 8: masks ride bit-packed
    A = opts.pad_actors(max(la.width, 1))

    # canonical row order: FIELD-SORTED (segment-grouped) — the seg ids
    # then ship as one boundary BIT per row, and every r_* column below
    # (and the kernel's winner row ids) lives in these coordinates.
    # With no prior rows the field sort IS the order.
    p_doc = store.e_doc[prior_rows]
    if n_prior:
        seg_cat = np.concatenate([seg_new, seg_prior]).astype(np.int32)
        order = np.argsort(seg_cat, kind='stable')
        r_seg = seg_cat[order]
    else:
        order = order_new
        r_seg = r_seg_new
    inv_order = np.empty(n_rows, np.int64)
    inv_order[order] = np.arange(n_rows)
    prior_local = la.local_of(p_doc, store.e_actor[prior_rows]) \
        if n_prior else np.zeros(0, np.int32)

    # staged row columns: when the native stager wrote the wire buffer
    # (no prior rows, packed program) these never materialize on host —
    # build the numpy forms only for the fallback plane paths
    native_rows = ns is not None and n_prior == 0
    if native_rows:
        local_cat = seq_cat_store = isdel_cat = None
        max_seq = ns.max_seq if n_rows else 0
    else:
        local_cat = np.concatenate([chg_local[oc[a_rows]],
                                    prior_local]) \
            if n_prior else chg_local[oc[a_rows]]
        seq_cat_store = np.concatenate(
            [st.o_seq[a_rows], store.e_seq[prior_rows]]) if n_prior \
            else st.o_seq[a_rows]
        isdel_cat = np.concatenate(
            [o_act[a_rows] == _DEL, np.zeros(n_prior, bool)]) \
            if n_prior else (o_act[a_rows] == _DEL)
        max_seq = int(seq_cat_store.max()) if n_rows else 0

    # narrowest dtypes that fit (each distinct signature compiles once)
    a_dtype = np.uint8 if A <= 256 else np.int32
    s_dtype = np.int16 if max_seq < (1 << 15) else np.int32

    # clock exceptions as COO: clock[i, actor_i] = seq_i - 1 always (the
    # fold's final SET), so only cross-actor closure entries ship
    coo = []
    R = st.R
    if R.any():
        rows_clock = R[oc[a_rows]]
        nz_r, nz_c = np.nonzero(rows_clock)
        new_local = chg_local[oc[a_rows]]
        own = nz_c == new_local[nz_r]
        coo.append((inv_order[nz_r[~own]], nz_c[~own],
                    rows_clock[nz_r[~own], nz_c[~own]]))
    if n_prior:
        e_log = store.e_change[prior_rows]
        prior_counts = (store.l_dep_ptr[e_log + 1]
                        - store.l_dep_ptr[e_log])
        if prior_counts.sum():
            idx = _span_indices(store.l_dep_ptr[e_log], prior_counts)
            rows_rep = np.repeat(
                np.arange(n_new, n_rows, dtype=np.int64), prior_counts)
            doc_rep = np.repeat(p_doc, prior_counts)
            cols = la.local_of(doc_rep, store.l_dep_actor[idx])
            vals = store.l_dep_seq[idx]
            own = cols == prior_local[rows_rep - n_new]
            # the own-column closure of a PRIOR entry is its seq-1 by
            # the same invariant, so dropping own rows stays exact
            coo.append((inv_order[rows_rep[~own]], cols[~own],
                        vals[~own]))
    if coo:
        coo_row = np.concatenate([c[0] for c in coo]).astype(np.int32)
        coo_col_v = np.concatenate([c[1] for c in coo])
        coo_val_v = np.concatenate([c[2] for c in coo])
    else:
        coo_row = np.zeros(0, np.int32)
        coo_col_v = coo_val_v = np.zeros(0, np.int32)
    c_dtype = np.int16 if (len(coo_val_v) == 0
                           or int(coo_val_v.max()) < (1 << 15)) \
        else np.int32
    nnz_pad = opts.pad_ops(max(len(coo_row), 1))
    coo_col = np.zeros(nnz_pad, a_dtype)
    coo_col[:len(coo_col_v)] = coo_col_v
    coo_val = np.zeros(nnz_pad, c_dtype)
    coo_val[:len(coo_val_v)] = coo_val_v
    coo_row = np.concatenate(
        [coo_row, np.full(nnz_pad - len(coo_row), n_pad, np.int32)])

    # ---- device-resident trees: ship only this apply's NEW nodes ----
    # the job axis is BUCKETED like every other padded axis: a serving
    # fleet's dirty-set size drifts tick to tick, and an unpadded K
    # minted a fresh jit signature (a retrace) at every new count —
    # the job table pads with job_n = 0 rows, which every plane op
    # masks out
    K = opts._pad(None, max(len(dirty), 1), 'job_pad')
    if ns is not None:
        n_j = ns.n_j
    else:
        n_j = pool.n_of[dirty] if len(dirty) else np.zeros(0, np.int64)
    m_pad = opts.pad_nodes(int(max(n_j.max() if len(n_j) else 1, 8)))
    n_total = pool.n_nodes
    n_act = len(store.actors)

    # variant pick: the 2-word packed program wherever its bit-field
    # guards hold, the 3-word WIDE packed program for everything up to
    # 2^22-node trees / int32 elemc+seq, and `_fused_general_resident`
    # (cols) as the last fallback (>4M-node trees, wide actor sets).
    # All three share the staging idioms (_insert_counts/_build_clock/
    # _vis_grid and the scan resolve) — the cross-check for those is
    # the host oracle and the sharded-step equality gates, while the
    # cols fallback remains the independent check of the packed mirror
    # FORMATS (bit fields, wire layout, dtype narrowing). A mirror
    # already on 'wide' stays there even when the 2-word guards pass
    # again (a seq-width oscillation must not convert per block); the
    # tree/elemc bounds are monotone, so packed-eligibility never
    # genuinely returns once crossed.
    mir = pool.mirror
    cur_fmt = mir.get('fmt', 'cols') if mir is not None else None
    if (_packed_mirror_guard(pool, n_act, A)
            and s_dtype is np.int16 and c_dtype is np.int16
            and cur_fmt != 'wide'):
        fmt = 'packed'
    elif _wide_mirror_guard(pool, n_act, A):
        fmt = 'wide'
    else:
        fmt = 'cols'
    if mir is not None and cur_fmt != fmt:
        mir = pool.mirror = _mirror_convert(mir, fmt, store, opts)
        if fmt == 'cols' and pool.idx_ok.any():
            # converting down to cols drops the 'tp' plane
            pool.idx_ok[:] = False
            metrics.bump('device_idx_invalidations')
    use_packed = fmt == 'packed'
    incr = None                  # set by the packed/wide dispatches

    if mir is None:
        # first resident apply: EVERY node is this apply's delta — the
        # mirror materializes on device with zero extra wire bytes
        cap = opts.pad_nodes(max(n_total, 8))
        n_old = 0
    elif mir['cap'] < n_total:
        # capacity growth ON DEVICE (2x headroom so block-sized growth
        # amortizes): pad each resident column; nothing ships
        cap = opts.pad_nodes(max(2 * mir['cap'], n_total))
        n_old = mir['n']
    else:
        cap = mir['cap']
        n_old = mir['n']

    d_n = n_total - n_old
    d_pad = opts.pad_nodes(max(d_n, 8))
    native_wire = native_rows and fmt != 'cols'

    if not native_wire:
        # host-built planes: d columns + job table + row slots + the
        # staged row arrays (the native stager still provides the d
        # planes and job table when it ran — exact for any admission)
        if ns is not None:
            d_parent = np.zeros(d_pad, np.int32)
            d_elemc = np.zeros(d_pad, np.int32)
            d_actor = np.zeros(d_pad, np.int32)
            d_pos = np.full(d_pad, cap, np.int32)
            job_start = np.zeros(K, np.int32)
            n_j_arr = np.zeros(K, np.int32)
            ns.fill_dplanes(d_parent, d_elemc, d_actor, d_pos,
                            job_start, n_j_arr)
        else:
            new_glob = np.arange(n_old, n_total, dtype=np.int64)
            keys = (pool.obj[new_glob].astype(np.int64) << 32) | \
                pool.local[new_glob]
            final_pos = np.searchsorted(pool.pos_sorted, keys)
            if d_n > 1 and not (final_pos[1:] >= final_pos[:-1]).all():
                ordp = np.argsort(final_pos, kind='stable')
                final_pos = final_pos[ordp]
            else:
                ordp = None     # appends landed in pos order (common)

            def dcol(col):
                out = np.zeros(d_pad, np.int32)
                new = col[new_glob]
                out[:d_n] = new if ordp is None else new[ordp]
                return out

            d_parent = dcol(pool.parent)
            d_elemc = dcol(pool.elemc)
            d_actor = dcol(pool.actor)
            d_pos = np.full(d_pad, cap, np.int32)
            d_pos[:d_n] = final_pos - np.arange(d_n)

            # job table: each dirty object's contiguous pos slice
            # (bucket-padded rows keep job_n = 0 and mask out)
            job_start = np.zeros(K, np.int32)
            n_j_arr = np.zeros(K, np.int32)
            if len(dirty):
                job_start[:len(dirty)] = np.searchsorted(
                    pool.pos_sorted, dirty << np.int64(32))
                n_j_arr[:len(dirty)] = n_j

        # per-row (job, node) slots, in the field-sorted coordinates
        row_slot = np.full(n_pad, -1, np.int32)
        if len(dirty):
            slot_cat = np.full(n_rows, -1, np.int64)
            dirty_lookup = np.full(len(store.obj_uuid), -1, np.int64)
            dirty_lookup[dirty] = np.arange(len(dirty))
            if n_new:
                loc = dirty_lookup[a_objr]
                nd = a_node
                slot_cat[:n_new] = np.where((loc >= 0) & (nd >= 0),
                                            loc * m_pad + nd, -1)
            if n_prior:
                p_loc = dirty_lookup[store.e_obj[prior_rows]]
                p_elem_key = store.e_key[prior_rows]
                p_node = np.where(p_elem_key & _ELEM_BIT,
                                  p_elem_key & 0x7FFFFFFF, -1)
                slot_cat[n_new:n_rows] = np.where(
                    (p_loc >= 0) & (p_node >= 0),
                    p_loc * m_pad + p_node, -1)
            row_slot[:n_rows] = slot_cat[order]

        if local_cat is None:    # native rows but the cols program
            local_cat = chg_local[oc[a_rows]]
            seq_cat_store = st.o_seq[a_rows]
            isdel_cat = o_act[a_rows] == _DEL
        actor_arr = np.zeros(n_pad, a_dtype)
        actor_arr[:n_rows] = local_cat[order]
        seq_arr = np.zeros(n_pad, s_dtype)
        seq_arr[:n_rows] = seq_cat_store[order]
        boundary = np.zeros(n_pad, bool)
        if n_rows:
            boundary[0] = True
            boundary[1:n_rows] = r_seg[1:] != r_seg[:-1]
        del_arr = np.zeros(n_pad, bool)
        del_arr[:n_rows] = isdel_cat[order]
        flags_u8 = np.concatenate([np.packbits(boundary),
                                   np.packbits(del_arr)])
    t2 = time.perf_counter()

    # suffix-window state: set by the incr dispatch branches when the
    # renumber was bounded to per-job suffix windows (m_eff < m_pad)
    m_eff = m_pad
    win_ws = None
    win_nj = None

    dev = store.device
    if use_packed:
        ranks = np.asarray(store.actor_str_ranks())
        if mir is None:
            w1m = torch.zeros(cap, dtype=_I32, device=dev)
            w2m = torch.zeros(cap, dtype=_I32, device=dev)
            remap_dev, has_remap = None, False
        else:
            if mir['cap'] < n_total:
                pad = torch.zeros(cap - mir['cap'], dtype=_I32, device=dev)
                w1m = torch.cat([mir['w1'], pad])
                w2m = torch.cat([mir['w2'], pad])
            else:
                w1m, w2m = mir['w1'], mir['w2']
            old_ranks = mir['ranks']
            if np.array_equal(old_ranks, ranks[:len(old_ranks)]):
                remap_dev, has_remap = None, False
            else:
                # existing actors shifted rank (new actors landed in
                # the sorted order): remap the mirror's rank field
                rm = np.zeros(opts.pad_actors(len(old_ranks) + 2),
                              np.int32)
                rm[old_ranks + 1] = \
                    ranks[:len(old_ranks)].astype(np.int32) + 1
                remap_dev, has_remap = _dev(rm, dev), True

        sizes = (d_pad, n_pad, K, nnz_pad)
        wire = np.empty(_wire_sizes(*sizes), np.uint8)
        i32_n = 2 * d_pad + n_pad + nnz_pad + 2 * K
        i16_n = d_pad + n_pad + nnz_pad
        if native_wire:
            # C++ writes every section except the three admission-clock
            # COO sections, which only the admission layer knows
            ns.fill_wire(wire, cap, d_pad, n_pad, K, nnz_pad, m_pad,
                         ranks)
            o = 4 * (2 * d_pad + n_pad)
            wire[o:o + 4 * nnz_pad].view(np.int32)[:] = coo_row
            o = 4 * i32_n + 2 * (d_pad + n_pad)
            wire[o:o + 2 * nnz_pad].view(np.int16)[:] = coo_val
            o = 4 * i32_n + 2 * i16_n + n_pad + 2 * (n_pad >> 3)
            wire[o:o + nnz_pad] = coo_col.view(np.uint8)
        else:
            rank1_new = np.where(
                d_actor >= 0, ranks[np.maximum(d_actor, 0)] + 1, 0) \
                .astype(np.int32)
            w1_new = (d_parent << 16) | rank1_new
            o = 0
            for arr, width in ((w1_new, 4), (d_pos, 4), (row_slot, 4),
                               (coo_row, 4), (job_start, 4),
                               (n_j_arr, 4)):
                nb_ = width * len(arr)
                wire[o:o + nb_].view(np.int32)[:] = arr
                o += nb_
            for arr in (d_elemc, seq_arr, coo_val):
                nb_ = 2 * len(arr)
                wire[o:o + nb_].view(np.int16)[:] = arr
                o += nb_
            for arr in (actor_arr, flags_u8, coo_col):
                wire[o:o + len(arr)] = arr.view(np.uint8)
                o += len(arr)
            assert o == len(wire)

        tpm = _mirror_tp_in(mir, cap, n_total, dev)
        incr = _pick_incremental(
            pool, mir, dirty, n_j, nof_pre, mel_pre, n_old, n_total,
            m_pad, opts,
            parent_d=(wire[:4 * d_pad].view(np.int32) >> 16)
            if native_wire else d_parent,
            elemc_d=wire[4 * i32_n:4 * i32_n + 2 * d_pad]
            .view(np.int16) if native_wire else d_elemc)
        n_remap = int(remap_dev.shape[0]) if has_remap else 1
        if incr is not None:
            dm_pad, jd_base, min_rp = incr
            ob = 4 * 2 * d_pad
            rs_v = wire[ob:ob + 4 * n_pad].view(np.int32)
            ob = 4 * (2 * d_pad + n_pad + nnz_pad)
            js_v = wire[ob:ob + 4 * K].view(np.int32)
            jn_v = wire[ob + 4 * K:ob + 8 * K].view(np.int32)
            win, ws_k = _pick_window(lin_pre, dirty, n_j, jd_base, min_rp,
                                     rs_v, js_v, jn_v, m_pad, n_rows, K,
                                     opts)
            if win is not None:
                m_eff, ws_k, jd_base, win_nj = win
                win_ws = ws_k[:len(dirty)].copy()
                if not native_wire:
                    # the rewrite went through the wire views; keep the
                    # numpy staging arrays (capture parity) in step
                    row_slot[:] = rs_v
                    job_start[:] = js_v
                    n_j_arr[:] = jn_v
            jd = np.zeros(K, np.int32)
            jd[:len(dirty)] = jd_base
            _profiler.note_dispatch(
                'general.fused_incr',
                ('packed', cap, sizes, S, A, m_eff, dm_pad, has_remap,
                 n_remap),
                rows=n_pad)
            # the staged wire (rewritten for the window above) crosses
            # as ONE host-to-device copy
            outs = _fused_general_incr(
                w1m, w2m, None, tpm, _dev(wire, dev), _dev(jd, dev),
                _dev(ws_k, dev), n_old, n_rows, remap_dev,
                fmt='packed', sizes=sizes, num_segments=S, a_pad=A,
                m_pad=m_eff, dm_pad=dm_pad, has_remap=has_remap)
            w1o, w2o, tpo = outs[0], outs[1], outs[3]
            surv_u8_dev, winner_dev = outs[4], outs[5]
            vis_planes = outs[6] if len(dirty) else None
        else:
            # shape-signature registry: every distinct signature is one
            # shape bucket of the packed program (device/profiler.py)
            _profiler.note_dispatch(
                'general.fused_packed',
                (cap, sizes, S, A, m_pad, has_remap, n_remap, n_old > 0),
                rows=n_pad)
            # the whole staged wire crosses as ONE host-to-device copy
            outs = _fused_general_packed(
                w1m, w2m, tpm, _dev(wire, dev), n_old, n_rows, remap_dev,
                sizes=sizes, num_segments=S, a_pad=A, m_pad=m_pad,
                has_remap=has_remap, has_old=n_old > 0)
            w1o, w2o, tpo = outs[0], outs[1], outs[2]
            surv_u8_dev, winner_dev = outs[3], outs[4]
            vis_planes = outs[5] if len(dirty) else None
            if len(dirty):
                # the rebuild just (re)wrote these objects' index
                pool.idx_ok[dirty] = True
        pool.mirror = {
            'fmt': 'packed', 'cap': cap, 'n': n_total,
            'w1': w1o, 'w2': w2o, 'tp': tpo, 'ranks': ranks.copy(),
            'pos_row': pool.pos_row,  # replaced-on-append: stable ref
        }
        vis_fmt = 'packed'
    elif fmt == 'wide':
        if mir is None:
            w1m, w2m, w3m = (torch.zeros(cap, dtype=_I32, device=dev)
                             for _ in range(3))
        elif mir['cap'] < n_total:
            pad = torch.zeros(cap - mir['cap'], dtype=_I32, device=dev)
            w1m, w2m, w3m = (torch.cat([mir[k], pad])
                             for k in ('w1', 'w2', 'w3'))
        else:
            w1m, w2m, w3m = mir['w1'], mir['w2'], mir['w3']
        # actor -> string-rank table, re-shipped only when it grew (the
        # wide words carry stable actor ids, never ranks)
        if mir is None or mir.get('rank_n') != n_act:
            rank_table_dev = _rank_table(store, opts)
        else:
            rank_table_dev = mir['rank_table']

        sizes = (d_pad, n_pad, K, nnz_pad)
        wire = np.empty(_wire_sizes_wide(*sizes), np.uint8)
        i32_n = 3 * d_pad + 2 * n_pad + 2 * nnz_pad + 2 * K
        if native_wire:
            # C++ writes every section except the three admission-clock
            # COO sections, which only the admission layer knows
            ns.fill_wire_wide(wire, cap, d_pad, n_pad, K, nnz_pad,
                              m_pad)
            o = 4 * (3 * d_pad + 2 * n_pad)
            wire[o:o + 4 * nnz_pad].view(np.int32)[:] = coo_row
            o += 4 * nnz_pad
            wire[o:o + 4 * nnz_pad].view(np.int32)[:] = coo_val
            o = 4 * i32_n + d_pad + n_pad + 2 * (n_pad >> 3)
            wire[o:o + nnz_pad] = coo_col.view(np.uint8)
        else:
            actor1_new = d_actor + 1          # head (-1) -> 0
            w1_new = (d_parent << _WIDE_PARENT_SHIFT) | \
                (actor1_new & _WIDE_ALO_MASK)
            seq32 = seq_arr.astype(np.int32)
            coo_val32 = coo_val.astype(np.int32)
            o = 0
            for arr in (w1_new, d_elemc, d_pos, row_slot, seq32,
                        coo_row, coo_val32, job_start, n_j_arr):
                nb_ = 4 * len(arr)
                wire[o:o + nb_].view(np.int32)[:] = arr
                o += nb_
            for arr in ((actor1_new >> 10).astype(np.uint8), actor_arr,
                        flags_u8, coo_col):
                wire[o:o + len(arr)] = arr.view(np.uint8)
                o += len(arr)
            assert o == len(wire)

        tpm = _mirror_tp_in(mir, cap, n_total, dev)
        incr = _pick_incremental(
            pool, mir, dirty, n_j, nof_pre, mel_pre, n_old, n_total,
            m_pad, opts,
            parent_d=((wire[:4 * d_pad].view(np.int32)
                       >> _WIDE_PARENT_SHIFT) & _WIDE_IDX_MASK)
            if native_wire else d_parent,
            elemc_d=wire[4 * d_pad:8 * d_pad].view(np.int32)
            if native_wire else d_elemc)
        if incr is not None:
            dm_pad, jd_base, min_rp = incr
            ob = 4 * 3 * d_pad
            rs_v = wire[ob:ob + 4 * n_pad].view(np.int32)
            ob = 4 * (3 * d_pad + 2 * n_pad + 2 * nnz_pad)
            js_v = wire[ob:ob + 4 * K].view(np.int32)
            jn_v = wire[ob + 4 * K:ob + 8 * K].view(np.int32)
            win, ws_k = _pick_window(lin_pre, dirty, n_j, jd_base, min_rp,
                                     rs_v, js_v, jn_v, m_pad, n_rows, K,
                                     opts)
            if win is not None:
                m_eff, ws_k, jd_base, win_nj = win
                win_ws = ws_k[:len(dirty)].copy()
                if not native_wire:
                    row_slot[:] = rs_v
                    job_start[:] = js_v
                    n_j_arr[:] = jn_v
            jd = np.zeros(K, np.int32)
            jd[:len(dirty)] = jd_base
            _profiler.note_dispatch(
                'general.fused_incr',
                ('wide', cap, sizes, S, A, m_eff, dm_pad,
                 int(rank_table_dev.shape[0])),
                rows=n_pad)
            outs = _fused_general_incr(
                w1m, w2m, w3m, tpm, _dev(wire, dev), _dev(jd, dev),
                _dev(ws_k, dev), n_old, n_rows, rank_table_dev,
                fmt='wide', sizes=sizes, num_segments=S, a_pad=A,
                m_pad=m_eff, dm_pad=dm_pad, has_remap=False)
        else:
            _profiler.note_dispatch(
                'general.fused_wide',
                (cap, sizes, S, A, m_pad, int(rank_table_dev.shape[0]),
                 n_old > 0),
                rows=n_pad)
            outs = _fused_general_wide(
                w1m, w2m, w3m, tpm, _dev(wire, dev), n_old, n_rows,
                rank_table_dev, sizes=sizes, num_segments=S, a_pad=A,
                m_pad=m_pad, has_old=n_old > 0)
            if len(dirty):
                pool.idx_ok[dirty] = True
        w1o, w2o, w3o, tpo = outs[0], outs[1], outs[2], outs[3]
        surv_u8_dev, winner_dev = outs[4], outs[5]
        vis_planes = (outs[6], outs[7]) if len(dirty) else None
        pool.mirror = {
            'fmt': 'wide', 'cap': cap, 'n': n_total,
            'w1': w1o, 'w2': w2o, 'w3': w3o, 'tp': tpo,
            'rank_n': n_act, 'rank_table': rank_table_dev,
            'pos_row': pool.pos_row,  # replaced-on-append: stable ref
        }
        vis_fmt = 'wide'
    else:
        if mir is None:
            m_cols = (torch.zeros(cap, dtype=_I32, device=dev),
                      torch.zeros(cap, dtype=_I32, device=dev),
                      torch.full((cap,), -1, dtype=_I32, device=dev),
                      torch.zeros(cap, dtype=torch.bool, device=dev),
                      torch.full((cap,), -1, dtype=_I32, device=dev))
        elif mir['cap'] < n_total:
            def grow(col, fill):
                return torch.cat([col, torch.full(
                    (cap - mir['cap'],), fill, dtype=col.dtype,
                    device=dev)])

            m_cols = (grow(mir['parent'], 0), grow(mir['elemc'], 0),
                      grow(mir['actor'], -1),
                      grow(mir['visible'], False),
                      grow(mir['vis_index'], -1))
        else:
            m_cols = (mir['parent'], mir['elemc'], mir['actor'],
                      mir['visible'], mir['vis_index'])

        # actor -> string-rank table, re-shipped only when it grew
        if mir is None or mir.get('rank_n') != n_act:
            rank_table_dev = _rank_table(store, opts)
        else:
            rank_table_dev = mir['rank_table']

        _profiler.note_dispatch(
            'general.fused_cols',
            (cap, d_pad, n_pad, K, nnz_pad, S, A, m_pad,
             int(rank_table_dev.shape[0]), seq_arr.dtype.str,
             actor_arr.dtype.str, coo_val.dtype.str),
            rows=n_pad)
        outs = _fused_general_resident(
            *m_cols, _dev(d_parent, dev), _dev(d_elemc, dev),
            _dev(d_actor, dev), _dev(d_pos, dev), n_old,
            _dev(job_start, dev), _dev(n_j_arr, dev),
            rank_table_dev,
            _dev(actor_arr, dev), _dev(seq_arr, dev),
            _dev(row_slot, dev), _dev(flags_u8, dev),
            n_rows, _dev(coo_row, dev),
            _dev(coo_col, dev), _dev(coo_val, dev),
            num_segments=S, a_pad=A, m_pad=m_pad)
        pool.mirror = {
            'fmt': 'cols', 'cap': cap, 'n': n_total,
            'parent': outs[0], 'elemc': outs[1], 'actor': outs[2],
            'visible': outs[3], 'vis_index': outs[4],
            'rank_n': n_act, 'rank_table': rank_table_dev,
            'pos_row': pool.pos_row,  # replaced-on-append: stable ref
        }
        # the cols fallback maintains no 'tp' plane; any index claims
        # drop with it (a cols-scale store always rebuilds)
        if pool.idx_ok.any():
            pool.idx_ok[:] = False
            metrics.bump('device_idx_invalidations')
        if len(dirty):
            metrics.bump('device_idx_rebuild_applies')
        surv_u8_dev, winner_dev = outs[5], outs[6]
        vis_planes = tuple(outs[7:11]) if len(dirty) else None
        vis_fmt = 'cols'
    pool._epoch += 1
    _update_mirror_gauges(fmt, cap)
    if _STAGE_CAPTURE is not None:
        if native_wire and use_packed:
            # the staged planes live in the wire buffer — expose them
            # through views at the layout offsets
            o_rs = 4 * (2 * d_pad)
            cap_slot = wire[o_rs:o_rs + 4 * n_pad].view(np.int32)
            o_sq = 4 * i32_n + 2 * d_pad
            cap_seq = wire[o_sq:o_sq + 2 * n_pad].view(np.int16)
            o_ac = 4 * i32_n + 2 * i16_n
            cap_actor = wire[o_ac:o_ac + n_pad]
            cap_flags = wire[o_ac + n_pad:
                             o_ac + n_pad + 2 * (n_pad >> 3)]
        elif native_wire:                      # wide wire layout
            o_rs = 4 * (3 * d_pad)
            cap_slot = wire[o_rs:o_rs + 4 * n_pad].view(np.int32)
            cap_seq = wire[o_rs + 4 * n_pad:
                           o_rs + 8 * n_pad].view(np.int32)
            o_ac = 4 * i32_n + d_pad
            cap_actor = wire[o_ac:o_ac + n_pad]
            cap_flags = wire[o_ac + n_pad:
                             o_ac + n_pad + 2 * (n_pad >> 3)]
        else:
            cap_slot = row_slot
            # the wide wire carries seq as int32 — expose the same
            # dtype so the native/numpy parity gate compares like
            cap_seq = seq_arr.astype(np.int32) if fmt == 'wide' \
                else seq_arr
            cap_actor, cap_flags = actor_arr, flags_u8
        _STAGE_CAPTURE({
            'ops_actor': cap_actor, 'ops_seq': cap_seq,
            'ops_slot': cap_slot, 'flags_u8': cap_flags,
            'n_rows': n_rows, 'coo_row': coo_row, 'coo_col': coo_col,
            'coo_val': coo_val, 'num_segments': S, 'a_pad': A,
            'm_pad': m_eff, 'surv_u8': surv_u8_dev,
            'winner': winner_dev, 'vis_fmt': vis_fmt,
            'vis_planes': vis_planes, 'variant': fmt})
    t3 = time.perf_counter()

    # sampled per-phase device-time attribution: every Nth apply
    # fences on the fused program and splits its wall time into the
    # admit/pack/dispatch/device histogram series — one pipeline
    # bubble per sample, amortized by the cadence; off-sample applies
    # paid exactly the integer check above the fence
    if _profiler.should_sample():
        _sync(winner_dev)
        t_dev = (time.perf_counter() - t3) * 1e3
        _profiler.record_phases(
            (t1 - t0) * 1e3, (t2 - t1 - (tc1 - tc0)) * 1e3,
            (t3 - t2) * 1e3, t_dev,
            (time.perf_counter() - t0) * 1e3,
            # the index update is FUSED into the apply program, so its
            # attribution is the fenced run time of the incremental
            # variant (its own series; rebuild-path run time stays out)
            idx_ms=t_dev if incr is not None else None)

    # ---- unpack: lazy patch wiring + DEFERRED entry commit ----
    # `cat` holds the UNPERMUTED row columns plus `order` (the
    # field-sorted permutation matching the kernel's winner row ids);
    # consumers gather lazily — commit fetches only the survivor rows,
    # conflict columns materialize on first diff read. Nothing blocks
    # here: the 33KB survivor fetch and the entry update wait in
    # _pending_commit until the next entry reader (usually the next
    # apply's prior-entry match), so host staging of block n+1 overlaps
    # this block's device program.
    # columns build LAZILY on first access (8 half-million-row gathers
    # + concatenates off the dispatch path — the commit or a diff read
    # pays them, overlapping the device program). The e_* refs snapshot
    # NOW: the store's entry columns are replaced (never mutated) at
    # commit, so the captured arrays stay the pre-commit state.
    e_snap = (store.e_value, store.e_link, store.e_actor,
              store.e_change, store.e_obj, store.e_key)

    def seq_thunk():
        if seq_cat_store is not None:
            return seq_cat_store, None
        return st.o_seq[a_rows], None

    cat = _LazyCat({
        'value': lambda: (st.o_value[a_rows], e_snap[0][prior_rows]),
        'link': lambda: (o_act[a_rows] == _LINK,
                         e_snap[1][prior_rows]),
        'actor': lambda: (st.o_actor[a_rows], e_snap[2][prior_rows]),
        'doc': lambda: (o_doc[a_rows], p_doc),
        'seq': seq_thunk,
        'change': lambda: (st.cmap[oc[a_rows]].astype(np.int32),
                           e_snap[3][prior_rows]),
        'obj': lambda: (a_objr.astype(np.int32),
                        e_snap[4][prior_rows]),
        'key': lambda: (f_new & 0xFFFFFFFF,
                        e_snap[5][prior_rows]),
    }, n_prior)

    f_obj = (touched_fields >> 32).astype(np.int32)
    patch.f_obj = f_obj
    patch.f_doc = obj_doc_arr[f_obj] if len(obj_doc_arr) \
        else np.zeros(0, np.int32)
    patch.f_key = touched_fields & 0xFFFFFFFF
    patch.f_kind = (patch.f_key & _ELEM_BIT) != 0

    # ---- lazy wiring: winner columns, conflicts, sequence edits ----
    pos_snap = (pool.pos_sorted, pool.pos_row)

    def rows_flat_thunk(d=dirty, nj=n_j, ps=pos_snap):
        # the flat node-row gather of every dirty object is paid by the
        # first patch READ, not the apply dispatch; the pos snapshot
        # pins this apply's tree extent (later applies append more)
        if not len(d):
            return np.zeros(0, np.int64)
        lo = np.searchsorted(ps[0], d << np.int64(32))
        return ps[1][_span_indices(lo, nj)]

    patch._raw = {
        'winner_dev': winner_dev, 'surviving': None,   # set at commit
        'cat': cat, 'order': order, 'vis_fmt': vis_fmt,
        'r_seg': r_seg, 's_rows': None, 'vis_planes': vis_planes,
        'dirty': dirty, 'rows_flat': rows_flat_thunk,
        # windowed applies hand the patch read the suffix planes: the
        # per-job window base maps plane column c to absolute node
        # local win_ws[j] + c, and dirty_n shrinks to the window
        # sizes. e_pad = 0 pins the read to the host-unpack branch
        # (the edit stream ranks by dense indexes over whole planes).
        'dirty_n': n_j if win_ws is None else win_nj,
        'win_ws': win_ws,
        # edit-stream read geometry: the patch-read kernel compacts
        # this tick's edits into [K, e_pad] buffers (edits are bounded
        # by the resolved row count, never the tree size)
        'm_pad': m_eff, 'e_pad': 0 if win_ws is not None else opts._pad(
            None, max(min(m_pad, n_rows), 1), 'edit_pad'),
        'pos_snap': pos_snap,
        # per-object maxElem SNAPSHOT at apply time: a pipelined reader
        # may materialize this patch after apply N+1 has grown the pool,
        # and the reference reports the per-apply maxElem
        # (reference backend/op_set.js:118-125)
        'gained_max_elem': {int(o): int(pool.max_elem_of[o])
                            for o in ins_objs.tolist()},
    }
    patch._ready = False
    store._pending_commit = {
        'surv_u8_dev': surv_u8_dev, 'n_rows': n_rows,
        'prior_rows': prior_rows, 'n_entries': len(store.e_key),
        'srt_drop_pos': srt_drop_pos,
        'touched_fields': touched_fields,
        'r_seg': r_seg, 'cat': cat, 'order': order, 'patch': patch,
    }
    t4 = time.perf_counter()

    # dirty-doc signal for view caches: every raise point is behind us
    # (the dispatch succeeded, the pending commit is installed), so the
    # bump cannot leak through a rollback
    store._bump_doc_versions(np.unique(o_doc))

    # staging-cache upkeep: each dirty sequence object keeps a sorted
    # elemId -> local index the NEXT tick's stagers (numpy and native)
    # consult in O(delta). Population sits AFTER every raise point, so
    # a rolled-back apply never caches unminted nodes; append_batch
    # already extended resident entries with this tick's nodes.
    if _STAGE_CACHE is not False and _blocks._delta_host_on():
        ec = pool._elem_cache
        for o in dirty.tolist():
            if int(o) in ec:
                metrics.bump('device_stage_cache_hits')
            else:
                metrics.bump('device_stage_cache_misses')
                pool.elem_index(int(o))

    metrics.bump('general_batches')
    metrics.bump('general_ops', int(keep.sum()))
    metrics.bump('general_stage_native_batches' if ns is not None
                 else 'general_stage_numpy_batches')
    # per-variant apply counts: a fleet quietly living on the cols
    # fallback (or stuck converting) shows up in the bench summary
    metrics.bump(f'general_variant_{fmt}_applies')
    metrics.observe('general_stage_ms',
                    (t2 - t1 - (tc1 - tc0)) * 1e3)
    metrics.observe('general_commit_wait_ms', (tc1 - tc0) * 1e3)
    if metrics.active:
        # tick-path taxonomy: admit → stage → dispatch, as completed
        # child spans of device.fused_apply (explicit durations — the
        # phases are measured in-line above)
        metrics.span_event('device.admit', (t1 - t0) * 1e3)
        metrics.span_event('device.stage',
                           (t2 - t1 - (tc1 - tc0)) * 1e3,
                           native=ns is not None)
        metrics.span_event('device.dispatch', (t3 - t2) * 1e3)
        if incr is not None:
            # the incremental index update gets its own trace lane: the
            # dispatch wall of the merge-pass program, with the delta
            # size attached
            metrics.span_event('device.idx_update', (t3 - t2) * 1e3,
                               delta=int(n_total - n_old),
                               jobs=len(dirty))
    if return_timing:
        return patch, {'admit': t1 - t0, 'pack': t2 - t1,
                       'commit_wait': tc1 - tc0,
                       'device': t3 - t2, 'unpack': t4 - t3}
    return patch


def _resolve_ops_numpy(store, block, st, omap, root_ops, obj_doc_arr,
                       obj_type_arr, o_act, o_doc, o_obj_blk, o_kind,
                       o_key_raw, o_key_elem, o_elem, ins_rows, a_rows):
    """The numpy op-resolution path of `_apply_general`: per-op store
    object rows, ins grouping + local node minting, elemId resolution
    with the duplicate check, packed field keys. Mutates the pool
    (append_batch). The native stager (`native.stage_general_block`)
    computes exactly these outputs in C++; this remains the fallback
    for partially-admitted blocks and late-bound string elemIds, and
    the parity oracle for the native path.

    Returns (f_new, a_node, a_objr, dirty, ins_objs): per-assignment-
    row packed field keys / target nodes / object rows, plus the dirty
    sequence objects and the objects that gained nodes."""
    pool = store.pool
    o_objrow = np.where(root_ops, store._root_row[o_doc],
                        omap[o_obj_blk])
    # cross-document object reuse is malformed input, not a crash
    if not (obj_doc_arr[o_objrow] == o_doc).all():
        bad = int(np.flatnonzero(obj_doc_arr[o_objrow] != o_doc)[0])
        raise ValueError('Modification of unknown object '
                         + block.objs[int(o_obj_blk[bad])])
    o_node = np.full(len(o_act), -1, np.int64)   # local node of each op
    ins_objs = np.zeros(0, np.int64)

    # ---- ins prep: group by object, mint local node ids ----
    g_rows = g_obj = g_actor = g_elem = local_new = None
    if len(ins_rows):
        i_obj = o_objrow[ins_rows]
        bad_t = obj_type_arr[i_obj] == _TYPE_MAP
        if bad_t.any():
            bad_row = int(i_obj[np.flatnonzero(bad_t)[0]])
            raise ValueError('Insertion into non-sequence object '
                             + store.obj_uuid[bad_row])
        if len(i_obj) > 1 and (i_obj[1:] >= i_obj[:-1]).all():
            # block emitted docs/objects in order (the common case):
            # the stable object grouping is the identity
            g_rows = ins_rows
            g_obj = i_obj
            g_actor = st.o_actor[ins_rows]
            g_elem = o_elem[ins_rows].astype(np.int64)
        else:
            iord = np.argsort(i_obj, kind='stable')
            g_rows = ins_rows[iord]
            g_obj = i_obj[iord]
            g_actor = st.o_actor[ins_rows][iord]
            g_elem = o_elem[ins_rows][iord].astype(np.int64)
        run_start = np.concatenate([[True], g_obj[1:] != g_obj[:-1]])
        starts = np.flatnonzero(run_start)
        ins_objs = g_obj[starts]
        counts = np.append(starts[1:], len(g_obj)) - starts
        n_old = pool.n_of[ins_objs]
        within = np.arange(len(g_obj)) - np.repeat(starts, counts)
        local_new = np.repeat(n_old, counts) + within
        new_key = (g_actor.astype(np.int64) << 32) | g_elem

        # parent keys (head = -1 sentinel -> node 0, no lookup)
        kinds = o_kind[g_rows]
        p_key = np.full(len(g_rows), -1, np.int64)
        ek = kinds == _KEY_ELEM
        if ek.any():
            p_actor = st.a_tab[o_key_raw[g_rows[ek]]]
            p_key[ek] = (p_actor.astype(np.int64) << 32) | \
                o_key_elem[g_rows[ek]].astype(np.int64)
        sk = kinds == _KEY_STR           # late-bound parent elemIds
        for i in np.flatnonzero(sk).tolist():
            s_key = block.keys[o_key_raw[g_rows[i]]]
            if s_key == '_head':
                continue
            ka, _, ke = s_key.rpartition(':')
            aid = store.actor_of.get(ka, -1)
            if aid < 0 or not ke.isdigit():
                raise ValueError(
                    'List element insertion after unknown element '
                    + s_key)
            p_key[i] = (aid << 32) | int(ke)
    else:
        ins_objs = np.zeros(0, np.int64)
        new_key = p_key = np.zeros(0, np.int64)

    # ---- assignment prep (kinds, late-bound elemIds) ----
    assign_objs = np.zeros(0, np.int64)
    o_field = np.zeros(len(o_act), np.int64)
    e_sel = np.zeros(0, bool)
    if len(a_rows):
        kinds = o_kind[a_rows].copy()
        objr = o_objrow[a_rows]
        is_seq_obj = obj_type_arr[objr] != _TYPE_MAP
        t_actor = np.zeros(len(a_rows), np.int64)
        t_elem = np.zeros(len(a_rows), np.int64)
        e_sel0 = kinds == _KEY_ELEM
        if e_sel0.any():
            t_actor[e_sel0] = st.a_tab[o_key_raw[a_rows[e_sel0]]]
            t_elem[e_sel0] = o_key_elem[a_rows[e_sel0]]
        # string-addressed rows that target a sequence: late-bound
        # elemIds (the op was encoded before the creation was known —
        # possible only across a queue retry; rare)
        conv = (kinds == _KEY_STR) & is_seq_obj
        for i in np.flatnonzero(conv).tolist():
            s_key = block.keys[o_key_raw[a_rows[i]]]
            ka, _, ke = s_key.rpartition(':')
            aid = store.actor_of.get(ka, -1)
            if aid < 0 or not ke.isdigit():
                raise TypeError(
                    'Missing index entry for list element ' + s_key)
            t_actor[i] = aid
            t_elem[i] = int(ke)
        kinds[conv] = _KEY_ELEM
        if (kinds == _KEY_HEAD).any():
            raise ValueError('assignment to _head')
        s_sel = kinds == _KEY_STR
        fkey = np.zeros(len(a_rows), np.int64)
        if s_sel.any():
            fkey[s_sel] = st.k_tab[o_key_raw[a_rows[s_sel]]]
        e_sel = kinds == _KEY_ELEM
        if e_sel.any():
            if not is_seq_obj[e_sel].all():
                raise TypeError('Missing index entry for list element')
            assign_objs = np.unique(objr[e_sel])

    # dirty sequence objects: ins targets + element-assignment targets
    dirty = np.union1d(ins_objs, assign_objs).astype(np.int64)

    # ---- elemId resolution: peephole first, tables for the rest ----
    # The overwhelmingly common shapes are SEQUENTIAL: an ins whose
    # parent is the elemId minted by the nearest PRECEDING ins of the
    # same object (collaborative typing), and a set/del whose target
    # was minted by the op immediately before it in the same change.
    # Both resolve with one vectorized compare; only the residue pays
    # a sorted-table lookup, and the dup check rides the same sorted
    # key arrays. (Replaces a whole-union composite sort that cost
    # ~70 ms per 1M-op block.)
    if len(dirty):
        q_sel = p_key != -1
        if len(ins_rows):
            o_node[g_rows] = local_new     # minted ids, pre-validation
            # peephole A: parent == previous ins of the same object
            # (g is object-grouped, block-order within an object)
            matchA = np.zeros(len(g_rows), bool)
            if len(g_rows) > 1:
                matchA[1:] = (g_obj[1:] == g_obj[:-1]) & \
                    (p_key[1:] == new_key[:-1])
            matchA &= q_sel
            parent_local = np.zeros(len(g_rows), np.int64)
            mA = np.flatnonzero(matchA)
            parent_local[mA] = local_new[mA - 1]
        else:
            matchA = np.zeros(0, bool)
            parent_local = np.zeros(0, np.int64)

        if e_sel.any():
            # peephole B: target minted by the immediately preceding
            # kept op (same object, an ins) — o_node already holds the
            # minted local ids
            er = a_rows[e_sel]
            tgt_key = (t_actor[e_sel] << 32) | t_elem[e_sel]
            prev_r = er - 1
            okB = prev_r >= 0
            pr = np.maximum(prev_r, 0)
            okB &= (o_act[pr] == _INS) & (o_objrow[pr] == objr[e_sel])
            prev_key = (st.o_actor[pr].astype(np.int64) << 32) | \
                o_elem[pr].astype(np.int64)
            matchB = okB & (prev_key == tgt_key)
            nodes = np.full(len(er), -1, np.int64)
            nodes[matchB] = o_node[pr[matchB]]
        else:
            tgt_key = np.zeros(0, np.int64)
            matchB = np.zeros(0, bool)
            nodes = np.zeros(0, np.int64)

        residA = q_sel & ~matchA
        residB = ~matchB if e_sel.any() else np.zeros(0, bool)
        need_dup = len(ins_rows) > 0
        if need_dup or residA.any() or (e_sel.any() and residB.any()):
            ins_job = np.searchsorted(dirty, g_obj) \
                if len(ins_rows) else np.zeros(0, np.int64)
            # staging cache: warm dirty objects keep a sorted elemId
            # index (pool.elem_index) — consult it in O(delta log n)
            # instead of re-tabulating every node of every dirty
            # object. Heads are excluded from the cache; no query or
            # dup comp can equal a head comp (real keys shift +1), so
            # the sorted arrays are interchangeable with the legacy
            # table's.
            ec = pool._elem_cache
            use_cache = (_STAGE_CACHE is not False
                         and _blocks._delta_host_on()
                         and all(int(o) in ec for o in dirty.tolist()))
            if use_cache:
                ents = [ec[int(o)] for o in dirty.tolist()]
                t_counts = np.asarray([len(e[0]) for e in ents],
                                      np.int64)
                t_keys = np.concatenate([e[0] for e in ents])
                t_local = np.concatenate([e[1] for e in ents])
                t_rows = None
            else:
                t_rows, t_counts = pool.rows_of_objs(dirty)
                t_keys = pool.node_keys(t_rows)
                t_local = None
            # shift keys >= 0 (head sentinel -> 0) and pack (job, key)
            # into one int64 when it fits; else the union fallback
            jb = max(int(np.ceil(np.log2(max(len(dirty), 2)))), 1)
            new_k1 = new_key + 1
            t_k1 = np.where(t_keys == _HEAD_KEY, 0, t_keys + 1)
            # the overflow guard must cover QUERY keys too (an unknown
            # elemId with a huge key would otherwise alias into another
            # job's packed range instead of raising — r5 review)
            kmax = max(int(new_k1.max()) if len(new_k1) else 0,
                       int(t_k1.max()) if len(t_k1) else 0,
                       int(p_key[residA].max()) + 1
                       if residA.any() else 0,
                       int(tgt_key[residB].max()) + 1
                       if len(residB) and residB.any() else 0)
            if kmax < (1 << (63 - jb)):
                t_job = np.repeat(np.arange(len(dirty),
                                            dtype=np.int64), t_counts)
                new_comp = (ins_job << (63 - jb)) | new_k1
                old_comp = (t_job << (63 - jb)) | t_k1
                need_lookup = residA.any() or (len(residB)
                                               and residB.any())
                if use_cache:
                    # per-job sorted keys + ascending job bits: the
                    # concatenation is already globally sorted
                    old_comp_s = old_comp
                    old_val_s = t_local
                elif need_lookup:
                    ordo = np.argsort(old_comp, kind='stable')
                    old_comp_s = old_comp[ordo]
                    old_val_s = pool.local[t_rows[ordo]] \
                        .astype(np.int64)
                else:
                    old_comp_s = np.sort(old_comp)
                    old_val_s = None
                ordn = np.argsort(new_comp, kind='stable')
                new_comp_s = new_comp[ordn]
                if need_dup:
                    if len(new_comp_s) > 1 and \
                            (new_comp_s[1:] == new_comp_s[:-1]).any():
                        raise ValueError('Duplicate list element ID')
                    pos = np.searchsorted(old_comp_s, new_comp_s)
                    pos = np.minimum(pos, max(len(old_comp_s) - 1, 0))
                    if len(old_comp_s) and \
                            (old_comp_s[pos] == new_comp_s).any():
                        raise ValueError('Duplicate list element ID')

                def lookup(job, key):
                    """(job, key) -> local id, -1 miss: new first,
                    then the pool's existing nodes."""
                    comp = (job << (63 - jb)) | (key + 1)
                    out = np.full(len(comp), -1, np.int64)
                    if len(new_comp_s):
                        p = np.minimum(
                            np.searchsorted(new_comp_s, comp),
                            len(new_comp_s) - 1)
                        hit = new_comp_s[p] == comp
                        out[hit] = local_new[ordn[p[hit]]]
                    miss = out < 0
                    if miss.any() and len(old_comp_s):
                        p = np.minimum(
                            np.searchsorted(old_comp_s, comp[miss]),
                            len(old_comp_s) - 1)
                        hit = old_comp_s[p] == comp[miss]
                        mi = np.flatnonzero(miss)
                        out[mi[hit]] = old_val_s[p[hit]]
                    return out

                if residA.any():
                    got = lookup(ins_job[residA], p_key[residA])
                    if (got < 0).any():
                        raise ValueError(
                            'List element insertion after unknown '
                            'element')
                    parent_local[residA] = got
                if e_sel.any() and residB.any():
                    ejob = np.searchsorted(dirty, objr[e_sel])
                    got = lookup(ejob[residB], tgt_key[residB])
                    if (got < 0).any():
                        raise TypeError(
                            'Missing index entry for list element')
                    nodes[residB] = got
            else:
                # wide keys: the whole-union composite lookup (exact;
                # overwrites the peephole results with equal values).
                # Needs the full row table — rebuild it if the cache
                # path skipped it (rare: >2^21 actors or >2^31 elems)
                if t_rows is None:
                    t_rows, t_counts = pool.rows_of_objs(dirty)
                    t_keys = pool.node_keys(t_rows)
                t_job = np.repeat(np.arange(len(dirty),
                                            dtype=np.int64), t_counts)
                ejob = np.searchsorted(dirty, objr[e_sel]) \
                    if e_sel.any() else np.zeros(0, np.int64)
                n_pq = int(q_sel.sum())
                res, dup = _exact_lookup(
                    np.concatenate([t_job, ins_job]),
                    np.concatenate([t_keys, new_key]),
                    np.concatenate([pool.local[t_rows]
                                    .astype(np.int64),
                                    local_new if local_new is not None
                                    else np.zeros(0, np.int64)]),
                    np.concatenate([ins_job[q_sel], ejob]),
                    np.concatenate([p_key[q_sel], tgt_key]),
                    len(dirty))
                if dup:
                    raise ValueError('Duplicate list element ID')
                if len(ins_rows):
                    parent_local[q_sel] = res[:n_pq]
                    if (parent_local < 0).any():
                        raise ValueError(
                            'List element insertion after unknown '
                            'element')
                if e_sel.any():
                    nodes = res[n_pq:]

        if e_sel.any():
            if (nodes < 0).any():
                raise TypeError('Missing index entry for list element')
            fkey[e_sel] = _ELEM_BIT | nodes
            o_node[a_rows[e_sel]] = nodes
        if len(ins_rows):
            pool.append_batch(g_obj, local_new, parent_local, g_actor,
                              g_elem)
    if len(a_rows):
        o_field[a_rows] = (objr << 32) | fkey


    f_new = o_field[a_rows]
    return f_new, o_node[a_rows], o_objrow[a_rows], dirty, ins_objs


class _LazyCat:
    """The apply's row-column dict, built per key on FIRST access:
    `thunks[k]()` returns (new_part, prior_part); prior_part of None
    means the column is already concatenated."""

    __slots__ = ('_thunks', '_n_prior', '_cols', '_lock')

    def __init__(self, thunks, n_prior):
        self._thunks = thunks
        self._n_prior = n_prior
        self._cols = {}
        # the applier thread (deferred commit) and a patch reader can
        # both force a column; builds are idempotent but the thunk-drop
        # below is not
        self._lock = threading.Lock()

    def __getitem__(self, k):
        c = self._cols.get(k)
        if c is not None:
            return c
        with self._lock:
            return self._build(k)

    def _build(self, k):
        c = self._cols.get(k)
        if c is None:
            new_part, prior_part = self._thunks[k]()
            if prior_part is None:
                c = np.asarray(new_part)
            elif self._n_prior:
                c = np.concatenate([new_part, prior_part])
            else:
                c = np.asarray(new_part)
            self._cols[k] = c
            # drop the thunk: its closure pins the whole staged block
            # (st + op columns); once every column is built the apply's
            # working set becomes collectable
            self._thunks[k] = None
        return c


def _finish_empty(patch):
    z32 = np.zeros(0, np.int32)
    patch.f_doc = z32
    patch.f_obj = z32
    patch.f_key = np.zeros(0, np.int64)
    patch.f_kind = np.zeros(0, bool)
    patch.f_has_winner = np.zeros(0, bool)
    patch.f_value = z32
    patch.f_actor = z32
    patch.f_link = np.zeros(0, bool)
    patch.s_ptr = np.zeros(1, np.int32)
    patch.s_actor = z32
    patch.s_value = z32
    patch.s_link = np.zeros(0, bool)


def _update_inbound(store, patch, touched_fields, surviving, r_seg,
                    r_link, r_value, s_rows):
    """Link bookkeeping: survivors' targets gain an inbound ref, links
    that dropped out lose theirs (op_set.js:194-208). Link rows are rare
    — plain python over them."""
    link_rows = np.flatnonzero(r_link[:len(r_seg)])
    if not len(link_rows):
        return
    surv_set = set(s_rows.tolist())
    for j in link_rows.tolist():
        fi = int(r_seg[j])
        field = int(touched_fields[fi])
        obj_row = field >> 32
        key = field & 0xFFFFFFFF
        d = int(store.obj_doc[obj_row])
        target_uuid = store.values[int(r_value[j])]
        target = store.obj_of.get((d, target_uuid))
        if target is None:
            continue
        refs = store.obj_inbound.setdefault(target, [])
        ref = (obj_row, key)
        if j in surv_set:
            if ref not in refs:
                refs.append(ref)
        else:
            if ref in refs:
                refs.remove(ref)


# camelCase aliases (reference API style)
applyGeneralBlock = apply_general_block
