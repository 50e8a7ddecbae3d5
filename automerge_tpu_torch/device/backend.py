"""Batched device backend: wire changes in, patches out, the card in
between (the PyTorch port of ``automerge_tpu/device/backend.py``).

This module puts the device engine behind the frontend<->backend
change/patch protocol (the reference's `backend/index.js:161-163` surface):
``apply_changes_batch`` takes per-document wire changes and returns
per-document **patches** — diffs with obj/key/value/conflicts exactly as
the reference's diff emission produces them (`backend/op_set.js:105-177`)
— while the heavy resolution work for every document in the batch runs in
ONE fused device step: a segment-reduction pass resolving every touched
field (:mod:`.merge`), element visibility derived on device from the
survivors, and an RGA ordering pass recomputing document order for every
dirty list/text object (:mod:`.sequence`, whose ordering step is the
hand-written RGA kernel on the card) — no host round-trip between
resolution and ordering. Map-only batches take the standalone resolve,
which on the card is the hand-written flat-map kernel
(``engine.pick_resolve_kernel``).

Every state records the ``device`` it was created for (:func:`init`:
``None`` means CUDA and raises without a card); a batch runs on its
states' device and refuses a mix. ``Frontend.init`` calls
``backend.init()`` without arguments, so a frontend that should create
device documents is given :func:`for_device` instead of this module.

State model. :class:`DeviceBackendState` is a persistent snapshot (old
snapshots stay valid after applies, like the oracle): per-field surviving
op entries (winner first), per-object records (inbound links; for
sequences the insertion tree as packable columns plus the visible-order
index), the applied-change log per actor, vector clock, dep frontier,
causal buffer. Each apply packs *prior surviving entries of the touched
fields* plus the new assignment ops into dense arrays; the kernel
re-resolves those fields; the unpacked winners become the new field state.
Untouched fields are never re-packed, so the assignment phase is
O(touched), not O(doc). Dirty sequence objects are re-ordered whole by the
RGA kernel — O(n log n) parallel device work replacing the oracle's
per-element pointer walks — and the patch carries the remove/insert/set
list edits derived from the kernel's visible indexes.

Sequence diffs are emitted as a compaction of the oracle's per-op diff
stream: removes (descending old index), then inserts (ascending final
index), then sets (final index). Applying either stream through
``Frontend.apply_patch`` yields the identical document.
"""

import sys

import numpy as np
import torch

from ..common import ROOT_ID
from ..backend.op_set import SharedChangeLog, causally_ready, transitive_deps
from ..config import resolve_device
from ..utils.metrics import metrics
from . import engine as _engine
from .merge import resolve_assignments_batch
from .sequence import _rga_order_batched


class _ObjRecord:
    """Per-object device-backend state (counterpart of op_set.js:63-93).

    For sequences the insertion tree is stored as columnar node arrays —
    node 0 is the virtual ``'_head'`` — ready to pack for the RGA kernel,
    plus ``elem_ids``, the visible document order (the order-statistic
    index the reference keeps in its SkipList).
    """

    __slots__ = ('type', 'inbound', 'nodes', 'node_of', 'node_parent',
                 'node_elem', 'node_actor', 'elem_ids')

    SEQUENCE_TYPES = ('makeList', 'makeText')

    def __init__(self, type_=None):
        self.type = type_        # None (root) / 'makeMap'/'makeList'/'makeText'
        self.inbound = []        # (obj, key) fields holding a link to this object
        if type_ in self.SEQUENCE_TYPES:
            self.nodes = ['_head']        # node index -> elemId
            self.node_of = {'_head': 0}   # elemId -> node index
            self.node_parent = [0]        # node index -> parent node index
            self.node_elem = [0]          # node index -> Lamport elem counter
            self.node_actor = ['']        # node index -> actor id string
            self.elem_ids = []            # visible elemIds in document order
        else:
            self.nodes = None

    def is_sequence(self):
        return self.type in self.SEQUENCE_TYPES

    def clone(self):
        rec = _ObjRecord.__new__(_ObjRecord)
        rec.type = self.type
        rec.inbound = list(self.inbound)
        if self.nodes is not None:
            rec.nodes = list(self.nodes)
            rec.node_of = dict(self.node_of)
            rec.node_parent = list(self.node_parent)
            rec.node_elem = list(self.node_elem)
            rec.node_actor = list(self.node_actor)
            rec.elem_ids = list(self.elem_ids)
        else:
            rec.nodes = None
        return rec


class DeviceBackendState(SharedChangeLog):
    """Persistent snapshot of one document's device-resident CRDT state.

    Mirrors what the oracle keeps in an OpSet (op_set.js:298-310), but with
    field state stored as packable entry tuples and insertion trees as
    columnar arrays. The change-log surface (actor_states/get_history/...)
    is shared with the oracle via :class:`SharedChangeLog`.
    """

    __slots__ = ('objects', 'fields', 'states', 'state_lens', 'clock',
                 'deps', 'queue', 'history', 'history_len', '_owned',
                 'log_truncated', 'undo_pos', 'undo_stack', 'redo_stack',
                 'link_fields', 'device')

    def __init__(self, device):
        self.device = device     # torch.device every apply runs on
        self.objects = {ROOT_ID: _ObjRecord(None)}
        # (obj, key) -> tuple of entries, winner first (actor-descending).
        # entry = {'actor','seq','all_deps','action'('set'|'link'),'value'}
        self.fields = {}
        self.states = {}        # actor -> grow-only [{'change','all_deps'}]
        self.state_lens = {}    # actor -> visible length in this snapshot
        self.clock = {}
        self.deps = {}
        self.queue = []         # causally-unready buffered changes
        self.history = []       # grow-only applied-change log
        self.history_len = 0
        self._owned = {ROOT_ID}  # objectIds private to this snapshot
        self.log_truncated = False  # True after a snapshot resume
        self.undo_pos = 0
        self.undo_stack = []     # per local change: list of inverse ops
        self.redo_stack = []
        self.link_fields = set()  # fields currently holding link entries

    def clone(self):
        new = DeviceBackendState.__new__(DeviceBackendState)
        new.device = self.device
        new.objects = dict(self.objects)   # records copy-on-write
        new.fields = dict(self.fields)     # entry tuples are immutable
        new.states = dict(self.states)
        new.state_lens = dict(self.state_lens)
        new.clock = dict(self.clock)
        new.deps = dict(self.deps)
        new.queue = list(self.queue)
        new.history = self.history
        new.history_len = self.history_len
        new._owned = set()
        new.log_truncated = self.log_truncated
        new.undo_pos = self.undo_pos
        new.undo_stack = list(self.undo_stack)
        new.redo_stack = list(self.redo_stack)
        new.link_fields = set(self.link_fields)
        return new

    def _writable(self, object_id):
        """Copy-on-write object record access (op_set.py _writable)."""
        if object_id not in self._owned:
            self.objects[object_id] = self.objects[object_id].clone()
            self._owned.add(object_id)
        return self.objects[object_id]

    def rebuild_link_fields(self):
        """Recompute the link-field registry from ``fields`` — every
        path that writes field entries DIRECTLY (snapshot restore,
        TextBlock bridging) must call this, or the link-free fast path
        in _update_fields would skip inbound maintenance."""
        self.link_fields = {
            f for f, entries in self.fields.items()
            if any(e['action'] == 'link' for e in entries)}


def init(_actor_id=None, device=None):
    """Empty backend state on ``device`` (None: CUDA; raises without a
    card unless ``'cpu'`` is asked for). The optional actor argument is
    accepted for reference-API compatibility and ignored
    (backend/index.js:123-125)."""
    return DeviceBackendState(resolve_device(device))


class _DeviceBound:
    """This module's backend surface with :func:`init` bound to one
    device: what ``Frontend.init({'backend': ...})`` takes, since the
    frontend calls ``backend.init()`` with no arguments. Every other
    name is the module's own (the states carry their device)."""

    __slots__ = ('device',)

    def __init__(self, device):
        self.device = resolve_device(device)

    def init(self, _actor_id=None):
        return init(_actor_id, device=self.device)

    def __getattr__(self, name):
        return getattr(sys.modules[__name__], name)


def for_device(device=None):
    """The backend surface bound to ``device`` (None: CUDA, raising
    without a card), for ``Frontend.init({'backend': ...})``."""
    return _DeviceBound(device)


# -- host phase 1: causal ordering (op_set.js:267-283) -----------------------
# Readiness and transitive closure are the oracle's own helpers
# (op_set.causally_ready / transitive_deps) — both backends duck-type the
# same .clock / .actor_state surface, so causal-delivery semantics can
# never diverge between them.

def _admit_changes(state, changes):
    """Fixed-point causal delivery: returns [(change, all_deps)] of the
    ready changes in application order; the rest stay in state.queue.

    Duplicates (seq already applied) are dropped after verifying the change
    matches what was applied (op_set.js:243-248).
    """
    pending = state.queue + list(changes)
    state.queue = []
    ready = []
    while True:
        progress, remaining = False, []
        for change in pending:
            actor, seq = change['actor'], change['seq']
            if not isinstance(seq, int) or seq < 1:
                raise ValueError(
                    f'Change requires a positive integer seq, got {seq!r}')
            _, n = state.actor_states(actor)
            if seq <= n:
                prior = state.actor_state(actor, seq - 1)['change']
                # prior is None for snapshot-era entries (body dropped by
                # the packed checkpoint): drop the duplicate unverified
                if prior is not None and prior != change:
                    raise ValueError(
                        f'Inconsistent reuse of sequence number {seq} by {actor}')
                continue
            if not causally_ready(state, change):
                remaining.append(change)
                continue
            base_deps = dict(change['deps'])
            base_deps[actor] = seq - 1
            all_deps = transitive_deps(state, base_deps)
            state._append_state(actor, {'change': change, 'all_deps': all_deps})
            state.clock[actor] = seq
            new_deps = {a: s for a, s in state.deps.items()
                        if s > all_deps.get(a, 0)}
            new_deps[actor] = seq
            state.deps = new_deps
            state._append_history(change)
            ready.append((change, all_deps))
            progress = True
        pending = remaining
        if not progress:
            state.queue = remaining
            return ready


# -- host phase 2: collect structural ops + touched-field rows ---------------

_MAKE_KIND = {'makeMap': 'map', 'makeList': 'list', 'makeText': 'text'}


class _DocWork:
    """Per-document staging between the host phases and the device calls.

    Rows are kept as parallel columns: the per-row metadata of NEW ops is
    derived from per-change metadata (``changes_meta``) by vectorized
    gather in :func:`_pack_docs` — the per-op Python work is one dict
    lookup for the segment id and the entry-dict construction; everything
    per-row-numeric (actor rank, seq, clock) is a numpy gather. Prior
    entries of touched fields (usually few) append as explicit rows with
    ``row_change = -1``.
    """

    __slots__ = ('state', 'create_diffs', 'touched', 'dirty_seq',
                 'touched_by_obj', 'survivors', 'ins_dirty',
                 'changes_meta', 'row_field', 'row_entry', 'row_change',
                 'row_seg', 'row_node', 'row_objloc', 'row_is_del',
                 'n_new', 'has_links')

    def __init__(self, state):
        self.state = state
        self.has_links = False    # any link op staged this batch
        self.create_diffs = []
        self.touched = []         # (obj, key) in first-touch order
        self.dirty_seq = []       # sequence obj ids needing re-ordering
        self.touched_by_obj = {}  # obj -> [key] (first-touch order)
        self.survivors = {}       # field -> surviving entries (post-kernel)
        self.ins_dirty = set()    # seq objs that gained nodes this batch
        self.changes_meta = []    # per change: (actor, seq, all_deps)
        self.row_field = []       # field tuple per row
        self.row_entry = []       # entry dict per row
        self.row_change = []      # change index per row (-1 for priors)
        self.row_seg = []         # segment id per row
        self.row_node = []        # node index within its seq obj (-1: map)
        self.row_objloc = []      # index into dirty_seq (-1: map row)
        self.row_is_del = []
        self.n_new = 0

    @property
    def n_rows(self):
        return len(self.row_field)


def _stage_changes(work, admitted):
    state = work.state
    seg_of = {}                  # field -> segment id (first-touch order)
    dirty_of = {}                # seq obj -> index into dirty_seq
    objects = state.objects
    # bound-method locals: this loop runs per OP and dominates the host
    # side of interactive text batches
    touched_append = work.touched.append
    row_field_append = work.row_field.append
    row_entry_append = work.row_entry.append
    row_change_append = work.row_change.append
    row_seg_append = work.row_seg.append
    row_node_append = work.row_node.append
    row_objloc_append = work.row_objloc.append
    row_is_del_append = work.row_is_del.append
    seg_of_get = seg_of.get
    objects_get = objects.get
    ins_obj = None               # last ins target's bound caches
    ins_node_of = ins_nodes_append = ins_parent_append = None
    ins_elem_append = ins_actor_append = None
    ins_n = 0
    for ci, (change, all_deps) in enumerate(admitted):
        actor, seq = change['actor'], change['seq']
        work.changes_meta.append((actor, seq, all_deps))
        for op in change['ops']:
            action = op['action']
            if action in ('set', 'del', 'link'):
                obj = op['obj']
                rec = objects_get(obj)
                if rec is None:
                    raise ValueError('Modification of unknown object ' + obj)
                key = op['key']
                if rec.nodes is not None:       # sequence object
                    node = rec.node_of.get(key)
                    if node is None:
                        raise TypeError(
                            'Missing index entry for list element '
                            + str(key))
                    jl = dirty_of.get(obj)
                    if jl is None:
                        jl = dirty_of[obj] = len(work.dirty_seq)
                        work.dirty_seq.append(obj)
                else:
                    node = jl = -1
                field = (obj, key)
                seg = seg_of_get(field)
                if seg is None:
                    seg = seg_of[field] = len(work.touched)
                    touched_append(field)
                    work.touched_by_obj.setdefault(obj, []).append(key)
                if action == 'link':
                    work.has_links = True
                row_field_append(field)
                row_entry_append(
                    {'actor': actor, 'seq': seq, 'all_deps': all_deps,
                     'action': action, 'value': op.get('value')})
                row_change_append(ci)
                row_seg_append(seg)
                row_node_append(node)
                row_objloc_append(jl)
                row_is_del_append(action == 'del')
            elif action == 'ins':
                obj = op['obj']
                if obj != ins_obj:           # per-object bound caches
                    if obj not in objects:
                        raise ValueError(
                            'Modification of unknown object ' + obj)
                    rec = state._writable(obj)
                    if not rec.is_sequence():
                        raise ValueError(
                            'Insertion into non-sequence object ' + obj)
                    ins_obj = obj
                    ins_node_of = rec.node_of
                    ins_nodes_append = rec.nodes.append
                    ins_parent_append = rec.node_parent.append
                    ins_elem_append = rec.node_elem.append
                    ins_actor_append = rec.node_actor.append
                    ins_n = len(rec.nodes)
                    work.ins_dirty.add(obj)
                    if obj not in dirty_of:
                        dirty_of[obj] = len(work.dirty_seq)
                        work.dirty_seq.append(obj)
                elem = op['elem']
                elem_id = f'{actor}:{elem}'
                if elem_id in ins_node_of:
                    raise ValueError('Duplicate list element ID ' + elem_id)
                parent = ins_node_of.get(op['key'])
                if parent is None:
                    raise ValueError(
                        'List element insertion after unknown element '
                        + str(op['key']))
                ins_node_of[elem_id] = ins_n
                ins_n += 1
                ins_nodes_append(elem_id)
                ins_parent_append(parent)
                ins_elem_append(elem)
                ins_actor_append(actor)
            elif action in _MAKE_KIND:
                obj = op['obj']
                if obj in state.objects:
                    raise ValueError('Duplicate creation of object ' + obj)
                state.objects[obj] = _ObjRecord(action)
                state._owned.add(obj)
                work.create_diffs.append(
                    {'action': 'create', 'obj': obj,
                     'type': _MAKE_KIND[action]})
            else:
                raise ValueError(f'Unknown operation type {action}')

    # Prior surviving entries of every touched field join the batch so the
    # kernel can both supersede them and rank them against the new ops.
    work.n_new = len(work.row_field)
    for field in work.touched:
        entries = state.fields.get(field)
        if not entries:
            continue
        obj = field[0]
        rec = objects[obj]
        if rec.nodes is not None:
            node = rec.node_of[field[1]]
            jl = dirty_of[obj]
        else:
            node = jl = -1
        seg = seg_of[field]
        for entry in entries:
            work.row_field.append(field)
            work.row_entry.append(entry)
            work.row_change.append(-1)
            work.row_seg.append(seg)
            work.row_node.append(node)
            work.row_objloc.append(jl)
            work.row_is_del.append(False)


# -- device phase A: assignment resolution (pack, resolve, unpack) -----------

def _pack_docs(works, options, job_of=None, m_pad=0):
    """Pack every staged row of every doc into [D, n] planes.

    Per-row metadata of new ops is GATHERED from per-change columns
    (actor rank, seq, clock row) — the only per-row host loop left is
    over prior entries, which are few on incremental workloads. With
    `job_of` (a (work id, obj) -> sequence-job index map), each row
    touching a sequence element also gets a flat (job * m_pad + node)
    slot so the fused kernel can derive element visibility on device
    (-1 for map rows). Returns (arrays, n_segs, row_slot).
    """
    d = len(works)
    max_rows = max((w.n_rows for w in works), default=0)
    n = options.pad_ops(max_rows)
    seg_id = np.zeros((d, n), options.index_dtype)
    actor = np.zeros((d, n), options.index_dtype)
    seq = np.zeros((d, n), options.clock_dtype)
    is_del = np.zeros((d, n), bool)
    valid = np.zeros((d, n), bool)
    row_slot = np.full((d, n), -1, np.int32) if job_of is not None else None

    n_actors = 1
    clocks = []
    max_segs = 1
    for i, w in enumerate(works):
        n_rows, n_new = w.n_rows, w.n_new
        prior_entries = w.row_entry[n_new:]
        actor_names = sorted(
            {m[0] for m in w.changes_meta}
            | {e['actor'] for e in prior_entries})
        rank = {a: j for j, a in enumerate(actor_names)}
        a = max(len(actor_names), 1)
        n_actors = max(n_actors, a)
        max_segs = max(max_segs, len(w.touched))
        crows = np.zeros((n, a), options.clock_dtype)
        if n_rows:
            seg_id[i, :n_rows] = w.row_seg
            is_del[i, :n_rows] = w.row_is_del
            valid[i, :n_rows] = True
        if n_new:
            # per-change columns, gathered to rows
            C = len(w.changes_meta)
            ch_rank = np.empty(C, options.index_dtype)
            ch_seq = np.empty(C, options.clock_dtype)
            ch_clock = np.zeros((C, a), options.clock_dtype)
            for c, (a_name, s, all_deps) in enumerate(w.changes_meta):
                ch_rank[c] = rank[a_name]
                ch_seq[c] = s
                for da, ds in all_deps.items():
                    r = rank.get(da)
                    if r is not None:
                        ch_clock[c, r] = ds
            rows_change = np.asarray(w.row_change[:n_new], np.int64)
            actor[i, :n_new] = ch_rank[rows_change]
            seq[i, :n_new] = ch_seq[rows_change]
            crows[:n_new] = ch_clock[rows_change]
        for j in range(n_new, n_rows):            # prior entries (few)
            entry = w.row_entry[j]
            actor[i, j] = rank[entry['actor']]
            seq[i, j] = entry['seq']
            for da, ds in entry['all_deps'].items():
                r = rank.get(da)
                if r is not None:
                    crows[j, r] = ds
        if job_of is not None and n_rows:
            wid = id(w)
            loc2job = np.asarray(
                [job_of.get((wid, obj), -1) for obj in w.dirty_seq]
                + [-1], np.int64)
            objloc = np.asarray(w.row_objloc, np.int64)
            node = np.asarray(w.row_node, np.int64)
            job = loc2job[objloc]
            row_slot[i, :n_rows] = np.where(
                (objloc >= 0) & (job >= 0), job * m_pad + node, -1)
        clocks.append(crows)

    # pad the actor axis to a power of two as well: all three kernel-input
    # dims stay bucketed, so the jit cache is shared across batches
    n_actors = options.pad_actors(n_actors)
    clock = np.zeros((d, n, n_actors), options.clock_dtype)
    for i, crows in enumerate(clocks):
        clock[i, :, :crows.shape[1]] = crows

    n_segs = options.pad_segments(max_segs)
    return (seg_id, actor, seq, clock, is_del, valid), n_segs, row_slot


def _resolve_batch(arrays, n_segs, options, device):
    """Assignment-only resolution on ``device``: ``'auto'``/``'pallas'``
    launch the flat-map kernel on the card, ``'xla'`` runs the PyTorch
    segment resolve (``engine.pick_resolve_kernel``)."""
    resolve = _engine.pick_resolve_kernel(options.kernel)
    out = resolve(*(torch.as_tensor(a).to(device) for a in arrays),
                  num_segments=n_segs)
    return out['surviving'].cpu().numpy()


def _fused_step(seg_id, actor, seq, clock, is_del, valid, row_slot,
                s_parent, s_elem, s_actor, s_prior_vis, s_valid, *,
                num_segments):
    """Resolve assignments + derive element visibility + RGA-order every
    dirty sequence, in ONE device step (no host round-trip between
    conflict resolution and ordering; the ordering step is the RGA
    kernel on the card).

    Element visibility after the batch: a node with any batch row keeps
    a value iff some row survived (dels never survive); untouched nodes
    keep their prior visibility.
    """
    out = resolve_assignments_batch(seg_id, actor, seq, clock, is_del,
                                    valid, num_segments=num_segments)

    k, m = s_parent.shape
    # rows outside every job scatter into the sink slot k*m (the
    # reference drops them)
    flat = torch.where(row_slot >= 0, row_slot.to(torch.int64),
                       torch.full_like(row_slot, k * m, dtype=torch.int64)) \
        .reshape(-1)

    def scatter_any(vals):
        hit = torch.zeros(k * m + 1, dtype=torch.uint8, device=flat.device)
        hit = hit.scatter_reduce(0, flat, vals.reshape(-1).to(torch.uint8),
                                 'amax')
        return hit[:k * m].reshape(k, m).to(torch.bool)

    visible = torch.where(scatter_any(valid), scatter_any(out['surviving']),
                          s_prior_vis.to(torch.bool))
    visible = visible & s_valid.to(torch.bool)

    ordered = _rga_order_batched(s_parent, s_elem, s_actor, visible,
                                 s_valid)
    return out, visible, ordered


def _update_fields(work, surviving_row):
    """Fold kernel survivors back into field state + the inbound graph
    (the state effects of op_set.js:180-219); diff emission comes after."""
    state = work.state
    survivors_by_field = {f: [] for f in work.touched}
    row_field, row_entry = work.row_field, work.row_entry
    for j in np.flatnonzero(surviving_row[:work.n_rows]):
        survivors_by_field[row_field[j]].append(row_entry[j])

    # link bookkeeping only runs for fields where links are in play — a
    # text session touches thousands of fields per batch, none of them
    # links, even when the document ROOT holds link fields
    batch_links = work.has_links
    link_fields = state.link_fields
    fields = state.fields
    fields_get = fields.get
    work_survivors = work.survivors
    for field in work.touched:
        survivors = survivors_by_field[field]
        if len(survivors) > 1:
            survivors.sort(key=lambda e: e['actor'], reverse=True)

        if batch_links or field in link_fields:
            before = fields_get(field, ())
            # inbound maintenance: link refs that dropped out leave the
            # target, new surviving links join it (op_set.js:194-208).
            gone = [e for e in before
                    if e not in survivors and e['action'] == 'link']
            for e in gone:
                if e['value'] in state.objects:
                    target = state._writable(e['value'])
                    target.inbound = [r for r in target.inbound
                                      if r != field]
            has_link = False
            for e in survivors:
                if e['action'] == 'link':
                    has_link = True
                    target = state._writable(e['value'])
                    if field not in target.inbound:
                        target.inbound.append(field)
            if has_link:
                state.link_fields.add(field)
            else:
                state.link_fields.discard(field)

        fields[field] = tuple(survivors)
        work_survivors[field] = survivors


def _get_path(state, object_id):
    """Key path from root (op_set.js:43-60); list positions as indexes."""
    path = []
    while object_id != ROOT_ID:
        rec = state.objects.get(object_id)
        if rec is None or not rec.inbound:
            return None
        parent, key = rec.inbound[0]
        prec = state.objects[parent]
        if prec.is_sequence():
            try:
                path.insert(0, prec.elem_ids.index(key))
            except ValueError:
                return None
        else:
            path.insert(0, key)
        object_id = parent
    return path


def _conflict_entries(losers):
    out = []
    for entry in losers:
        conflict = {'actor': entry['actor'], 'value': entry['value']}
        if entry['action'] == 'link':
            conflict['link'] = True
        out.append(conflict)
    return out


def _emit_map_diffs(work):
    """Map-key diffs for every touched map field (op_set.js:161-177)."""
    state = work.state
    diffs = []
    for field in work.touched:
        obj, key = field
        if state.objects[obj].is_sequence():
            continue
        survivors = work.survivors[field]
        edit = {'action': 'set' if survivors else 'remove', 'type': 'map',
                'obj': obj, 'key': key, 'path': _get_path(state, obj)}
        if survivors:
            winner = survivors[0]
            edit['value'] = winner['value']
            if winner['action'] == 'link':
                edit['link'] = True
            if len(survivors) > 1:
                edit['conflicts'] = _conflict_entries(survivors[1:])
        diffs.append(edit)
    return diffs


# -- device phase B: sequence re-ordering (RGA kernel) -----------------------

def _collect_seq_jobs(works):
    """One job per dirty sequence object across the whole doc batch."""
    jobs = []
    for w in works:
        for obj in w.dirty_seq:
            rec = w.state._writable(obj)
            # prior visibility = the before-state order index (elem_ids
            # holds exactly the visible elements); the fused kernel
            # derives post-batch visibility for touched nodes on device
            vis_set = set(rec.elem_ids)
            prior_vis = np.fromiter((eid in vis_set for eid in rec.nodes),
                                    bool, len(rec.nodes))
            jobs.append((w, obj, rec, prior_vis))
    return jobs


def _pack_seq_jobs(jobs, m_pad, options):
    """Pack every dirty sequence object's insertion tree into [K, m]
    planes for the fused kernel."""
    k = len(jobs)
    parent = np.zeros((k, m_pad), options.index_dtype)
    elem = np.zeros((k, m_pad), options.clock_dtype)
    actor = np.zeros((k, m_pad), options.index_dtype)
    prior_vis = np.zeros((k, m_pad), bool)
    valid = np.zeros((k, m_pad), bool)
    for i, (_w, _obj, rec, pv) in enumerate(jobs):
        n = len(rec.nodes)
        parent[i, :n] = rec.node_parent
        elem[i, :n] = rec.node_elem
        # rank order must preserve actor-string order (op_set.js:371-377)
        names = sorted(set(rec.node_actor))
        rank = {a: j for j, a in enumerate(names)}
        actor[i, :n] = [rank[a] for a in rec.node_actor]
        prior_vis[i, :n] = pv
        valid[i, :n] = True
    return parent, elem, actor, prior_vis, valid


def _emit_seq_diffs(work, obj, rec, visible, vis_index):
    """remove/insert/set list edits from the kernel's final ordering.

    The oracle walks each touched element through the evolving SkipList
    (op_set.js:105-159); here the final visible index of every node is
    already on hand (``vis_index``), so the edit script is: removes at old
    indexes (descending), inserts at final indexes (ascending), sets at
    final indexes. Applied in that order the indexes are valid at every
    intermediate step, and the resulting document equals the oracle's.
    """
    state = work.state
    obj_type = 'text' if rec.type == 'makeText' else 'list'
    old_index = {eid: i for i, eid in enumerate(rec.elem_ids)}
    touched = work.touched_by_obj.get(obj, ())

    removes, inserts, sets = [], [], []
    for key in touched:
        node = rec.node_of[key]
        vis_after = visible[node]
        was_visible = key in old_index
        if was_visible and not vis_after:
            removes.append(old_index[key])
        elif vis_after:
            survivors = work.survivors[(obj, key)]
            winner = survivors[0]
            edit = {'type': obj_type, 'obj': obj,
                    'index': int(vis_index[node]), 'value': winner['value']}
            if winner['action'] == 'link':
                edit['link'] = True
            if len(survivors) > 1:
                edit['conflicts'] = _conflict_entries(survivors[1:])
            if was_visible:
                edit['action'] = 'set'
                sets.append(edit)
            else:
                edit['action'] = 'insert'
                edit['elemId'] = key
                inserts.append(edit)

    removes.sort(reverse=True)
    inserts.sort(key=lambda e: e['index'])
    sets.sort(key=lambda e: e['index'])

    diffs = []
    if obj in work.ins_dirty:
        # Batched diffs net out an element inserted AND deleted within
        # one apply — its counter would never reach the frontend, whose
        # next local insert would mint a colliding elemId. A maxElem
        # diff keeps the frontend's counter truthful (extension over the
        # reference, which has the latent collision; see README).
        diffs.append({'action': 'maxElem', 'type': obj_type, 'obj': obj,
                      'value': max(rec.node_elem)})
    for idx in removes:
        diffs.append({'action': 'remove', 'type': obj_type, 'obj': obj,
                      'index': idx})
    diffs.extend(inserts)
    diffs.extend(sets)

    # rebuild the order index wholesale from the kernel's final ordering
    # (incremental list insert/delete would be O(n) per edit); identical
    # to applying the removes/inserts above in order
    vis_nodes = np.flatnonzero(vis_index >= 0)
    new_ids = [None] * len(vis_nodes)
    nodes = rec.nodes
    for node in vis_nodes.tolist():
        new_ids[vis_index[node]] = nodes[node]
    rec.elem_ids = new_ids

    path = _get_path(state, obj)
    for edit in diffs:
        edit['path'] = path
    return diffs


# -- patch assembly ----------------------------------------------------------

def _make_patch(state, diffs):
    return {'clock': dict(state.clock), 'deps': dict(state.deps),
            'canUndo': state.undo_pos > 0,
            'canRedo': bool(state.redo_stack), 'diffs': diffs}


# -- public surface ----------------------------------------------------------

def apply_changes_batch(states, changes_per_doc, kernel=None, options=None):
    """Apply wire changes to a batch of documents in one device call.

    Args:
      states: list of :class:`DeviceBackendState`, one per document,
        all on one device (the batch runs there; a mix raises).
      changes_per_doc: list (parallel to `states`) of change lists.
      options: :class:`~automerge_tpu_torch.config.Options`; `kernel`
        overrides just the kernel choice.

    Returns:
      (new_states, patches) — patches carry reference-format diffs. One
      diff per touched field / list element (the compaction of the
      oracle's per-op diff stream: applying either stream to a frontend
      yields the same doc).
    """
    from . import general_backend as _gb
    opts = _engine.as_options(options, kernel)
    works = []
    dev = None
    for i, (state, changes) in enumerate(zip(states, changes_per_doc)):
        if isinstance(state, _gb.GeneralBackendState):
            # a bulk-auto-routed document's token is served by the
            # general engine, not the per-doc staging loop — routing it
            # here would die deep inside _stage_changes with an opaque
            # AttributeError
            raise TypeError(
                f'states[{i}] is a GeneralBackendState (bulk-routed '
                f'document); apply through apply_changes / '
                f'general_backend.apply_changes, not '
                f'apply_changes_batch')
        if dev is None:
            dev = state.device
        elif state.device != dev:
            raise ValueError(
                f'states[{i}] is on {state.device}, states[0] on {dev}: '
                f'one batch runs on one device')
        state = state.clone()
        admitted = _admit_changes(state, changes)
        work = _DocWork(state)
        _stage_changes(work, admitted)
        works.append(work)

    total_rows = sum(w.n_rows for w in works)
    seq_jobs = _collect_seq_jobs(works)

    seq_vis = seq_out = None
    if seq_jobs:
        # ONE device program: resolve + visibility + RGA ordering
        m_pad = opts.pad_nodes(max(len(rec.nodes)
                                   for _, _, rec, _ in seq_jobs))
        job_of = {(id(w), obj): i
                  for i, (w, obj, _rec, _pv) in enumerate(seq_jobs)}
        arrays, n_segs, row_slot = _pack_docs(works, opts, job_of, m_pad)
        seq_arrays = _pack_seq_jobs(seq_jobs, m_pad, opts)
        out, visible, ordered = _fused_step(
            *(torch.as_tensor(a).to(dev)
              for a in (*arrays, row_slot, *seq_arrays)),
            num_segments=n_segs)
        metrics.bump('device_backend_fused_calls')
        surviving = out['surviving'].cpu().numpy()
        seq_vis = visible.cpu().numpy()
        seq_out = ordered['vis_index'].cpu().numpy()
    elif total_rows:
        arrays, n_segs, _ = _pack_docs(works, opts)
        surviving = _resolve_batch(arrays, n_segs, opts, dev)
    else:
        surviving = np.zeros((len(works), 1), bool)
    for i, w in enumerate(works):
        _update_fields(w, surviving[i])

    seq_diffs_by_work = {}
    if seq_jobs:
        for i, (w, obj, rec, _pv) in enumerate(seq_jobs):
            n = len(rec.nodes)
            diffs = _emit_seq_diffs(w, obj, rec, seq_vis[i, :n],
                                    seq_out[i, :n])
            seq_diffs_by_work.setdefault(id(w), []).extend(diffs)

    new_states, patches = [], []
    for w in works:
        diffs = list(w.create_diffs)
        diffs.extend(_emit_map_diffs(w))
        diffs.extend(seq_diffs_by_work.get(id(w), ()))
        new_states.append(w.state)
        patches.append(_make_patch(w.state, diffs))

    metrics.bump('device_backend_batches')
    metrics.bump('device_backend_ops', total_rows)
    if seq_jobs:
        metrics.bump('device_backend_seq_objects', len(seq_jobs))
    return new_states, patches


def apply_changes(state, changes, kernel=None, options=None):
    """Single-document facade matching Backend.apply_changes
    (backend/index.js:161-163).

    Bulk ingests auto-route to the general block engine: a fresh
    document receiving >= ``Options.bulk_route_min_ops`` ops in one
    call (a clone, a resync, a large merge) takes ONE fused block apply
    instead of the per-change staging loop, and continues on the
    general-backed state for subsequent applies; local changes and
    undo/redo convert back to this per-doc state
    (:mod:`.general_backend`)."""
    from . import general_backend as _gb
    opts = _engine.as_options(options, kernel)
    if isinstance(state, _gb.GeneralBackendState):
        new_state, patch = _gb.apply_changes(state, changes,
                                             options=opts)
        patch['diffs'] = list(patch['diffs'])    # facade: plain list
        return new_state, patch
    thr = opts.bulk_route_min_ops
    if thr is not None and not state.clock and not state.queue \
            and state.undo_pos == 0 and not state.redo_stack:
        changes = list(changes)      # sizing must not consume iterators
        n_ops = sum(len(c.get('ops', ())) for c in changes)
        if n_ops >= thr:
            new_state, patch = _gb.apply_changes(
                _gb.init(device=state.device), changes, options=opts)
            # the public facade promises a PLAIN diff list —
            # json.dumps(patch) and `diffs + [...]` must work on an
            # auto-routed result exactly as on the per-doc path
            patch['diffs'] = list(patch['diffs'])
            return new_state, patch
    new_states, patches = apply_changes_batch([state], [changes],
                                              kernel=kernel, options=options)
    return new_states[0], patches[0]


def _capture_undo_ops(state, change):
    """Inverse ops for one local change: each touched pre-existing field's
    surviving entries (as plain set/link ops), or a del if the field was
    new (op_set.js:185-192)."""
    new_objects = set()
    undo_ops = []
    seen = set()
    for op in change.get('ops', ()):
        action = op['action']
        if action in _MAKE_KIND:
            new_objects.add(op['obj'])
        elif action in ('set', 'del', 'link') and op['obj'] not in new_objects:
            field = (op['obj'], op['key'])
            if field in seen:
                continue
            seen.add(field)
            undo_ops.extend(_field_ops_or_del(state, [op]))
    return undo_ops


def _field_ops_or_del(state, ref_ops):
    """Current field state of each op's field as plain ops (the redo
    capture of backend/index.js:262-276)."""
    out = []
    for op in ref_ops:
        if op['action'] not in ('set', 'del', 'link'):
            raise ValueError(
                f'Unexpected operation type in undo history: {op}')
        entries = state.fields.get((op['obj'], op['key']), ())
        if not entries:
            out.append({'action': 'del', 'obj': op['obj'],
                        'key': op['key']})
        else:
            for e in entries:
                out.append({'action': e['action'], 'obj': op['obj'],
                            'key': op['key'], 'value': e['value']})
    return out


def _undo(state, request, kernel=None, options=None):
    """Apply the inverse ops from the undo stack as a new change
    (backend/index.js:252-285)."""
    if state.undo_pos < 1:
        raise ValueError('Cannot undo: there is nothing to be undone')
    undo_ops = state.undo_stack[state.undo_pos - 1]
    change = {'actor': request['actor'], 'seq': request['seq'],
              'deps': dict(request.get('deps', {})), 'ops': undo_ops}
    if request.get('message') is not None:
        change['message'] = request['message']
    redo_ops = _field_ops_or_del(state, undo_ops)

    new_state, patch = apply_changes(state, [change], kernel=kernel,
                                     options=options)
    new_state.undo_pos = state.undo_pos - 1
    new_state.redo_stack = state.redo_stack + [redo_ops]
    patch['canUndo'] = new_state.undo_pos > 0
    patch['canRedo'] = True
    return new_state, patch


def _redo(state, request, kernel=None, options=None):
    """Re-apply the ops reverted by the last undo (backend/index.js:293-308)."""
    if not state.redo_stack:
        raise ValueError('Cannot redo: the last change was not an undo')
    redo_ops = state.redo_stack[-1]
    change = {'actor': request['actor'], 'seq': request['seq'],
              'deps': dict(request.get('deps', {})), 'ops': redo_ops}
    if request.get('message') is not None:
        change['message'] = request['message']

    new_state, patch = apply_changes(state, [change], kernel=kernel,
                                     options=options)
    new_state.undo_pos = state.undo_pos + 1
    new_state.redo_stack = state.redo_stack[:-1]
    patch['canUndo'] = True
    patch['canRedo'] = bool(new_state.redo_stack)
    return new_state, patch


def apply_local_change(state, request, kernel=None, options=None):
    """Apply one local change request, recording undo history
    (backend/index.js:173-195)."""
    # GeneralBackendState participates natively: its `fields` view
    # serves the undo capture, apply_changes routes to the bulk
    # engine, and the token carries the undo/redo stacks. A STALE
    # token forks FIRST so the capture reads exactly its lineage
    # (the shared columns may hold newer changes).
    from . import general_backend as _gb
    if isinstance(state, _gb.GeneralBackendState):
        state = _gb.current_token(state)
    if not isinstance(request.get('actor'), str) or not isinstance(request.get('seq'), int):
        raise TypeError('Change request requires `actor` and `seq` properties')
    if request['seq'] <= state.clock.get(request['actor'], 0):
        raise ValueError('Change request has already been applied')
    request_type = request.get('requestType')
    if request_type == 'change':
        change = {k: v for k, v in request.items() if k != 'requestType'}
        undo_ops = _capture_undo_ops(state, change)
        new_state, patch = apply_changes(state, [change], kernel=kernel,
                                         options=options)
        new_state.undo_stack = \
            state.undo_stack[:state.undo_pos] + [undo_ops]
        new_state.undo_pos = state.undo_pos + 1
        new_state.redo_stack = []
        patch['canUndo'] = True
        patch['canRedo'] = False
    elif request_type == 'undo':
        new_state, patch = _undo(state, request, kernel=kernel,
                                 options=options)
    elif request_type == 'redo':
        new_state, patch = _redo(state, request, kernel=kernel,
                                 options=options)
    else:
        raise ValueError(f'Unknown requestType: {request_type}')
    patch['actor'] = request['actor']
    patch['seq'] = request['seq']
    return new_state, patch


def get_patch(state):
    """Whole-document patch from empty (backend/index.js:201-207): create
    diffs child-first, then field sets / element inserts, so the frontend
    can resolve links."""
    from . import general_backend as _gb
    if isinstance(state, _gb.GeneralBackendState):
        return _gb.get_patch(state)
    diffs = []
    emitted = set()
    # one pass over the field table, then per-object lookups are O(fields-of)
    fields_by_obj = {}
    for (obj, key), entries in state.fields.items():
        if entries:
            fields_by_obj.setdefault(obj, []).append((key, entries))

    def emit_entry_objects(entries):
        for e in entries:
            if e['action'] == 'link':
                emit_object(e['value'])

    def emit_object(obj_id):
        if obj_id in emitted:
            return
        emitted.add(obj_id)
        rec = state.objects[obj_id]
        obj_diffs = []
        if rec.is_sequence():
            obj_type = 'text' if rec.type == 'makeText' else 'list'
            obj_diffs.append({'action': 'create', 'obj': obj_id,
                              'type': obj_type,
                              'maxElem': max(rec.node_elem, default=0)})
            for index, elem_id in enumerate(rec.elem_ids):
                entries = state.fields[(obj_id, elem_id)]
                emit_entry_objects(entries)   # children first
                winner = entries[0]
                edit = {'action': 'insert', 'type': obj_type, 'obj': obj_id,
                        'index': index, 'elemId': elem_id,
                        'value': winner['value']}
                if winner['action'] == 'link':
                    edit['link'] = True
                if len(entries) > 1:
                    edit['conflicts'] = _conflict_entries(entries[1:])
                obj_diffs.append(edit)
        else:
            if obj_id != ROOT_ID:
                obj_diffs.append({'action': 'create', 'obj': obj_id,
                                  'type': 'map'})
            for key, entries in fields_by_obj.get(obj_id, ()):
                emit_entry_objects(entries)   # children first
                winner = entries[0]
                edit = {'action': 'set', 'type': 'map', 'obj': obj_id,
                        'key': key, 'value': winner['value']}
                if winner['action'] == 'link':
                    edit['link'] = True
                if len(entries) > 1:
                    edit['conflicts'] = _conflict_entries(entries[1:])
                obj_diffs.append(edit)
        diffs.extend(obj_diffs)

    emit_object(ROOT_ID)
    return _make_patch(state, diffs)


def get_missing_changes(state, have_deps):
    """Changes a peer with clock `have_deps` lacks (op_set.js:327-334)."""
    from . import general_backend as _gb
    if isinstance(state, _gb.GeneralBackendState):
        return _gb.get_missing_changes(state, have_deps)
    all_deps = transitive_deps(state, dict(have_deps))
    changes = []
    for actor in state.states:
        lst, n = state.actor_states(actor)
        for entry in lst[all_deps.get(actor, 0):n]:
            if entry['change'] is None:
                raise ValueError(
                    'change log truncated by a snapshot resume; a peer '
                    'this far behind needs the snapshot or the full log')
            changes.append(entry['change'])
    return changes


def get_changes_for_actor(state, for_actor, after_seq=0):
    from . import general_backend as _gb
    if isinstance(state, _gb.GeneralBackendState):
        return _gb.get_changes_for_actor(state, for_actor, after_seq)
    lst, n = state.actor_states(for_actor)
    out = []
    for entry in lst[after_seq:n]:
        if entry['change'] is None:
            raise ValueError(
                'change log truncated by a snapshot resume; a peer '
                'this far behind needs the snapshot or the full log')
        out.append(entry['change'])
    return out


def get_missing_deps(state):
    """Unmet dependencies of the buffered changes (op_set.js:347-358)."""
    from . import general_backend as _gb
    if isinstance(state, _gb.GeneralBackendState):
        return _gb.get_missing_deps(state)
    missing = {}
    for change in state.queue:
        deps = dict(change['deps'])
        deps[change['actor']] = change['seq'] - 1
        for a, s in deps.items():
            if state.clock.get(a, 0) < s:
                missing[a] = max(s, missing.get(a, 0))
    return missing


def merge(local, remote, kernel=None, options=None):
    """Pull changes present in `remote` but not `local`
    (backend/index.js:240-243)."""
    changes = get_missing_changes(remote, local.clock)
    return apply_changes(local, changes, kernel=kernel, options=options)


# camelCase aliases (reference API parity)
applyChanges = apply_changes
applyChangesBatch = apply_changes_batch
applyLocalChange = apply_local_change
getPatch = get_patch
getMissingChanges = get_missing_changes
getChangesForActor = get_changes_for_actor
getMissingDeps = get_missing_deps
