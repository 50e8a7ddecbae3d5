"""GeneralBackendState: the per-document backend surface served by the
general bulk engine.

The per-doc device backend (:mod:`.backend`) stages changes with
Python-per-change loops — right for interactive edits, dispatch-bound
for bulk ingestion (a 20k-op merge measured ~0.29s vs the bulk engine's
~0.15s at the same size). This module lets ``DeviceBackend
.apply_changes`` route LARGE ingests through
:func:`~.general.apply_general_block` while keeping the unchanged
backend protocol (`backend/index.js:161-163`): wire changes in,
reference-format patch out, persistent-state semantics preserved.

State model: a token over a (mutable) :class:`~.general.GeneralStore`.
The newest token applies in place; applying to a STALE token (a held
snapshot) forks a fresh store by replaying the retained log up to the
token's clock — correct for every history, fast for the overwhelmingly
common linear case. Reads that the sync protocol performs on old
tokens (``clock``, ``get_missing_changes``) are served exactly from
the append-only retained log filtered by the token clock.

Local changes and undo/redo run NATIVELY on the token: inverse-op
capture reads the store columns through the ``fields`` view (the same
surface `backend._capture_undo_ops` stages against), and the token
carries the undo/redo stacks — so a document ingested at bulk scale
keeps the full per-doc surface without ever converting. The per-doc
conversion (:func:`to_device_state`) remains available for callers
that want the staged representation.

This is the PyTorch port's copy: tokens live on a store of the caller's
``device`` (:func:`init`), and the per-doc state a token converts to
lives on the same device.
"""

import numpy as np

from ..common import ROOT_ID
from . import general as _general

_ELEM_BIT = int(_general._ELEM_BIT)
_TYPE_NAME = _general._TYPE_NAME
_TYPE_MAP = _general._TYPE_MAP


class GeneralBackendState:
    """Persistent-token view of a one-document general store."""

    __slots__ = ('store', '_version', 'clock', 'deps', '_all_deps',
                 '_device_state', 'undo_pos', 'undo_stack',
                 'redo_stack')

    def __init__(self, store, version, clock, deps, all_deps):
        self.store = store
        self._version = version
        self.clock = clock
        self.deps = deps
        self._all_deps = all_deps      # (actor, seq) -> transitive deps
        self._device_state = None
        self.undo_pos = 0
        self.undo_stack = []
        self.redo_stack = []

    def _is_current(self):
        return self._version == getattr(self.store, '_gb_version', 0)

    @property
    def fields(self):
        """Read-only (obj uuid, key) -> surviving entries view — the
        surface the per-doc undo capture reads
        (`backend._field_ops_or_del`), served from the store columns."""
        return _FieldsView(self)


class _FieldsView:
    """Lazy field lookup over the general store's entry columns:
    ``get((obj_uuid, key))`` returns the field's surviving entries,
    winner first, as the per-doc backend's entry dicts. O(doc entries)
    per lookup — local-change undo capture touches a handful of
    fields."""

    __slots__ = ('_state',)

    def __init__(self, state):
        self._state = state

    def get(self, field, default=()):
        state = self._state
        store = state.store
        store._commit_pending()
        obj_uuid, key = field
        row = store.obj_of.get((0, obj_uuid))
        if row is None:
            return default
        if store.is_seq(row):
            # elemId key 'actor:counter' -> local node index
            actor_s, _, counter = str(key).rpartition(':')
            aid = store.actor_of.get(actor_s, -1)
            if aid < 0 or not counter.isdigit():
                return default
            pool = store.pool
            prows, _ = pool.rows_of_objs(np.asarray([row]))
            hit = np.flatnonzero((pool.actor[prows] == aid)
                                 & (pool.elemc[prows] == int(counter)))
            if not len(hit):
                return default
            fkey = _ELEM_BIT | int(pool.local[prows[hit[0]]])
        else:
            kid = store.key_of.get(key)
            if kid is None:
                return default
            fkey = kid
        js = np.flatnonzero((store.e_obj == row)
                            & (store.e_key == fkey))
        if not len(js):
            return default
        # winner ordering through the one shared rule
        by = doc_fields_sorted(store, 0, rows=js.tolist())
        entries = next(iter(by.values()))
        out = []
        for j in entries:
            v = store.e_value[j]
            out.append({'action': 'link' if store.e_link[j] else 'set',
                        'actor': store.actors[store.e_actor[j]],
                        'value': store.values[v] if v >= 0 else None})
        return out


def init(device=None):
    """A fresh one-document token on ``device`` (None: CUDA; raises
    without a card unless ``'cpu'`` is asked for)."""
    store = _general.init_store(1, device=device)
    store._gb_version = 0
    return GeneralBackendState(store, 0, {}, {}, {})


def _fork(state):
    """Replay the retained log up to the token's clock into a fresh
    store (applying to a held snapshot — the rare path). Causally
    buffered changes carry over: they were delivered, just not yet
    ready (dropping them would silently lose data — r5 review)."""
    try:
        changes = [c for c in state.store.get_missing_changes(0, {})
                   if c['seq'] <= state.clock.get(c['actor'], 0)]
    except ValueError as err:
        raise ValueError(
            'cannot branch from a stale token of a snapshot-resumed '
            'store: its pre-resume history is not replayable — '
            'continue from the newest token instead') from err
    changes += [c for _, c in state.store.queue]
    new = init(device=state.store.device)
    if changes:
        new, _ = apply_changes(new, changes)
    return new


def current_token(state):
    """The state itself if it is the store's newest token, else a fork
    of its lineage (undo history carried over) — readers that must see
    EXACTLY the token's history (undo capture, snapshots) call this
    before touching the shared columns."""
    if state._is_current():
        return state
    fork = _fork(state)
    fork.undo_pos = state.undo_pos
    fork.undo_stack = list(state.undo_stack)
    fork.redo_stack = list(state.redo_stack)
    return fork


def _advance_deps(deps, all_deps_tab, applied, pre_clock):
    """Fold the applied changes into the dependency frontier, in causal
    order, with the oracle's transitive-closure rule
    (backend/op_set.py:512-523, op_set.js:293-305)."""
    deps = dict(deps)
    clk = dict(pre_clock)
    pend = list(applied)
    while pend:
        progress = False
        rest = []
        for c in pend:
            actor, seq = c['actor'], c['seq']
            ready = seq == clk.get(actor, 0) + 1 and all(
                clk.get(a, 0) >= s for a, s in c['deps'].items())
            if not ready:
                rest.append(c)
                continue
            base = dict(c['deps'])
            base[actor] = seq - 1
            all_deps = {}
            for da, ds in base.items():
                trans = all_deps_tab.get((da, ds), {})
                for a, s in trans.items():
                    all_deps[a] = max(all_deps.get(a, 0), s)
                all_deps[da] = max(all_deps.get(da, 0), ds)
            all_deps.pop(None, None)
            deps = {a: s for a, s in deps.items()
                    if s > all_deps.get(a, 0)}
            deps[actor] = seq
            all_deps_this = dict(all_deps)
            all_deps_this[actor] = seq
            all_deps_tab[(actor, seq)] = all_deps_this
            clk[actor] = seq
            progress = True
        pend = rest
        if not progress:
            break
    return deps


def apply_changes(state, changes, options=None):
    """applyChanges through the bulk engine; returns
    (new token, reference-format patch)."""
    changes = list(changes)      # consumed more than once below
    orig = state                 # undo history survives a stale fork
    if not state._is_current():
        state = _fork(state)
    store = state.store
    pre_clock = dict(state.clock)
    pre_queue = [c for _, c in store.queue]
    block = store.encode_changes([changes])
    gpatch = _general.apply_general_block(store, block,
                                          options=options)
    clock = store.clock_of(0)
    applied = [c for c in changes + pre_queue
               if pre_clock.get(c['actor'], 0) < c['seq']
               <= clock.get(c['actor'], 0)]
    all_deps_tab = dict(state._all_deps)
    deps = _advance_deps(state.deps, all_deps_tab, applied, pre_clock)
    store._gb_version = state._version + 1
    new = GeneralBackendState(store, store._gb_version, clock, deps,
                              all_deps_tab)
    # local-change history carries across remote applies (the per-doc
    # backend and the reference both keep it) — from the CALLER's
    # token, which a stale fork must not reset. COPIED, matching
    # DeviceBackendState.clone's convention: a future in-place append
    # on either token must not corrupt the other's history.
    new.undo_pos = orig.undo_pos
    new.undo_stack = list(orig.undo_stack)
    new.redo_stack = list(orig.redo_stack)
    patch = {'clock': dict(clock), 'deps': dict(deps),
             'canUndo': new.undo_pos > 0,
             'canRedo': bool(new.redo_stack),
             'diffs': _LazyDiffs(gpatch)}
    return new, patch


class _LazyDiffs:
    """Diff list that materializes on first read: an ingestion
    pipeline (DocSet apply, merge loops) never pays the Python diff
    emission; a frontend iterating ``patch['diffs']`` pays exactly
    once. Survives dict copies (it is a value, not a missing key)."""

    __slots__ = ('_gpatch', '_diffs')

    def __init__(self, gpatch):
        self._gpatch = gpatch
        self._diffs = None

    def _mat(self):
        if self._diffs is None:
            self._diffs = self._gpatch.diffs(0)
            self._gpatch = None
        return self._diffs

    def __len__(self):
        return len(self._mat())

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __bool__(self):
        return bool(self._mat())

    def __eq__(self, other):
        return self._mat() == other

    def __repr__(self):
        return repr(self._mat())


def get_missing_changes(state, have_deps):
    """Served from the append-only retained log, filtered by the
    TOKEN's clock (old tokens never leak newer changes)."""
    out = state.store.get_missing_changes(0, dict(have_deps))
    clock = state.clock
    return [c for c in out if c['seq'] <= clock.get(c['actor'], 0)]


def get_changes_for_actor(state, for_actor, after_seq=0):
    return [c for c in get_missing_changes(state, {})
            if c['actor'] == for_actor and c['seq'] > after_seq]


def get_missing_deps(state):
    return state.store.get_missing_deps()


def to_device_state(state):
    """Convert (lazily, cached per token) to the per-doc
    DeviceBackendState on the token's device — the continuation path
    for local changes and undo/redo."""
    if state._device_state is None:
        from . import backend as DeviceBackend
        from ..config import Options
        no_route = Options(bulk_route_min_ops=None)  # else it loops
        dev = DeviceBackend.init(device=state.store.device)
        changes = get_missing_changes(state, {})
        if changes:
            dev, _ = DeviceBackend.apply_changes(dev, changes,
                                                 options=no_route)
        queued = [c for _, c in state.store.queue]
        if queued:
            dev, _ = DeviceBackend.apply_changes(dev, queued,
                                                 options=no_route)
        state._device_state = dev
    return state._device_state


# native-view switch: None = auto (use the C++ view gather when the
# library loads), False = numpy only, True = REQUIRE native (tests:
# fail loudly instead of silently falling back) — the read-side twin
# of general._NATIVE_STAGING
_NATIVE_VIEW = None


def winner_select(field, rank):
    """The batched read path's winner index: one stable sort of the
    packed ``(obj_row << 32) | key`` field keys plus a per-segment
    winner pick. Returns ``(fields, winner_pos)`` — the sorted distinct
    field keys and, per field, the position IN THE INPUT ARRAYS of its
    winning entry (max actor string rank = op_set.js:211's highest
    actor; first-in-entry-order on ties = the stable first-applied
    tie-break ``doc_fields_sorted`` implements per doc).

    Runs on the native gather (``amst_view_winners``) when available;
    the numpy path below is the byte-identical fallback."""
    n = len(field)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if _NATIVE_VIEW is not False:
        from .. import native as _amnative
        out = _amnative.view_winners(field, rank)
        if out is not None:
            return out
    if _NATIVE_VIEW is True:
        raise RuntimeError('native view path required but unavailable')
    order = np.argsort(field, kind='stable')
    fs = field[order]
    bnd = np.empty(n, bool)
    bnd[0] = True
    bnd[1:] = fs[1:] != fs[:-1]
    starts = np.flatnonzero(bnd)
    seg = np.cumsum(bnd) - 1
    r = rank[order]
    seg_max = np.maximum.reduceat(r, starts)
    # first max-rank row of each segment; within a segment the stable
    # field sort preserved entry order, so min position = first applied
    cand = np.where(r == seg_max[seg], np.arange(n), n)
    winner_pos = order[np.minimum.reduceat(cand, starts)]
    return fs[starts], winner_pos


def visible_walk(pool, objs):
    """Visible elements of ALL of ``objs`` (ascending sequence object
    rows) in one sweep: returns ``(seg, local, counts)`` where ``seg``
    names the object (index into ``objs``), ``local`` the node's local
    index, both grouped per object in document (vis_index) order, and
    ``counts[k]`` the visible length of ``objs[k]`` — the fleet-wide
    generalization of :func:`visible_seq_rows` (requires
    ``pool.sync()``). Native (``amst_view_walk``) when available; the
    numpy path is the byte-identical fallback."""
    n_objs = len(objs)
    if n_objs == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    if _NATIVE_VIEW is not False:
        from .. import native as _amnative
        out = _amnative.view_walk(objs, pool)
        if out is not None:
            return out
    if _NATIVE_VIEW is True:
        raise RuntimeError('native view path required but unavailable')
    prows, counts_n = pool.rows_of_objs(objs)
    seg_all = np.repeat(np.arange(n_objs, dtype=np.int64), counts_n)
    vis = pool.visible[prows]
    seg_v = seg_all[vis]
    loc_v = pool.local[prows[vis]].astype(np.int64)
    # the resident order is already materialized as a DENSE rank per
    # object (vis_index = 0..count-1), so the walk is one O(n)
    # scatter to position — byte-identical to the old composite
    # argsort, without the O(n log n) sort
    counts = np.bincount(seg_v, minlength=n_objs).astype(np.int64)
    starts = np.zeros(n_objs + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    tgt = starts[seg_v] + pool.vis_index[prows[vis]]
    out_seg = np.empty(len(seg_v), np.int64)
    out_loc = np.empty(len(loc_v), np.int64)
    out_seg[tgt] = seg_v
    out_loc[tgt] = loc_v
    return out_seg, out_loc, counts


def doc_fields_sorted(store, idx, rows=None):
    """{packed field key: [entry rows, winner first]} for one document
    — entries sorted STABLE actor-descending (op_set.js:211: winner =
    highest actor string, first-applied on ties). The one shared
    reading of the conflict-winner rule (get_patch, DocSet
    materialization)."""
    if rows is None:
        rows = np.flatnonzero(store.e_doc == idx)
    by_field = {}
    for j in (rows.tolist() if hasattr(rows, 'tolist') else rows):
        fkey = (int(store.e_obj[j]) << 32) | int(store.e_key[j])
        by_field.setdefault(fkey, []).append(j)
    for js in by_field.values():
        js.sort(key=lambda j: store.actors[store.e_actor[j]],
                reverse=True)
    return by_field


def visible_seq_rows(store, obj_row):
    """Pool rows of one sequence object's VISIBLE elements, in
    document order (requires pool.sync())."""
    pool = store.pool
    prows, _ = pool.rows_of_objs(np.asarray([obj_row]))
    vis = pool.visible[prows]
    order = np.argsort(pool.vis_index[prows][vis])
    return prows[vis][order]


def get_patch(state):
    """Whole-document patch from empty — create diffs child-first,
    then sets/inserts (parity with device backend get_patch,
    backend/index.js:201-207), built from the store columns."""
    store = state.store
    store._commit_pending()
    store.pool.sync()
    if not state._is_current():
        # historical token: replay through the per-doc backend; the
        # undo flags are the TOKEN's (the replayed state has none)
        from . import backend as DeviceBackend
        p = DeviceBackend.get_patch(to_device_state(state))
        p['canUndo'] = state.undo_pos > 0
        p['canRedo'] = bool(state.redo_stack)
        return p
    root = int(store._root_row[0]) if len(store._root_row) else -1
    diffs = []
    if root < 0:
        return {'clock': dict(state.clock), 'deps': dict(state.deps),
                'canUndo': state.undo_pos > 0,
                'canRedo': bool(state.redo_stack), 'diffs': diffs}

    by_field = doc_fields_sorted(store, 0)

    def value_link(j):
        if store.e_link[j]:
            return store.values[store.e_value[j]], True
        v = store.e_value[j]
        return (store.values[v] if v >= 0 else None), False

    emitted = set()

    def emit_object(obj_row):
        if obj_row in emitted:
            return
        emitted.add(obj_row)
        t = store.obj_type[obj_row]
        uuid = store.obj_uuid[obj_row]
        if t != _TYPE_MAP:
            # sequence create carries maxElem (parity with the per-doc
            # backend's get_patch emission)
            diffs.append({'action': 'create', 'obj': uuid,
                          'type': _TYPE_NAME[t],
                          'maxElem': int(
                              store.pool.max_elem_of[obj_row])})
        elif uuid != ROOT_ID:
            diffs.append({'action': 'create', 'obj': uuid,
                          'type': 'map'})
        if t == _TYPE_MAP:
            for fkey in sorted(k for k in by_field
                               if (k >> 32) == obj_row
                               and not (k & _ELEM_BIT)):
                js = by_field[fkey]          # winner first (sorted)
                # children first
                for j in js:
                    if store.e_link[j]:
                        row = store.obj_of.get(
                            (0, store.values[store.e_value[j]]))
                        if row is not None:
                            emit_object(row)
                w = js[0]
                value, link = value_link(w)
                edit = {'action': 'set', 'type': 'map', 'obj': uuid,
                        'key': store.keys[fkey & 0x7FFFFFFF],
                        'value': value}
                if link:
                    edit['link'] = True
                if len(js) > 1:
                    edit['conflicts'] = _conflicts(store, js[1:])
                diffs.append(edit)
            return
        # sequence: visible inserts in document order
        pool = store.pool
        vrows = visible_seq_rows(store, obj_row)
        for idx, r in enumerate(vrows.tolist()):
            node = int(pool.local[r])
            js = by_field.get(
                (obj_row << 32) | _ELEM_BIT | node, [])
            for j in js:
                if store.e_link[j]:
                    row = store.obj_of.get(
                        (0, store.values[store.e_value[j]]))
                    if row is not None:
                        emit_object(row)
            elem_id = (f'{store.actors[pool.actor[r]]}:'
                       f'{int(pool.elemc[r])}')
            edit = {'action': 'insert', 'type': _TYPE_NAME[t],
                    'obj': uuid, 'index': idx, 'elemId': elem_id}
            if js:
                w = js[0]
                value, link = value_link(w)
                edit['value'] = value
                if link:
                    edit['link'] = True
                if len(js) > 1:
                    edit['conflicts'] = _conflicts(store, js[1:])
            else:
                edit['value'] = None
            diffs.append(edit)

    emit_object(root)
    return {'clock': dict(state.clock), 'deps': dict(state.deps),
            'canUndo': state.undo_pos > 0,
            'canRedo': bool(state.redo_stack), 'diffs': diffs}


def _conflicts(store, js):
    out = []
    for j in js:
        v = store.e_value[j]
        entry = {'actor': store.actors[store.e_actor[j]],
                 'value': store.values[v] if v >= 0 else None}
        if store.e_link[j]:
            entry['link'] = True
        out.append(entry)
    return out
