"""Host-side CRDT engine ("OpSet") with exact reference semantics.

This module is the semantics oracle for the framework: change JSON in,
patch/diff JSON out, byte-compatible with the reference engine
(reference ``backend/op_set.js``). The PyTorch port's copy of
``automerge_tpu/backend/op_set.py``: the per-doc device backend
(:mod:`automerge_tpu_torch.device.backend`) is differentially tested
against it and shares its change-log and causality helpers; this oracle
owns the incremental single-change path and all recursive/host-only
logic (materialization, string keys, nested object graphs).

Design notes (how this differs structurally from the reference):

* The reference stores everything in one Immutable.js map with persistent
  structural sharing.  Here an :class:`OpSet` is a snapshot object using
  *append-only sharing*: per-actor change logs and the history log are
  shared grow-only lists with a per-snapshot visible length, and object
  records are copy-on-write cloned at most once per apply session.  Old
  snapshots (old document versions) stay valid, which the public API
  relies on (``diff(old_doc, new_doc)``, ``getChanges``).
* Field-op lists are treated as immutable values: they are replaced, never
  mutated, so clones can share them.

Key semantic anchors (reference citations):

* concurrency test          -> op_set.js:7-16
* causal readiness          -> op_set.js:20-27
* transitive deps           -> op_set.js:29-37
* make/ins/assign handlers  -> op_set.js:63-219
* conflict ordering         -> op_set.js:211 (sort by actor, descending)
* queued fixed-point apply  -> op_set.js:267-283
* insertion-tree ordering   -> op_set.js:371-425 (Lamport-descending RGA)
"""

import re

from ..common import ROOT_ID
from ..native import make_seq_index, clone_index

_ELEMID_RE = re.compile(r'^(.*):(\d+)$')


def lamport_compare(op1, op2):
    """Order by (elem, actor); reference op_set.js:371-377."""
    if op1['elem'] < op2['elem']:
        return -1
    if op1['elem'] > op2['elem']:
        return 1
    if op1['actor'] < op2['actor']:
        return -1
    if op1['actor'] > op2['actor']:
        return 1
    return 0


class ObjectRecord:
    """Per-object CRDT state: field ops, insertion tree, sequence index.

    Mirrors the per-object entry in the reference's ``byObject`` map
    (op_set.js:63-93,180-219): ``fields`` maps key/elemId -> ops (winner
    first), ``following`` is the insertion tree adjacency, ``insertion``
    maps elemId -> its 'ins' op, ``elem_ids`` is the order-statistic index
    (visible elements in document order).
    """

    __slots__ = ('init_action', 'inbound', 'fields', 'following',
                 'insertion', 'max_elem', 'elem_ids')

    SEQUENCE_ACTIONS = ('makeList', 'makeText')

    def __init__(self, init_action=None):
        self.init_action = init_action          # 'makeMap'/'makeList'/'makeText'/None(root)
        self.inbound = []                       # list of link ops referencing this object
        self.fields = {}                        # key -> list of ops (winner first)
        self.following = {}                     # parent elemId/'_head' -> list of 'ins' ops
        self.insertion = {}                     # elemId -> 'ins' op
        self.max_elem = 0
        # Visible elemIds in document order. For sequences this is the
        # order-statistic index — natively a C++ skip list with O(1) COW
        # snapshots (native.py), matching the role of skip_list.js; plain
        # list fallback when the native library is unavailable.
        self.elem_ids = (make_seq_index()
                         if init_action in self.SEQUENCE_ACTIONS else [])

    def clone(self):
        rec = ObjectRecord.__new__(ObjectRecord)  # skip __init__: elem_ids
        rec.init_action = self.init_action        # comes from the snapshot
        rec.inbound = list(self.inbound)
        rec.fields = dict(self.fields)          # op lists are shared (immutable by convention)
        rec.following = dict(self.following)
        rec.insertion = dict(self.insertion)
        rec.max_elem = self.max_elem
        rec.elem_ids = clone_index(self.elem_ids)
        return rec

    def is_sequence(self):
        return self.init_action in self.SEQUENCE_ACTIONS


class SharedChangeLog:
    """Append-only shared change log with per-snapshot visible lengths.

    Mixed into both the host :class:`OpSet` and the device backend state
    (:class:`automerge_tpu_torch.device.backend.DeviceBackendState`): the host
    class must define ``states``, ``state_lens``, ``history`` and
    ``history_len``. Old snapshots stay valid after a successor appends —
    a snapshot sees only its recorded visible length, and a divergent
    sibling branches a private copy of the log.
    """

    __slots__ = ()

    def actor_states(self, actor):
        return self.states.get(actor, []), self.state_lens.get(actor, 0)

    def actor_state(self, actor, index):
        lst, n = self.actor_states(actor)
        if index < 0 or index >= n:
            return None
        return lst[index]

    def _append_state(self, actor, entry):
        lst, n = self.actor_states(actor)
        if len(lst) != n:
            # A sibling snapshot extended this log differently; branch a copy.
            lst = lst[:n]
        if actor not in self.states or lst is not self.states[actor]:
            self.states[actor] = lst
        lst.append(entry)
        self.state_lens[actor] = n + 1

    def _append_history(self, change):
        if len(self.history) != self.history_len:
            self.history = self.history[:self.history_len]
        self.history.append(change)
        self.history_len += 1

    def get_history(self):
        return self.history[:self.history_len]


class OpSet(SharedChangeLog):
    """One snapshot of the CRDT engine state (reference op_set.js:298-310)."""

    __slots__ = ('states', 'state_lens', 'history', 'history_len',
                 'by_object', 'clock', 'deps', 'queue',
                 'undo_pos', 'undo_stack', 'redo_stack', 'undo_local',
                 '_owned')

    def __init__(self):
        self.states = {}            # actor -> grow-only list of {'change','all_deps'}
        self.state_lens = {}        # actor -> visible length in this snapshot
        self.history = []           # grow-only list of changes
        self.history_len = 0
        self.by_object = {ROOT_ID: ObjectRecord(None)}
        self.clock = {}             # actor -> seq
        self.deps = {}              # actor -> seq (current frontier heads)
        self.queue = []             # causally-unready buffered changes
        self.undo_pos = 0
        self.undo_stack = []        # list of op-lists
        self.redo_stack = []
        self.undo_local = None      # op accumulation during an undoable apply
        self._owned = {ROOT_ID}     # objectIds whose records are private to this snapshot

    # -- snapshot management ------------------------------------------------

    def clone(self):
        new = OpSet.__new__(OpSet)
        new.states = dict(self.states)
        new.state_lens = dict(self.state_lens)
        new.history = self.history
        new.history_len = self.history_len
        new.by_object = dict(self.by_object)
        new.clock = dict(self.clock)
        new.deps = dict(self.deps)
        new.queue = list(self.queue)
        new.undo_pos = self.undo_pos
        new.undo_stack = list(self.undo_stack)
        new.redo_stack = list(self.redo_stack)
        new.undo_local = None
        new._owned = set()
        return new

    def _writable(self, object_id):
        """Copy-on-write access to an object record (cloned once per snapshot)."""
        if object_id not in self._owned:
            self.by_object[object_id] = self.by_object[object_id].clone()
            self._owned.add(object_id)
        return self.by_object[object_id]


# -- causality helpers ------------------------------------------------------

def is_concurrent(op_set, op1, op2):
    """True if neither op happened-before the other (op_set.js:7-16)."""
    actor1, seq1 = op1.get('actor'), op1.get('seq')
    actor2, seq2 = op2.get('actor'), op2.get('seq')
    if not actor1 or not actor2 or not seq1 or not seq2:
        return False
    clock1 = op_set.actor_state(actor1, seq1 - 1)['all_deps']
    clock2 = op_set.actor_state(actor2, seq2 - 1)['all_deps']
    return clock1.get(actor2, 0) < seq2 and clock2.get(actor1, 0) < seq1


def causally_ready(op_set, change):
    """All causal predecessors already applied? (op_set.js:20-27)"""
    deps = dict(change['deps'])
    deps[change['actor']] = change['seq'] - 1
    return all(op_set.clock.get(actor, 0) >= seq for actor, seq in deps.items())


def transitive_deps(op_set, base_deps):
    """Transitive closure of a deps map (op_set.js:29-37)."""
    deps = {}
    for dep_actor, dep_seq in base_deps.items():
        if dep_seq <= 0:
            continue
        # An unknown actor contributes no transitive deps but keeps its own
        # entry (the reference merges an absent lookup as an empty clock).
        entry = op_set.actor_state(dep_actor, dep_seq - 1)
        transitive = entry['all_deps'] if entry else {}
        for actor, seq in transitive.items():
            deps[actor] = max(deps.get(actor, 0), seq)
        deps[dep_actor] = dep_seq
    return deps


# -- object-graph helpers ---------------------------------------------------

def get_path(op_set, object_id):
    """Path of keys/indexes from root to object, or None (op_set.js:43-60)."""
    path = []
    while object_id != ROOT_ID:
        rec = op_set.by_object.get(object_id)
        if rec is None or not rec.inbound:
            return None
        ref = rec.inbound[0]
        object_id = ref['obj']
        parent = op_set.by_object[object_id]
        if parent.is_sequence():
            try:
                index = parent.elem_ids.index(ref['key'])
            except ValueError:
                return None
            path.insert(0, index)
        else:
            path.insert(0, ref['key'])
    return path


def get_field_ops(op_set, object_id, key):
    rec = op_set.by_object.get(object_id)
    if rec is None:
        return []
    return rec.fields.get(key, [])


def get_parent(op_set, object_id, key):
    """Parent elemId in the insertion tree (op_set.js:364-369)."""
    if key == '_head':
        return None
    insertion = op_set.by_object[object_id].insertion.get(key)
    if insertion is None:
        raise TypeError('Missing index entry for list element ' + key)
    return insertion['key']


def insertions_after(op_set, object_id, parent_id, child_id=None):
    """Children of parent_id in Lamport-descending order (op_set.js:379-390).

    lamport_compare orders by (elem, actor), which is exactly Python tuple
    comparison, so a key-based sort suffices (no cmp_to_key in this hot path).
    """
    child_key = None
    if child_id:
        match = _ELEMID_RE.match(child_id)
        if match:
            child_key = (int(match.group(2)), match.group(1))

    ops = [op for op in op_set.by_object[object_id].following.get(parent_id, [])
           if op['action'] == 'ins']
    if child_key is not None:
        ops = [op for op in ops if (op['elem'], op['actor']) < child_key]
    ops.sort(key=lambda op: (op['elem'], op['actor']), reverse=True)
    return [f"{op['actor']}:{op['elem']}" for op in ops]


def get_next(op_set, object_id, key):
    """Successor in document order (op_set.js:392-404)."""
    children = insertions_after(op_set, object_id, key)
    if children:
        return children[0]
    while True:
        ancestor = get_parent(op_set, object_id, key)
        if not ancestor:
            return None
        siblings = insertions_after(op_set, object_id, ancestor, key)
        if siblings:
            return siblings[0]
        key = ancestor


def get_previous(op_set, object_id, key):
    """Predecessor in document order, or None at head (op_set.js:408-425)."""
    parent_id = get_parent(op_set, object_id, key)
    children = insertions_after(op_set, object_id, parent_id if parent_id else '_head')
    if children and children[0] == key:
        return None if (parent_id is None or parent_id == '_head') else parent_id

    prev_id = None
    for child in children:
        if child == key:
            break
        prev_id = child
    while True:
        children = insertions_after(op_set, object_id, prev_id)
        if not children:
            return prev_id
        prev_id = children[-1]


# -- op application ---------------------------------------------------------

def _apply_make(op_set, op):
    """'makeMap'/'makeList'/'makeText' (op_set.js:63-78)."""
    object_id = op['obj']
    if object_id in op_set.by_object:
        raise ValueError('Duplicate creation of object ' + object_id)

    edit = {'action': 'create', 'obj': object_id}
    if op['action'] == 'makeMap':
        edit['type'] = 'map'
    else:
        edit['type'] = 'text' if op['action'] == 'makeText' else 'list'

    op_set.by_object[object_id] = ObjectRecord(op['action'])
    op_set._owned.add(object_id)
    return [edit]


def _apply_insert(op_set, op):
    """'ins': register in the insertion tree; no visible diff (op_set.js:83-93)."""
    object_id, elem = op['obj'], op['elem']
    elem_id = f"{op['actor']}:{elem}"
    if object_id not in op_set.by_object:
        raise ValueError('Modification of unknown object ' + object_id)
    rec = op_set._writable(object_id)
    if elem_id in rec.insertion:
        raise ValueError('Duplicate list element ID ' + elem_id)

    rec.following[op['key']] = rec.following.get(op['key'], []) + [op]
    rec.max_elem = max(elem, rec.max_elem)
    rec.insertion[elem_id] = op
    return []


def _get_conflicts(ops):
    """Conflict entries for all non-winning ops (op_set.js:95-103)."""
    conflicts = []
    for op in ops[1:]:
        conflict = {'actor': op['actor'], 'value': op.get('value')}
        if op['action'] == 'link':
            conflict['link'] = True
        conflicts.append(conflict)
    return conflicts


def _patch_list(op_set, object_id, index, elem_id, action, ops):
    """Sequence-index maintenance + list diff emission (op_set.js:105-130)."""
    rec = op_set._writable(object_id)
    obj_type = 'text' if rec.init_action == 'makeText' else 'list'
    first_op = ops[0] if ops else None
    edit = {'action': action, 'type': obj_type, 'obj': object_id,
            'index': index, 'path': get_path(op_set, object_id)}
    if first_op and first_op['action'] == 'link':
        edit['link'] = True

    if action == 'insert':
        rec.elem_ids.insert(index, first_op['key'])
        edit['elemId'] = elem_id
        edit['value'] = first_op.get('value')
    elif action == 'set':
        edit['value'] = first_op.get('value')
    elif action == 'remove':
        del rec.elem_ids[index]
    else:
        raise ValueError('Unknown action type: ' + action)

    if ops and len(ops) > 1:
        edit['conflicts'] = _get_conflicts(ops)
    return [edit]


def _update_list_element(op_set, object_id, elem_id):
    """Re-derive the visible state of one list element (op_set.js:132-159)."""
    ops = get_field_ops(op_set, object_id, elem_id)
    elem_ids = op_set.by_object[object_id].elem_ids
    try:
        index = elem_ids.index(elem_id)
    except ValueError:
        index = -1

    if index >= 0:
        if not ops:
            return _patch_list(op_set, object_id, index, elem_id, 'remove', None)
        return _patch_list(op_set, object_id, index, elem_id, 'set', ops)

    if not ops:
        return []  # deleting a non-existent element = no-op

    # find the index of the closest preceding visible list element
    prev_id = elem_id
    while True:
        index = -1
        prev_id = get_previous(op_set, object_id, prev_id)
        if not prev_id:
            break
        try:
            index = elem_ids.index(prev_id)
        except ValueError:
            index = -1
        if index >= 0:
            break
    return _patch_list(op_set, object_id, index + 1, elem_id, 'insert', ops)


def _update_map_key(op_set, object_id, key):
    """Map-key diff after assignment resolution (op_set.js:161-177)."""
    ops = get_field_ops(op_set, object_id, key)
    edit = {'action': '', 'type': 'map', 'obj': object_id, 'key': key,
            'path': get_path(op_set, object_id)}
    if not ops:
        edit['action'] = 'remove'
    else:
        edit['action'] = 'set'
        edit['value'] = ops[0].get('value')
        if ops[0]['action'] == 'link':
            edit['link'] = True
        if len(ops) > 1:
            edit['conflicts'] = _get_conflicts(ops)
    return [edit]


def _apply_assign(op_set, op, top_level):
    """'set'/'del'/'link': concurrency partition + conflict resolution
    (op_set.js:180-219). Winners are ordered actor-descending (op_set.js:211).
    """
    object_id = op['obj']
    if object_id not in op_set.by_object:
        raise ValueError('Modification of unknown object ' + object_id)
    rec = op_set._writable(object_id)
    obj_type = rec.init_action

    if op_set.undo_local is not None and top_level:
        undo_ops = [{k: v for k, v in prior.items()
                     if k in ('action', 'obj', 'key', 'value')}
                    for prior in rec.fields.get(op['key'], [])]
        if not undo_ops:
            undo_ops = [{'action': 'del', 'obj': object_id, 'key': op['key']}]
        op_set.undo_local = op_set.undo_local + undo_ops

    prior = rec.fields.get(op['key'], [])
    overwritten = [other for other in prior if not is_concurrent(op_set, other, op)]
    remaining = [other for other in prior if is_concurrent(op_set, other, op)]

    # Overwritten links leave the inbound index of their target
    for old in overwritten:
        if old['action'] == 'link':
            target = op_set._writable(old['value'])
            target.inbound = [ref for ref in target.inbound if ref != old]

    if op['action'] == 'link':
        target = op_set._writable(op['value'])
        if op not in target.inbound:
            target.inbound = target.inbound + [op]
    if op['action'] != 'del':
        remaining = remaining + [op]
    remaining = sorted(remaining, key=lambda o: o['actor'], reverse=True)
    rec.fields[op['key']] = remaining

    if obj_type in ('makeList', 'makeText'):
        return _update_list_element(op_set, object_id, op['key'])
    return _update_map_key(op_set, object_id, op['key'])


def _apply_ops(op_set, ops):
    """Dispatch one change's ops (op_set.js:221-238)."""
    all_diffs, new_objects = [], set()
    for op in ops:
        action = op['action']
        if action in ('makeMap', 'makeList', 'makeText'):
            new_objects.add(op['obj'])
            diffs = _apply_make(op_set, op)
        elif action == 'ins':
            diffs = _apply_insert(op_set, op)
        elif action in ('set', 'del', 'link'):
            diffs = _apply_assign(op_set, op, op['obj'] not in new_objects)
        else:
            raise ValueError(f'Unknown operation type {action}')
        all_diffs.extend(diffs)
    return all_diffs


def _apply_change(op_set, change):
    """Apply one causally-ready change (op_set.js:240-265)."""
    actor, seq = change['actor'], change['seq']
    _, prior_len = op_set.actor_states(actor)
    if seq <= prior_len:
        if op_set.actor_state(actor, seq - 1)['change'] != change:
            raise ValueError(f'Inconsistent reuse of sequence number {seq} by {actor}')
        return []  # change already applied

    base_deps = dict(change['deps'])
    base_deps[actor] = seq - 1
    all_deps = transitive_deps(op_set, base_deps)
    op_set._append_state(actor, {'change': change, 'all_deps': all_deps})

    ops = [{**op, 'actor': actor, 'seq': seq} for op in change['ops']]
    diffs = _apply_ops(op_set, ops)

    remaining_deps = {dep_actor: dep_seq for dep_actor, dep_seq in op_set.deps.items()
                      if dep_seq > all_deps.get(dep_actor, 0)}
    remaining_deps[actor] = seq
    op_set.deps = remaining_deps
    op_set.clock[actor] = seq
    op_set._append_history(change)
    return diffs


def apply_queued_ops(op_set):
    """Fixed-point causal delivery over the buffer (op_set.js:267-283)."""
    diffs = []
    while True:
        queue = []
        for change in op_set.queue:
            if causally_ready(op_set, change):
                diffs.extend(_apply_change(op_set, change))
            else:
                queue.append(change)
        if len(queue) == len(op_set.queue):
            return diffs
        op_set.queue = queue


def _push_undo_history(op_set):
    """Record captured inverse ops on the undo stack (op_set.js:285-296)."""
    op_set.undo_stack = op_set.undo_stack[:op_set.undo_pos] + [op_set.undo_local]
    op_set.undo_pos += 1
    op_set.redo_stack = []
    op_set.undo_local = None


def init():
    return OpSet()


def add_change(op_set, change, is_undoable):
    """Queue + deliver one change; optionally capture undo ops
    (op_set.js:312-325). Mutates `op_set` (callers clone snapshots first).
    """
    op_set.queue = op_set.queue + [change]
    if is_undoable:
        op_set.undo_local = []
        diffs = apply_queued_ops(op_set)
        _push_undo_history(op_set)
        return diffs
    return apply_queued_ops(op_set)


# -- change-log queries -----------------------------------------------------

def get_missing_changes(op_set, have_deps):
    """Changes the peer with clock `have_deps` lacks (op_set.js:327-334)."""
    all_deps = transitive_deps(op_set, dict(have_deps))
    changes = []
    for actor in op_set.states:
        lst, n = op_set.actor_states(actor)
        for entry in lst[all_deps.get(actor, 0):n]:
            changes.append(entry['change'])
    return changes


def get_changes_for_actor(op_set, for_actor, after_seq=0):
    lst, n = op_set.actor_states(for_actor)
    return [entry['change'] for entry in lst[after_seq:n]]


def get_missing_deps(op_set):
    """Aggregate unmet dependencies of the queued changes (op_set.js:347-358)."""
    missing = {}
    for change in op_set.queue:
        deps = dict(change['deps'])
        deps[change['actor']] = change['seq'] - 1
        for dep_actor, dep_seq in deps.items():
            if op_set.clock.get(dep_actor, 0) < dep_seq:
                missing[dep_actor] = max(dep_seq, missing.get(dep_actor, 0))
    return missing


# -- document queries (used by materialization) -----------------------------

def _valid_field_name(key):
    return isinstance(key, str) and key != '' and not key.startswith('_')


def get_object_fields(op_set, object_id):
    rec = op_set.by_object[object_id]
    return [key for key, ops in rec.fields.items()
            if _valid_field_name(key) and ops]


def _get_op_value(op_set, op, context):
    if op['action'] == 'set':
        return op.get('value')
    if op['action'] == 'link':
        return context.instantiate_object(op_set, op['value'])
    return None


def get_object_field(op_set, object_id, key, context):
    if not _valid_field_name(key):
        return None
    ops = get_field_ops(op_set, object_id, key)
    if ops:
        return _get_op_value(op_set, ops[0], context)
    return None


def get_object_conflicts(op_set, object_id, context):
    """Per-key actor->value maps for multiply-assigned fields (op_set.js:456-462)."""
    rec = op_set.by_object[object_id]
    conflicts = {}
    for key, ops in rec.fields.items():
        if _valid_field_name(key) and len(ops) > 1:
            conflicts[key] = {op['actor']: _get_op_value(op_set, op, context)
                              for op in ops[1:]}
    return conflicts


def list_elem_by_index(op_set, object_id, index, context):
    rec = op_set.by_object[object_id]
    if 0 <= index < len(rec.elem_ids):
        ops = get_field_ops(op_set, object_id, rec.elem_ids[index])
        if ops:
            return _get_op_value(op_set, ops[0], context)
    return None


def list_length(op_set, object_id):
    return len(op_set.by_object[object_id].elem_ids)


def list_iterator(op_set, list_id, mode, context):
    """Walk visible elements in document order (op_set.js:476-507)."""
    elem, index = '_head', -1
    while True:
        elem = get_next(op_set, list_id, elem)
        if not elem:
            return
        ops = get_field_ops(op_set, list_id, elem)
        if not ops:
            continue
        value = _get_op_value(op_set, ops[0], context)
        index += 1
        if mode == 'keys':
            yield index
        elif mode == 'values':
            yield value
        elif mode == 'entries':
            yield (index, value)
        elif mode == 'elems':
            yield (index, elem)
        elif mode == 'conflicts':
            conflict = None
            if len(ops) > 1:
                conflict = {op['actor']: _get_op_value(op_set, op, context)
                            for op in ops[1:]}
            yield conflict
