"""Backend facade: state management, change application, patch construction.

Parity with the reference's ``backend/index.js`` — the public surface is
``init, apply_changes, apply_local_change, get_patch, get_changes,
get_changes_for_actor, get_missing_changes, get_missing_deps, merge``
(backend/index.js:310-313), plus the undo/redo executors. camelCase
aliases are exported for users coming from the reference API.

The state handed out here is a :class:`BackendState` snapshot wrapping an
:class:`~automerge_tpu_torch.backend.op_set.OpSet`; every apply produces a new
snapshot and old ones remain valid (persistent semantics, like the
reference's Immutable.js state). The PyTorch port's copy of
``automerge_tpu/backend/__init__.py``: pure host code.
"""

from ..common import ROOT_ID, is_object, less_or_equal
from ..utils.metrics import metrics
from . import op_set as OpSet


class BackendState:
    """Immutable-by-convention snapshot of the backend."""

    __slots__ = ('op_set',)

    def __init__(self, op_set):
        self.op_set = op_set

    @property
    def clock(self):
        """Uniform clock accessor shared with the device backend state, so
        protocol layers (Connection) need no per-backend special cases."""
        return self.op_set.clock


class MaterializationContext:
    """Builds the diff list that instantiates a whole document tree
    (backend/index.js:5-117). Children are emitted before parents so the
    frontend can resolve links as it applies the patch."""

    def __init__(self):
        self.diffs = {}
        self.children = {}

    def _unpack_value(self, parent_id, diff, value):
        if isinstance(value, dict) and 'objectId' in value:
            diff['value'] = value['objectId']
            diff['link'] = True
            self.children[parent_id].append(value['objectId'])
        else:
            diff['value'] = value

    def _unpack_conflicts(self, parent_id, diff, conflicts):
        if conflicts:
            diff['conflicts'] = []
            for actor, value in conflicts.items():
                conflict = {'actor': actor}
                self._unpack_value(parent_id, conflict, value)
                diff['conflicts'].append(conflict)

    def _instantiate_map(self, ops, object_id):
        diffs = self.diffs[object_id]
        if object_id != ROOT_ID:
            diffs.append({'obj': object_id, 'type': 'map', 'action': 'create'})

        conflicts = OpSet.get_object_conflicts(ops, object_id, self)
        for key in OpSet.get_object_fields(ops, object_id):
            diff = {'obj': object_id, 'type': 'map', 'action': 'set', 'key': key}
            self._unpack_value(object_id, diff, OpSet.get_object_field(ops, object_id, key, self))
            self._unpack_conflicts(object_id, diff, conflicts.get(key))
            diffs.append(diff)

    def _instantiate_list(self, ops, object_id, obj_type):
        diffs = self.diffs[object_id]
        # maxElem rides on the create diff: visible inserts alone
        # under-count it when the highest-counter element is a tombstone,
        # and a frontend resuming from this patch would mint colliding
        # elemIds. (The reference omits this and has that latent bug.)
        diffs.append({'obj': object_id, 'type': obj_type, 'action': 'create',
                      'maxElem': ops.by_object[object_id].max_elem})

        conflicts = OpSet.list_iterator(ops, object_id, 'conflicts', self)
        values = OpSet.list_iterator(ops, object_id, 'values', self)
        for index, elem_id in OpSet.list_iterator(ops, object_id, 'elems', self):
            diff = {'obj': object_id, 'type': obj_type, 'action': 'insert',
                    'index': index, 'elemId': elem_id}
            self._unpack_value(object_id, diff, next(values))
            self._unpack_conflicts(object_id, diff, next(conflicts))
            diffs.append(diff)

    def instantiate_object(self, ops, object_id):
        if object_id in self.diffs:
            return {'objectId': object_id}

        obj_type = ops.by_object[object_id].init_action
        self.diffs[object_id] = []
        self.children[object_id] = []

        if object_id == ROOT_ID or obj_type == 'makeMap':
            self._instantiate_map(ops, object_id)
        elif obj_type == 'makeList':
            self._instantiate_list(ops, object_id, 'list')
        elif obj_type == 'makeText':
            self._instantiate_list(ops, object_id, 'text')
        else:
            raise ValueError(f'Unknown object type: {obj_type}')
        return {'objectId': object_id}

    def make_patch(self, object_id, diffs):
        for child_id in self.children[object_id]:
            self.make_patch(child_id, diffs)
        diffs.extend(self.diffs[object_id])


def init(_actor_id=None):
    """Empty backend state (backend/index.js:123-125). The optional actor
    argument is accepted for reference-API compatibility and ignored."""
    return BackendState(OpSet.init())


def _make_patch(state, diffs):
    ops = state.op_set
    return {'clock': dict(ops.clock), 'deps': dict(ops.deps),
            'canUndo': ops.undo_pos > 0, 'canRedo': bool(ops.redo_stack),
            'diffs': diffs}


def _normalize_change(change):
    return {k: v for k, v in change.items() if k != 'requestType'}


def _apply(state, changes, undoable):
    ops = state.op_set.clone()
    diffs = []
    n_ops = 0
    for change in changes:
        n_ops += len(change.get('ops', []))
        diffs.extend(OpSet.add_change(ops, _normalize_change(change), undoable))
    state = BackendState(ops)

    m = metrics
    m.bump('changes_applied', len(changes))
    m.bump('ops_applied', n_ops)
    m.bump('conflicts_detected',
           sum(1 for d in diffs if d.get('conflicts')))
    m.set_gauge('queue_depth', len(ops.queue))
    if m.active:
        m.emit('apply', changes=len(changes), ops=n_ops, diffs=len(diffs),
               queued=len(ops.queue), undoable=undoable)
    return state, _make_patch(state, diffs)


def apply_changes(state, changes):
    """Apply remote changes; returns (state, patch) (backend/index.js:161-163)."""
    return _apply(state, changes, False)


def apply_local_change(state, change):
    """Apply one local change request, recording undo history
    (backend/index.js:173-195)."""
    if not isinstance(change.get('actor'), str) or not isinstance(change.get('seq'), int):
        raise TypeError('Change request requires `actor` and `seq` properties')
    if change['seq'] <= state.op_set.clock.get(change['actor'], 0):
        raise ValueError('Change request has already been applied')

    request_type = change.get('requestType')
    if request_type == 'change':
        state, patch = _apply(state, [change], True)
    elif request_type == 'undo':
        state, patch = undo(state, change)
    elif request_type == 'redo':
        state, patch = redo(state, change)
    else:
        raise ValueError(f'Unknown requestType: {request_type}')
    patch['actor'] = change['actor']
    patch['seq'] = change['seq']
    return state, patch


def get_patch(state):
    """Patch that builds the whole document from empty (backend/index.js:201-207)."""
    diffs = []
    context = MaterializationContext()
    context.instantiate_object(state.op_set, ROOT_ID)
    context.make_patch(ROOT_ID, diffs)
    return _make_patch(state, diffs)


def get_changes(old_state, new_state):
    old_clock = old_state.op_set.clock
    new_clock = new_state.op_set.clock
    if not less_or_equal(old_clock, new_clock):
        raise ValueError('Cannot diff two states that have diverged')
    return OpSet.get_missing_changes(new_state.op_set, old_clock)


def get_changes_for_actor(state, actor_id):
    return OpSet.get_changes_for_actor(state.op_set, actor_id)


def get_missing_changes(state, clock):
    return OpSet.get_missing_changes(state.op_set, clock)


def get_missing_deps(state):
    return OpSet.get_missing_deps(state.op_set)


def merge(local, remote):
    """Pull changes present in `remote` but not `local` (backend/index.js:240-243)."""
    changes = OpSet.get_missing_changes(remote.op_set, local.op_set.clock)
    return apply_changes(local, changes)


def undo(state, request):
    """Apply the inverse ops from the undo stack as a new change
    (backend/index.js:252-285)."""
    ops = state.op_set
    undo_pos = ops.undo_pos
    undo_ops = ops.undo_stack[undo_pos - 1] if undo_pos >= 1 else None
    if undo_pos < 1 or undo_ops is None:
        raise ValueError('Cannot undo: there is nothing to be undone')

    change = {'actor': request['actor'], 'seq': request['seq'],
              'deps': dict(request.get('deps', {})), 'ops': undo_ops}
    if request.get('message') is not None:
        change['message'] = request['message']

    redo_ops = []
    for op in undo_ops:
        if op['action'] not in ('set', 'del', 'link'):
            raise ValueError(f'Unexpected operation type in undo history: {op}')
        field_ops = OpSet.get_field_ops(ops, op['obj'], op['key'])
        if not field_ops:
            redo_ops.append({'action': 'del', 'obj': op['obj'], 'key': op['key']})
        else:
            for field_op in field_ops:
                redo_ops.append({k: v for k, v in field_op.items()
                                 if k not in ('actor', 'seq')})

    new_ops = ops.clone()
    new_ops.undo_pos = undo_pos - 1
    new_ops.redo_stack = new_ops.redo_stack + [redo_ops]
    diffs = OpSet.add_change(new_ops, change, False)
    state = BackendState(new_ops)
    return state, _make_patch(state, diffs)


def redo(state, request):
    """Re-apply the ops reverted by the last undo (backend/index.js:293-308)."""
    redo_ops = state.op_set.redo_stack[-1] if state.op_set.redo_stack else None
    if redo_ops is None:
        raise ValueError('Cannot redo: the last change was not an undo')

    change = {'actor': request['actor'], 'seq': request['seq'],
              'deps': dict(request.get('deps', {})), 'ops': redo_ops}
    if request.get('message') is not None:
        change['message'] = request['message']

    new_ops = state.op_set.clone()
    new_ops.undo_pos += 1
    new_ops.redo_stack = new_ops.redo_stack[:-1]
    diffs = OpSet.add_change(new_ops, change, False)
    state = BackendState(new_ops)
    return state, _make_patch(state, diffs)


# camelCase aliases (reference API parity)
applyChanges = apply_changes
applyLocalChange = apply_local_change
getPatch = get_patch
getChanges = get_changes
getChangesForActor = get_changes_for_actor
getMissingChanges = get_missing_changes
getMissingDeps = get_missing_deps
