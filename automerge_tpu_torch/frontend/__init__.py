"""Frontend: document lifecycle, change requests, patch application.

Parity with `reference frontend/index.js` (public surface at
frontend/index.js:438-443). The frontend holds the materialized document as
frozen objects, turns mutations made in ``change()`` callbacks into change
requests, and applies backend patches. It can run **with** an immediate
in-process backend (``init({'backend': ...})``) or **without** one, in
which case requests queue up optimistically and are reconciled against
remote patches with a deliberately-approximate operational transform
(frontend/index.js:131-192).
"""

from ..common import ROOT_ID, is_object
from ..text import Text
from ..uuid import uuid as _uuid
from .apply_patch import apply_diffs, update_parent_objects, clone_root_object
from .context import Context
from .datatypes import AmMap
from .proxies import root_object_proxy, MapProxy, ListProxy

__all__ = [
    'init', 'change', 'empty_change', 'apply_patch', 'can_undo', 'undo',
    'can_redo', 'redo', 'get_object_id', 'get_actor_id', 'set_actor_id',
    'get_conflicts', 'get_backend_state', 'get_element_ids', 'Text',
]


def _freeze_tree(updated):
    for obj in updated.values():
        if hasattr(obj, '_freeze'):
            obj._freeze()


def update_root_object(doc, updated, inbound, state):
    """Build a new frozen root object incorporating `updated`
    (frontend/index.js:15-39)."""
    new_doc = updated.get(ROOT_ID)
    if new_doc is None:
        new_doc = clone_root_object(doc._cache[ROOT_ID])
        updated[ROOT_ID] = new_doc

    for object_id in doc._cache:
        if object_id not in updated:
            updated[object_id] = doc._cache[object_id]

    object.__setattr__(new_doc, '_actor_id', get_actor_id(doc))
    object.__setattr__(new_doc, '_options', doc._options)
    object.__setattr__(new_doc, '_cache', updated)
    object.__setattr__(new_doc, '_inbound', inbound)
    object.__setattr__(new_doc, '_state', state)
    _freeze_tree(updated)
    return new_doc


def ensure_single_assignment(ops):
    """Keep only the most recent assignment per (obj, key)
    (frontend/index.js:46-64)."""
    assignments = {}
    result = []
    for op in reversed(ops):
        if op['action'] in ('set', 'del', 'link'):
            seen = assignments.setdefault(op['obj'], {})
            if not seen.get(op['key']):
                seen[op['key']] = True
                result.append(op)
        else:
            result.append(op)
    return list(reversed(result))


def make_change(doc, request_type, context, message):
    """Create a change request; apply immediately if a backend is attached,
    else queue it optimistically (frontend/index.js:73-105)."""
    actor = get_actor_id(doc)
    if not actor:
        raise ValueError('Actor ID must be initialized with set_actor_id() '
                         'before making a change')
    state = dict(doc._state)
    state['seq'] += 1
    deps = dict(state['deps'])
    deps.pop(actor, None)

    request = {'requestType': request_type, 'actor': actor, 'seq': state['seq'],
               'deps': deps}
    if message is not None:
        request['message'] = message
    if context is not None:
        request['ops'] = ensure_single_assignment(context.ops)

    backend = doc._options.get('backend')
    if backend:
        backend_state, patch = backend.apply_local_change(state['backendState'], request)
        state['backendState'] = backend_state
        state['requests'] = []
        return apply_patch_to_doc(doc, patch, state, True), request

    queued_request = dict(request)
    queued_request['before'] = doc
    if context is not None:
        queued_request['diffs'] = context.diffs
    state['requests'] = state['requests'] + [queued_request]
    updated = context.updated if context is not None else {}
    inbound = context.inbound if context is not None else dict(doc._inbound)
    return update_root_object(doc, updated, inbound, state), request


def apply_patch_to_doc(doc, patch, state, from_backend):
    """(frontend/index.js:114-129)"""
    actor = get_actor_id(doc)
    inbound = dict(doc._inbound)
    updated = {}
    # Queued undo/redo requests replayed through this path carry no diffs.
    # Replayed request diffs (not from_backend) are OT-transformed
    # approximations and get lenient index handling; authoritative
    # backend diffs stay strict.
    apply_diffs(patch.get('diffs', []), doc._cache, updated, inbound,
                lenient=not from_backend)
    update_parent_objects(doc._cache, updated, inbound)

    if from_backend:
        seq = patch.get('clock', {}).get(actor)
        if seq and seq > state['seq']:
            state['seq'] = seq
        # Patches may omit deps/undo state; the reference sets state.deps
        # to undefined in that case, which its next makeChange treats as
        # {} (frontend/index.js:114-129, :79) — the {} defaults here are
        # that exact behavior, not a loosening. Both real backends always
        # populate these fields.
        state['deps'] = patch.get('deps', {})
        state['canUndo'] = patch.get('canUndo', False)
        state['canRedo'] = patch.get('canRedo', False)
    return update_root_object(doc, updated, inbound, state)


def transform_request(request, patch):
    """Transform a pending local request past a remote patch — a simple,
    deliberately-approximate operational transform used only while waiting
    for the backend's authoritative reply (frontend/index.js:131-192)."""
    transformed = []
    for local in request.get('diffs', []):
        local = dict(local)
        drop = False
        for remote in patch['diffs']:
            if (local['obj'] == remote['obj'] and local['type'] == 'list'
                    and local['action'] in ('insert', 'set', 'remove')):
                if remote['action'] == 'insert' and remote['index'] <= local['index']:
                    local['index'] += 1
                if remote['action'] == 'remove' and remote['index'] < local['index']:
                    local['index'] -= 1
                if remote['action'] == 'remove' and remote['index'] == local['index']:
                    if local['action'] == 'set':
                        local['action'] = 'insert'
                    if local['action'] == 'remove':
                        drop = True
                        break
        if not drop:
            transformed.append(local)
    request['diffs'] = transformed


def init(options=None):
    """Create an empty document (frontend/index.js:197-222)."""
    if isinstance(options, str):
        options = {'actorId': options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f'Unsupported value for init() options: {options}')
    if options.get('actorId') is None and not options.get('deferActorId'):
        options = dict(options)
        options['actorId'] = _uuid()

    root = AmMap(ROOT_ID)
    cache = {ROOT_ID: root}
    state = {'seq': 0, 'requests': [], 'deps': {}, 'canUndo': False, 'canRedo': False}
    backend = options.get('backend')
    if backend:
        state['backendState'] = backend.init()
    object.__setattr__(root, '_actor_id', options.get('actorId'))
    object.__setattr__(root, '_options', options)
    object.__setattr__(root, '_cache', cache)
    object.__setattr__(root, '_inbound', {})
    object.__setattr__(root, '_state', state)
    root._freeze()
    return root


def change(doc, message=None, callback=None):
    """Make local edits inside a callback receiving a mutable proxy; returns
    (new_doc, request) (frontend/index.js:233-261)."""
    if isinstance(doc, (MapProxy, ListProxy)):
        raise TypeError('Calls to change() cannot be nested')
    if doc._object_id != ROOT_ID:
        raise TypeError('The first argument to change() must be the document root')
    if callable(message) and callback is None:
        message, callback = None, message
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')

    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError('Actor ID must be initialized with set_actor_id() '
                         'before making a change')
    context = Context(doc, actor_id)
    callback(root_object_proxy(context))

    if not context.updated:
        return doc, None
    update_parent_objects(doc._cache, context.updated, context.inbound)
    return make_change(doc, 'change', context, message)


def empty_change(doc, message=None):
    """A change with no ops — used to acknowledge receipt of changes by
    incorporating them into `deps` (frontend/index.js:271-281)."""
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')
    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError('Actor ID must be initialized with set_actor_id() '
                         'before making a change')
    return make_change(doc, 'change', Context(doc, actor_id), message)


def apply_patch(doc, patch):
    """Apply a backend patch, replaying any still-pending local requests on
    top (frontend/index.js:289-324)."""
    state = dict(doc._state)

    if state['requests']:
        base_doc = state['requests'][0]['before']
        if patch.get('actor') == get_actor_id(doc) and patch.get('seq') is not None:
            if state['requests'][0]['seq'] != patch['seq']:
                raise ValueError(
                    f"Mismatched sequence number: patch {patch['seq']} does not "
                    f"match next request {state['requests'][0]['seq']}")
            state['requests'] = [dict(req) for req in state['requests'][1:]]
        else:
            state['requests'] = [dict(req) for req in state['requests']]
    else:
        base_doc = doc
        state['requests'] = []

    if doc._options.get('backend'):
        if patch.get('state') is None:
            raise ValueError('When an immediate backend is used, a patch must '
                             'contain the new backend state')
        state['backendState'] = patch['state']
        state['requests'] = []
        return apply_patch_to_doc(doc, patch, state, True)

    new_doc = apply_patch_to_doc(base_doc, patch, state, True)
    for request in state['requests']:
        request['before'] = new_doc
        transform_request(request, patch)
        new_doc = apply_patch_to_doc(request['before'], request, state, False)
    return new_doc


def _is_undo_redo_in_flight(doc):
    return any(req['requestType'] in ('undo', 'redo')
               for req in doc._state['requests'])


def can_undo(doc):
    return bool(doc._state['canUndo']) and not _is_undo_redo_in_flight(doc)


def undo(doc, message=None):
    """(frontend/index.js:349-360)"""
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')
    if not doc._state['canUndo']:
        raise ValueError('Cannot undo: there is nothing to be undone')
    if _is_undo_redo_in_flight(doc):
        raise ValueError('Can only have one undo in flight at any one time')
    return make_change(doc, 'undo', None, message)


def can_redo(doc):
    return bool(doc._state['canRedo']) and not _is_undo_redo_in_flight(doc)


def redo(doc, message=None):
    """(frontend/index.js:379-390)"""
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')
    if not doc._state['canRedo']:
        raise ValueError('Cannot redo: there is no prior undo')
    if _is_undo_redo_in_flight(doc):
        raise ValueError('Can only have one redo in flight at any one time')
    return make_change(doc, 'redo', None, message)


def get_object_id(obj):
    return getattr(obj, '_object_id', None)


def get_actor_id(doc):
    return doc._state.get('actorId') or doc._options.get('actorId')


def set_actor_id(doc, actor_id):
    state = dict(doc._state)
    state['actorId'] = actor_id
    return update_root_object(doc, {}, doc._inbound, state)


def get_conflicts(obj):
    return obj._conflicts


def get_backend_state(doc):
    return doc._state.get('backendState')


def get_element_ids(lst):
    if isinstance(lst, Text):
        return [e['elemId'] for e in lst.elems]
    return lst._elem_ids


# camelCase aliases (reference API parity)
emptyChange = empty_change
applyPatch = apply_patch
canUndo = can_undo
canRedo = can_redo
getObjectId = get_object_id
getActorId = get_actor_id
setActorId = set_actor_id
getConflicts = get_conflicts
getBackendState = get_backend_state
getElementIds = get_element_ids
