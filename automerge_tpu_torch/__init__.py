"""automerge_tpu_torch: the PyTorch/CUDA port of ``automerge_tpu``.

Same change/patch protocol, same wire formats (v1/v2/v3), same snapshots
and state digests as the JAX package, which stays in the repository as
the reference. The device layer is PyTorch on a CUDA card
(``device='cpu'`` runs it on the host, as the tests do), and each TPU
kernel on a ported path is a CUDA kernel written by hand for Hopper
(``csrc/``). Importing this package never loads JAX.

Public API parity (the reference's ``src/automerge.js``): ``init, change,
empty_change, undo, redo, load, save, merge, diff, get_changes,
apply_changes, get_missing_deps, equals, inspect, get_history, uuid,
Frontend, Backend, DocSet, WatchableDoc, Connection, Text`` plus the
frontend re-exports ``can_undo, can_redo, get_actor_id, set_actor_id,
get_conflicts``, with camelCase aliases. :func:`init`, :func:`load` and
:func:`doc_from_changes` make device-backed documents: ``device=None``
means the card, and raises without one unless ``device='cpu'`` is asked
for. Every document the facade touches (those, :func:`load_snapshot`'s,
``TextReplay.to_doc``'s) goes through the backend its state records:
the port's device backend on that state's device, or the host oracle
(:mod:`.backend`) for a document a caller built on it by name
(``Frontend.init({'backend': Backend})``). The general engine
(:class:`GeneralDocSet`, :class:`GeneralStore`, :func:`init_store`) is
exported too.
"""

import json as _json

from . import frontend as Frontend
from . import backend as Backend
from .common import ROOT_ID, is_object, less_or_equal
from .text import Text
from .uuid import uuid

__version__ = '0.9.2'


def _device_backend(device):
    """The device backend bound to ``device`` (None: CUDA, raising
    without a card)."""
    from .device import backend as DeviceBackend
    return DeviceBackend.for_device(device)


def _from_changes(actor_id, changes, backend):
    if not actor_id:
        raise ValueError('actor_id is required in doc_from_changes')
    doc = Frontend.init({'actorId': actor_id, 'backend': backend})
    state, _ = backend.apply_changes(backend.init(actor_id), changes)
    patch = backend.get_patch(state)
    patch['state'] = state
    return Frontend.apply_patch(doc, patch)


def doc_from_changes(actor_id, changes, device=None):
    """Construct a device-backed document reflecting `changes` on
    ``device`` (src/automerge.js:10-17)."""
    return _from_changes(actor_id, changes, _device_backend(device))


def init(actor_id=None, device=None):
    """A new empty document whose in-process backend is the device
    backend on ``device`` (None: CUDA; raises without a card unless
    ``'cpu'`` is asked for) (src/automerge.js:21-23)."""
    return Frontend.init({'actorId': actor_id,
                          'backend': _device_backend(device)})


def change(doc, message=None, callback=None):
    """Edit `doc` via a mutable proxy in `callback`; returns the new document
    (src/automerge.js:25-28)."""
    new_doc, _ = Frontend.change(doc, message, callback)
    return new_doc


def empty_change(doc, message=None):
    new_doc, _ = Frontend.empty_change(doc, message)
    return new_doc


def undo(doc, message=None):
    new_doc, _ = Frontend.undo(doc, message)
    return new_doc


def redo(doc, message=None):
    new_doc, _ = Frontend.redo(doc, message)
    return new_doc


def load(data, actor_id=None, device=None):
    """Deserialize a document saved with :func:`save` into a
    device-backed document on ``device`` (src/automerge.js:45-47).

    The reference serializes with transit-immutable-js; this framework uses a
    plain-JSON envelope of the change history (the wire format of changes is
    identical, so histories interoperate at the change level).
    """
    payload = _json.loads(data)
    if isinstance(payload, dict):
        changes = payload['changes']
    else:
        changes = payload
    return doc_from_changes(actor_id or uuid(), changes, device=device)


def save(doc):
    """Serialize the full change history (src/automerge.js:49-52).

    Works for host-oracle and device-backed documents alike: both backend
    states expose the SharedChangeLog surface (the device state directly,
    the oracle via its op_set). A document resumed from a packed snapshot
    no longer holds pre-snapshot change bodies, so saving it here would
    silently produce a log that cannot replay — that case raises; use
    :func:`save_snapshot` for such documents."""
    state = Frontend.get_backend_state(doc)
    log = state.op_set if hasattr(state, 'op_set') else state
    if getattr(log, 'log_truncated', False):
        raise ValueError(
            'this document was resumed from a packed snapshot and no '
            'longer holds its full change log; persist it with '
            'save_snapshot() instead')
    history = log.get_history()
    return _json.dumps({'format': 'automerge-tpu@1', 'changes': history})


def _backend_of(state):
    """The backend a state belongs to — the facade works uniformly over
    host-oracle and device-backed documents (and mixes of the two:
    changes are the wire format either way). A device-backed state gets
    the device backend bound to the device it records (a bulk-routed
    state records its store's)."""
    if hasattr(state, 'op_set'):
        return Backend
    device = getattr(state, 'device', None)
    if device is None:
        device = state.store.device
    return _device_backend(device)


def merge(local_doc, remote_doc):
    """Apply changes from `remote_doc` missing in `local_doc`
    (src/automerge.js:54-64). The two documents may use different
    backends (oracle or device) — the change wire format is shared."""
    if Frontend.get_actor_id(local_doc) == Frontend.get_actor_id(remote_doc):
        raise ValueError('Cannot merge an actor with itself')
    local_state = Frontend.get_backend_state(local_doc)
    remote_state = Frontend.get_backend_state(remote_doc)
    changes = _backend_of(remote_state).get_missing_changes(
        remote_state, local_state.clock)
    state, patch = _backend_of(local_state).apply_changes(local_state,
                                                          changes)
    if not patch['diffs']:
        return local_doc
    patch['state'] = state
    return Frontend.apply_patch(local_doc, patch)


def diff(old_doc, new_doc):
    """Diffs that transform `old_doc`'s tree into `new_doc`'s
    (src/automerge.js:66-72)."""
    old_state = Frontend.get_backend_state(old_doc)
    changes = get_changes(old_doc, new_doc)
    _, patch = _backend_of(old_state).apply_changes(old_state, changes)
    return patch['diffs']


def get_changes(old_doc, new_doc):
    old_state = Frontend.get_backend_state(old_doc)
    new_state = Frontend.get_backend_state(new_doc)
    if not less_or_equal(dict(old_state.clock), dict(new_state.clock)):
        raise ValueError('Cannot diff two states that have diverged')
    return _backend_of(new_state).get_missing_changes(new_state,
                                                      old_state.clock)


def apply_changes(doc, changes):
    old_state = Frontend.get_backend_state(doc)
    new_state, patch = _backend_of(old_state).apply_changes(old_state,
                                                            changes)
    patch['state'] = new_state
    return Frontend.apply_patch(doc, patch)


def get_missing_deps(doc):
    state = Frontend.get_backend_state(doc)
    return _backend_of(state).get_missing_deps(state)


def equals(val1, val2):
    """Deep equality on document values, ignoring CRDT metadata
    (src/automerge.js:91-100)."""
    if isinstance(val1, Text) or isinstance(val2, Text):
        return isinstance(val1, Text) and isinstance(val2, Text) and list(val1) == list(val2)
    if isinstance(val1, dict) and isinstance(val2, dict):
        if sorted(val1.keys()) != sorted(val2.keys()):
            return False
        return all(equals(val1[k], val2[k]) for k in val1)
    if isinstance(val1, list) and isinstance(val2, list):
        return len(val1) == len(val2) and all(equals(a, b) for a, b in zip(val1, val2))
    return val1 == val2


def inspect(doc):
    """Plain JSON-like copy of the document without CRDT metadata
    (src/automerge.js:102-104)."""
    def clean(value):
        if isinstance(value, Text):
            return ''.join(str(v) for v in value)
        if isinstance(value, dict):
            return {k: clean(v) for k, v in value.items()}
        if isinstance(value, list):
            return [clean(v) for v in value]
        return value
    return clean(doc)


class _HistoryEntry:
    """One change in the history, with a lazily-built document snapshot
    (src/automerge.js:106-120)."""

    __slots__ = ('_actor', '_history', '_index', '_backend')

    def __init__(self, actor, history, index, backend):
        self._actor = actor
        self._history = history
        self._index = index
        self._backend = backend

    @property
    def change(self):
        return self._history[self._index]

    @property
    def snapshot(self):
        """The document after this change, on the history's backend."""
        return _from_changes(self._actor, self._history[:self._index + 1],
                             self._backend)


def get_history(doc):
    state = Frontend.get_backend_state(doc)
    actor = Frontend.get_actor_id(doc)
    log = state.op_set if hasattr(state, 'op_set') else state
    history = log.get_history()
    backend = _backend_of(state)
    return [_HistoryEntry(actor, history, i, backend)
            for i in range(len(history))]


# Frontend re-exports (src/automerge.js:137-139)
can_undo = Frontend.can_undo
can_redo = Frontend.can_redo
get_actor_id = Frontend.get_actor_id
set_actor_id = Frontend.set_actor_id
get_conflicts = Frontend.get_conflicts
get_object_id = Frontend.get_object_id
get_element_ids = Frontend.get_element_ids

from .config import Options                 # noqa: E402
from .snapshot import (save_snapshot, load_snapshot,  # noqa: E402
                       SnapshotCorruptError)
from .sync.doc_set import DocSet            # noqa: E402
from .sync.watchable_doc import WatchableDoc  # noqa: E402
from .sync.connection import Connection, MessageRejected  # noqa: E402
from .sync.resilient import ResilientConnection  # noqa: E402
from .device.general import GeneralStore, init_store  # noqa: E402
from .sync.general_doc_set import GeneralDocSet  # noqa: E402

# camelCase aliases (reference API parity)
emptyChange = empty_change
getChanges = get_changes
applyChanges = apply_changes
getMissingDeps = get_missing_deps
getHistory = get_history
docFromChanges = doc_from_changes
canUndo = can_undo
canRedo = can_redo
getActorId = get_actor_id
setActorId = set_actor_id
getConflicts = get_conflicts
getObjectId = get_object_id
getElementIds = get_element_ids
