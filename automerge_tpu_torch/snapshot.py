"""Packed-state checkpoints: O(state) resume alongside the change log.

The reference's only durability format is the change log — ``save()``
serializes every change ever applied and ``load()`` replays them
(src/automerge.js:45-52), so resume cost is a full CRDT replay of the
history. This module adds the SURVEY §5 "packed device-state snapshot":
the CRDT state itself — field entries with their closure clocks,
sequence insertion trees as columnar node arrays, vector clock, dep
frontier, causal buffer, and the per-change closure table — WITHOUT op
payloads or change bodies. Loading rebuilds a working backend with NO
replay: cost is the size of the live state, which includes O(history)
closure *metadata* (one actor->seq clock per applied change — the same
table the engine keeps in memory, and what keeps future concurrency
checks exact) but none of the op/value payloads, so snapshots are much
smaller than the log and resume skips all resolution work.

What a snapshot preserves: the document (bit-identical materialization),
convergence behavior for all future changes (closure table keeps
concurrency checks exact, even against pre-snapshot entries), duplicate
tolerance, causal buffering. What it drops: the replayable change bodies
— ``get_missing_changes`` for a peer whose clock predates the snapshot
raises (such a peer needs the snapshot or the full log), and ``save()``
of a resumed doc carries only post-resume changes. Keep the log for
archival; use snapshots for fast resume — the same split as a database
checkpoint + WAL.

The PyTorch port's copy of ``automerge_tpu/snapshot.py``; the format
is shared, so a snapshot written by either package loads in the other.
A restored document lives on the ``device`` its loader names.
"""

import json as _json

from .common import ROOT_ID
from .config import resolve_device
from .device.backend import DeviceBackendState, _ObjRecord, get_patch
from . import frontend as Frontend
from .device import backend as DeviceBackend

FORMAT = 'automerge-tpu-snapshot@1'


class SnapshotCorruptError(ValueError):
    """A snapshot payload failed validation: truncated bytes, non-JSON
    text, a checksum mismatch, or a missing/mistyped field. Every
    load path raises this (naming what failed) instead of leaking a
    bare ``KeyError``/``JSONDecodeError`` from deep inside
    reconstruction — a corrupt checkpoint must be a clean, catchable
    condition, not a crash."""


def _require(payload, fields, what):
    """Validate that ``payload`` is a dict carrying every name in
    ``fields``; raise :class:`SnapshotCorruptError` naming the first
    missing field."""
    if not isinstance(payload, dict):
        raise SnapshotCorruptError(
            f'{what}: payload is {type(payload).__name__}, not a dict')
    for name in fields:
        if name not in payload:
            raise SnapshotCorruptError(
                f"{what}: missing field '{name}' (truncated or "
                f"corrupt snapshot)")


def _corrupt_guard(fn, what):
    """Run reconstruction ``fn``; fold any mistyped-field crash
    (AttributeError/TypeError/ValueError/KeyError/...) into the
    documented :class:`SnapshotCorruptError` contract — presence checks
    alone cannot cover every corruption shape, and a load path must
    never leak a bare reconstruction traceback."""
    try:
        return fn()
    except SnapshotCorruptError:
        raise
    except Exception as err:
        raise SnapshotCorruptError(
            f'{what}: payload failed to reconstruct '
            f'({type(err).__name__}: {err})') from err


def snapshot_state(state):
    """DeviceBackendState -> JSON-ready dict (no op payload duplication:
    field entries reference values inline, change bodies are dropped)."""
    objects = []
    for obj_id, rec in state.objects.items():
        entry = {'obj': obj_id, 'type': rec.type, 'inbound': rec.inbound}
        if rec.is_sequence():
            entry['nodes'] = rec.nodes
            entry['parent'] = rec.node_parent
            entry['elem'] = rec.node_elem
            entry['actor'] = rec.node_actor
            entry['elem_ids'] = rec.elem_ids
        objects.append(entry)

    fields = [[obj, key, list(entries)]
              for (obj, key), entries in state.fields.items() if entries]

    closures = {actor: [e['all_deps'] for e in lst[:n]]
                for actor, (lst, n) in
                ((a, state.actor_states(a)) for a in state.states)}

    return {'format': FORMAT,
            'objects': objects,
            'fields': fields,
            'clock': state.clock,
            'deps': state.deps,
            'queue': state.queue,
            'closures': closures,
            # undo/redo stacks are plain op lists — cheap to carry, and
            # a resumed document keeps canUndo/canRedo working
            'undo_pos': state.undo_pos,
            'undo_stack': state.undo_stack,
            'redo_stack': state.redo_stack}


def restore_state(payload, device=None):
    """JSON dict -> DeviceBackendState on ``device`` (O(state); None:
    CUDA). Raises :class:`SnapshotCorruptError` (naming what failed) on
    a truncated, field-missing or mistyped payload."""
    _require(payload, ('format',), 'snapshot')
    if payload['format'] != FORMAT:
        raise SnapshotCorruptError(f'not a {FORMAT} snapshot')
    _require(payload, ('objects', 'fields', 'clock', 'deps', 'queue',
                       'closures'), 'snapshot')
    device = resolve_device(device)
    return _corrupt_guard(
        lambda: _restore_state_unchecked(payload, device), 'snapshot')


def _restore_state_unchecked(payload, device):
    state = DeviceBackendState(device)
    state.objects = {}
    for entry in payload['objects']:
        _require(entry, ('obj', 'type', 'inbound'), 'snapshot object')
        rec = _ObjRecord(entry['type'])
        rec.inbound = [tuple(ref) for ref in entry['inbound']]
        if rec.is_sequence():
            _require(entry, ('nodes', 'parent', 'elem', 'actor',
                             'elem_ids'), 'snapshot sequence object')
            rec.nodes = list(entry['nodes'])
            rec.node_of = {e: i for i, e in enumerate(rec.nodes)}
            rec.node_parent = list(entry['parent'])
            rec.node_elem = list(entry['elem'])
            rec.node_actor = list(entry['actor'])
            rec.elem_ids = list(entry['elem_ids'])
        state.objects[entry['obj']] = rec
    if ROOT_ID not in state.objects:
        state.objects[ROOT_ID] = _ObjRecord(None)
    state._owned = set(state.objects)

    state.fields = {(obj, key): tuple(entries)
                    for obj, key, entries in payload['fields']}
    state.rebuild_link_fields()
    state.clock = dict(payload['clock'])
    state.deps = dict(payload['deps'])
    state.queue = list(payload['queue'])
    # closure table: per (actor, seq) transitive deps, change bodies gone.
    # 'change': None marks a snapshot-era entry (duplicate deliveries are
    # dropped unverified; get_missing_changes refuses the range).
    for actor, rows in payload['closures'].items():
        state.states[actor] = [{'change': None, 'all_deps': deps}
                               for deps in rows]
        state.state_lens[actor] = len(rows)
    state.history = []
    state.history_len = 0
    state.log_truncated = True
    # absent in pre-undo snapshots: default to empty stacks
    state.undo_pos = payload.get('undo_pos', 0)
    state.undo_stack = [list(ops) for ops in payload.get('undo_stack', [])]
    state.redo_stack = [list(ops) for ops in payload.get('redo_stack', [])]
    return state


GENERAL_FORMAT = 'automerge-tpu-general-doc-snapshot@1'


def _snapshot_general(state):
    """GeneralBackendState -> JSON string: the packed store bytes plus
    the token's protocol state (clock, dep frontier, closure table,
    undo/redo)."""
    import base64
    from .device import general_backend as _gb
    # a held old token must snapshot ITS history, not the store's
    # newer content (r5 review: clock/content divergence)
    state = _gb.current_token(state)
    store_bytes = state.store.save_snapshot()
    return _json.dumps({
        'format': GENERAL_FORMAT,
        'store': base64.b64encode(store_bytes).decode('ascii'),
        'clock': state.clock,
        'deps': state.deps,
        'all_deps': [[a, s, d] for (a, s), d in
                     state._all_deps.items()],
        'undo_pos': state.undo_pos,
        'undo_stack': state.undo_stack,
        'redo_stack': state.redo_stack,
    })


def _restore_general(payload, actor_id=None, device=None):
    import base64
    import binascii
    from .device import general as _general
    from .device import general_backend as _gb
    _require(payload, ('store', 'clock', 'deps', 'all_deps'),
             'general snapshot')
    try:
        store_bytes = base64.b64decode(payload['store'])
    except (binascii.Error, TypeError, ValueError) as err:
        raise SnapshotCorruptError(
            f"general snapshot: field 'store' is not valid base64 "
            f'({err})') from None
    try:
        store = _general.GeneralStore.load_snapshot(store_bytes,
                                                    device=device)
    except SnapshotCorruptError:
        raise
    except Exception as err:
        raise SnapshotCorruptError(
            f"general snapshot: field 'store' failed to decode "
            f'({type(err).__name__}: {err})') from err
    store._gb_version = 0

    def build():
        state = _gb.GeneralBackendState(
            store, 0, dict(payload['clock']), dict(payload['deps']),
            {(a, s): d for a, s, d in payload['all_deps']})
        state.undo_pos = payload.get('undo_pos', 0)
        state.undo_stack = [list(ops) for ops
                            in payload.get('undo_stack', [])]
        state.redo_stack = [list(ops) for ops
                            in payload.get('redo_stack', [])]
        return state
    state = _corrupt_guard(build, 'general snapshot')
    options = {'backend': DeviceBackend.for_device(store.device)}
    if actor_id is not None:
        options['actorId'] = actor_id
    doc = Frontend.init(options)
    patch = _gb.get_patch(state)
    patch['state'] = state
    return Frontend.apply_patch(doc, patch)


def save_snapshot(doc):
    """Serialize a device-backed document's packed state (the fast-resume
    artifact; `save()` remains the archival change log). Covers both
    the per-doc device backend and bulk-routed
    (:class:`~.device.general_backend.GeneralBackendState`)
    documents."""
    from .device.general_backend import GeneralBackendState
    state = Frontend.get_backend_state(doc)
    if isinstance(state, GeneralBackendState):
        return _snapshot_general(state)
    if not isinstance(state, DeviceBackendState):
        raise TypeError(
            'save_snapshot requires a device-backed document; host-oracle '
            'documents use save() (the change log)')
    return _json.dumps(snapshot_state(state))


def load_snapshot(data, actor_id=None, device=None):
    """Materialize a document from a packed snapshot in O(state), on
    ``device`` (None: CUDA; raises without a card unless ``'cpu'`` is
    asked for). Snapshots written by the JAX package load here too: the
    format is shared.

    Every corruption mode — truncated bytes, non-JSON text, missing
    fields — surfaces as a :class:`SnapshotCorruptError` naming what
    failed, never a bare ``JSONDecodeError``/``KeyError``."""
    try:
        payload = _json.loads(data)
    except (ValueError, TypeError) as err:
        raise SnapshotCorruptError(
            f'snapshot payload is not valid JSON (truncated or '
            f'corrupt): {err}') from None
    if not isinstance(payload, dict):
        raise SnapshotCorruptError(
            f'snapshot payload decodes to {type(payload).__name__}, '
            f'not an object')
    if payload.get('format') == GENERAL_FORMAT:
        return _restore_general(payload, actor_id=actor_id, device=device)
    state = restore_state(payload, device=device)
    options = {'backend': DeviceBackend.for_device(state.device)}
    if actor_id is not None:
        options['actorId'] = actor_id
    doc = Frontend.init(options)
    patch = get_patch(state)
    patch['state'] = state
    return Frontend.apply_patch(doc, patch)


# camelCase aliases (reference API style)
saveSnapshot = save_snapshot
loadSnapshot = load_snapshot
