"""Editing-trace workloads: the automerge-perf benchmark analogue.

The reference names the `automerge-perf` trace — every keystroke of a
~180k-op LaTeX paper editing session, replayed as one change per op — as
its canonical performance workload (BASELINE.md; the trace itself is
single-author: mostly sequential typing with backspaces and cursor jumps).
This module generates traces of that shape deterministically, and converts
them between the three representations the framework can replay them in:

1. **wire changes** — the reference's change JSON, replayed through the
   oracle backend (`backend.apply_changes`); conformance + host perf.
2. **device arrays** — the whole trace's insertion tree packed into
   `(parent, elem, actor, visible, valid)` columns for the RGA sequence
   kernel (`device.sequence.rga_order`): the entire final document order is
   computed in one device call instead of 180k sequential skip-list edits.

The PyTorch port's copy of ``automerge_tpu/traces.py``: the same numpy
draws, so a seed gives the JAX package's trace change for change.
"""

import numpy as np

from .common import ROOT_ID

TEXT_OBJ = 'trace-text-0000-0000-000000000000'
_ALPHABET = 'abcdefghijklmnopqrstuvwxyz     ,.\n'


def gen_editing_trace(n_ops=2000, actor='author', seed=0,
                      backspace_p=0.07, jump_p=0.03, obj=TEXT_OBJ):
    """A deterministic single-author editing session.

    Returns a list of wire-format changes: change 1 creates the Text object
    and links it at the root key ``'text'``; each subsequent change is one
    keystroke — an insert (``ins`` + ``set``) at the cursor, or a backspace
    (``del``). Cursor occasionally jumps (revision behavior in the real
    trace). ``obj`` overrides the Text object's uuid — non-root uuids
    are globally unique on the block path, so distinct documents in one
    batch need distinct object ids.
    """
    rng = np.random.default_rng(seed)
    changes = [{'actor': actor, 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': obj},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': obj},
    ]}]

    elems = []          # visible elemIds in order (host shadow)
    cursor = 0
    max_elem = 0
    # Draw all randomness up front — ~10x faster than per-op rng calls.
    kinds = rng.random(n_ops)
    jumps = rng.random(n_ops)
    chars = rng.integers(0, len(_ALPHABET), size=n_ops)

    for i in range(n_ops):
        seq = i + 2
        if kinds[i] < backspace_p and cursor > 0:
            victim = elems.pop(cursor - 1)
            cursor -= 1
            ops = [{'action': 'del', 'obj': obj, 'key': victim}]
        else:
            max_elem += 1
            elem_id = f'{actor}:{max_elem}'
            prev = elems[cursor - 1] if cursor > 0 else '_head'
            ops = [
                {'action': 'ins', 'obj': obj, 'key': prev,
                 'elem': max_elem},
                {'action': 'set', 'obj': obj, 'key': elem_id,
                 'value': _ALPHABET[chars[i]]},
            ]
            elems.insert(cursor, elem_id)
            cursor += 1
        if jumps[i] < jump_p and elems:
            cursor = int(jumps[i] / jump_p * (len(elems) + 1))
        changes.append({'actor': actor, 'seq': seq, 'deps': {}, 'ops': ops})
    return changes


def trace_to_device_arrays(changes, pad_to=None):
    """Pack a trace's insertion tree into RGA-kernel columns.

    Returns ((parent, elem, actor, visible, valid), node_values) where
    node 0 is the virtual head and ``node_values[i]`` is the character at
    node i (None for head/tombstones-to-be). Actors are interned to ranks
    in sorted order (conflict resolution relies on rank order = string
    order, packing.py).
    """
    actors = sorted({c['actor'] for c in changes})
    rank = {a: i for i, a in enumerate(actors)}

    node_of = {'_head': 0}
    parents, elems, actor_col = [0], [0], [0]
    values = [None]
    visible = [False]
    for change in changes:
        a = rank[change['actor']]
        for op in change['ops']:
            if op['obj'] != TEXT_OBJ:
                continue
            if op['action'] == 'ins':
                eid = f"{change['actor']}:{op['elem']}"
                node_of[eid] = len(parents)
                parents.append(node_of[op['key']])
                elems.append(op['elem'])
                actor_col.append(a)
                values.append(None)
                visible.append(False)
            elif op['action'] == 'set':
                i = node_of[op['key']]
                values[i] = op['value']
                visible[i] = True
            elif op['action'] == 'del':
                visible[node_of[op['key']]] = False

    n = len(parents)
    pad = (pad_to or n) - n
    assert pad >= 0, 'pad_to smaller than node count'
    arr = (
        np.asarray(parents + [0] * pad, np.int32),
        np.asarray(elems + [0] * pad, np.int32),
        np.asarray(actor_col + [0] * pad, np.int32),
        np.asarray(visible + [False] * pad, bool),
        np.asarray([True] * n + [False] * pad, bool),
    )
    return arr, values


def device_text(order_out, node_values):
    """Materialize the visible text from an `rga_order` result (its
    tensors on any device; vis_index is fetched once)."""
    vi = order_out['vis_index'].cpu().numpy()
    chars = [''] * int(order_out['length'])
    for node in np.flatnonzero(vi >= 0):
        chars[vi[node]] = node_values[node]
    return ''.join(chars)


def oracle_text(state):
    """Materialize the trace text from an oracle backend state."""
    from .backend import op_set as O
    return ''.join(
        O.list_iterator(state.op_set, TEXT_OBJ, 'values', None))
