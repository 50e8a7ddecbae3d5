"""Bulk text replay: columnar editing traces resolved in one device call.

The reference replays an editing trace one keystroke at a time through
the skip list (~k ops/s); the per-document device backend batches the
protocol work but still stages each op dict in Python. This module is
the long-context bulk path: a :class:`TextBlock` encodes a whole text
editing history as columns — elemIds are STRUCTURED (actor index, elem
counter) pairs, so there is no string interning at all, and values are
unicode codepoints — and :func:`replay_text_block` turns it into the
final document text with vectorized numpy staging plus one RGA kernel
call (:mod:`.sequence`).

Scope (checked): single text object per document, changes with empty
deps — i.e. independent per-actor chains, every cross-actor pair
concurrent. That is exactly the automerge-perf trace shape and the
"N authors type concurrently" merge; histories with cross-actor deps
take the per-document backend, which shares the same wire format.

CRDT semantics under that scope, vectorized:

* same-actor ops on one element are causally ordered by seq — the
  element's fate per actor is its LATEST op (scatter-max of seq);
* cross-actor ops are concurrent — an element is visible iff ANY
  actor's latest op on it is a set (concurrent assignment beats
  delete, op_set.js:180-219), and the winning value comes from the
  highest such actor (rank order = string order);
* ordering is the RGA insertion-tree traversal (sort + pointer
  doubling, replacing 180k sequential skip-list edits with one call).

The PyTorch port's copy of ``automerge_tpu/device/text_block.py``: the
numpy staging is the reference's; the one RGA call takes tensors on
``device`` (on CUDA the hand-written RGA kernel, :mod:`.cuda_sequence`),
and a replay's document state and frontend live on that device.
"""

import numpy as np
import torch

from ..common import ROOT_ID
from ..config import resolve_device
from .sequence import rga_order
from .engine import as_options


class TextBlock:
    """One document's text-editing history as columns.

    Change columns (length C): ``actor`` (index into ``actors``),
    ``seq``. Op columns (length N, CSR via ``op_ptr``): ``kind``
    (0 ins / 1 set / 2 del), ``ref_actor``/``ref_elem`` — the referenced
    elemId as a structured pair (ins: the parent, -1/0 for ``'_head'``;
    set/del: the target), ``elem`` (ins: the new counter), ``value``
    (set: a unicode codepoint).
    """

    INS, SET, DEL = 0, 1, 2

    __slots__ = ('actors', 'obj', 'actor', 'seq', 'op_ptr', 'kind',
                 'ref_actor', 'ref_elem', 'elem', 'value', 'root_key',
                 'creator', 'linker')

    def __init__(self, actors, obj, actor, seq, op_ptr, kind, ref_actor,
                 ref_elem, elem, value, root_key=None, creator=None,
                 linker=None):
        self.actors = actors
        self.obj = obj
        self.actor = actor
        self.seq = seq
        self.op_ptr = op_ptr
        self.kind = kind
        self.ref_actor = ref_actor
        self.ref_elem = ref_elem
        self.elem = elem
        self.value = value
        self.root_key = root_key       # key linking the text at the root
        self.creator = creator         # (actor name, seq) of makeText
        self.linker = linker           # (actor name, seq) of the root link

    @property
    def n_changes(self):
        return len(self.actor)

    @property
    def n_ops(self):
        return len(self.kind)

    @classmethod
    def from_changes(cls, changes):
        """Encode wire changes for ONE text document (the compatibility
        edge, O(ops) Python). The first change must create the text
        object (makeText [+ link]); deps must be empty (see module
        scope)."""
        actors, actor_of = [], {}

        def intern(a):
            i = actor_of.get(a)
            if i is None:
                i = len(actors)
                actor_of[a] = i
                actors.append(a)
            return i

        def parse_elem_id(eid):
            if eid == '_head':
                return -1, 0
            a, _, e = eid.rpartition(':')
            return intern(a), int(e)

        obj = None
        root_key = creator = linker = None
        actor, seq = [], []
        op_ptr = [0]
        kind, ref_a, ref_e, elem, value = [], [], [], [], []
        for change in changes:
            if change['deps']:
                raise ValueError(
                    'TextBlock requires empty deps (independent actor '
                    'chains); use the per-document backend otherwise')
            actor.append(intern(change['actor']))
            seq.append(change['seq'])
            for op in change['ops']:
                action = op['action']
                if action == 'makeText':
                    if obj is not None:
                        raise ValueError('multiple text objects in trace')
                    obj = op['obj']
                    creator = (change['actor'], change['seq'])
                    continue
                if action == 'link' and op['obj'] == ROOT_ID:
                    root_key = op['key']          # structural root link
                    linker = (change['actor'], change['seq'])
                    continue
                if obj is None or op['obj'] != obj or action == 'link':
                    raise ValueError(
                        'TextBlock holds exactly one text object of '
                        'plain characters'
                        if action != 'link' else
                        'TextBlock does not support object links inside '
                        'the text; use the per-document backend')
                if action == 'ins':
                    ra, re = parse_elem_id(op['key'])
                    kind.append(cls.INS)
                    ref_a.append(ra)
                    ref_e.append(re)
                    elem.append(op['elem'])
                    value.append(0)
                elif action in ('set', 'del'):
                    ra, re = parse_elem_id(op['key'])
                    if ra < 0:
                        raise ValueError('assignment to _head')
                    kind.append(cls.SET if action == 'set' else cls.DEL)
                    ref_a.append(ra)
                    ref_e.append(re)
                    elem.append(0)
                    v = op.get('value') if action == 'set' else None
                    if action == 'set' and (not isinstance(v, str)
                                            or len(v) != 1):
                        raise ValueError(
                            'TextBlock values are single characters')
                    value.append(ord(v) if action == 'set' else 0)
                else:
                    raise ValueError(f'unsupported op {action!r} in '
                                     'a text trace')
            op_ptr.append(len(kind))

        if obj is None:
            raise ValueError('trace does not create a text object')
        return cls(actors, obj,
                   np.asarray(actor, np.int32), np.asarray(seq, np.int32),
                   np.asarray(op_ptr, np.int32), np.asarray(kind, np.int8),
                   np.asarray(ref_a, np.int32), np.asarray(ref_e, np.int32),
                   np.asarray(elem, np.int32), np.asarray(value, np.int32),
                   root_key=root_key, creator=creator, linker=linker)


class TextReplay:
    """Result of one bulk replay: the ordered document."""

    __slots__ = ('block', 'nodes_actor', 'nodes_elem', 'visible',
                 'codepoint', 'order', 'n_nodes', 'parent', 'win_actor',
                 'win_seq', 'survivors', 'device', '_vis_host')

    def __init__(self, block, nodes_actor, nodes_elem, visible, codepoint,
                 order, n_nodes, parent, win_actor, win_seq, survivors,
                 device):
        self.device = device             # where `order` lives
        self._vis_host = None            # vis_index, fetched once
        self.block = block
        self.nodes_actor = nodes_actor   # per node (incl. head): actor idx
        self.nodes_elem = nodes_elem
        self.visible = visible
        self.codepoint = codepoint
        self.order = order               # rga_order outputs (padded)
        self.n_nodes = n_nodes
        self.parent = parent
        self.win_actor = win_actor       # per node: winning actor idx / -1
        self.win_seq = win_seq
        self.survivors = survivors       # (node, actor, seq, cp) alive sets

    def _vis_index(self):
        """The host copy of vis_index over the real nodes: ONE
        device-to-host fetch per replay, shared by :meth:`text` and
        :meth:`elem_ids`."""
        if self._vis_host is None:
            self._vis_host = self.order['vis_index'][:self.n_nodes] \
                .cpu().numpy()
        return self._vis_host

    def text(self):
        """The final visible text (fetches only vis_index — the other
        kernel outputs stay on device unless asked for)."""
        vi = self._vis_index()
        vis_nodes = np.flatnonzero(vi >= 0)
        out = np.zeros(len(vis_nodes), np.uint32)
        out[vi[vis_nodes]] = self.codepoint[vis_nodes]
        return ''.join(map(chr, out.tolist()))

    def elem_ids(self):
        """Visible elemIds in document order (the order-statistic index)."""
        vi = self._vis_index()
        vis_nodes = np.flatnonzero(vi >= 0)
        ordered = np.zeros(len(vis_nodes), np.int64)
        ordered[vi[vis_nodes]] = vis_nodes
        actors = self.block.actors
        return [f'{actors[self.nodes_actor[n]]}:{self.nodes_elem[n]}'
                for n in ordered]

    def to_state(self):
        """A live :class:`~automerge_tpu_torch.device.backend.DeviceBackendState`
        continuing from this replay — bulk-load a 180k-op history in one
        device call, then keep editing through the normal change/patch
        protocol. Change bodies are not retained (same contract as a
        packed-snapshot resume: the log is truncated; peers behind this
        point need the history or a snapshot)."""
        from .backend import DeviceBackendState, _ObjRecord
        block = self.block
        if block.root_key is None or block.creator is None:
            raise ValueError(
                'block lacks the creation/link ops (built without the '
                'creating change); cannot build a document state')
        actors = block.actors
        state = DeviceBackendState(self.device)

        rec = _ObjRecord('makeText')
        eids = [f'{actors[self.nodes_actor[i]]}:{self.nodes_elem[i]}'
                for i in range(1, self.n_nodes)]
        rec.nodes = ['_head'] + eids
        rec.node_of = {e: i for i, e in enumerate(rec.nodes)}
        rec.node_parent = self.parent.tolist()
        rec.node_elem = self.nodes_elem.tolist()
        rec.node_actor = ['' if i == 0 else actors[self.nodes_actor[i]]
                          for i in range(self.n_nodes)]
        rec.elem_ids = self.elem_ids()
        state.objects[block.obj] = rec
        state._owned.add(block.obj)

        # ALL surviving entries per visible node (winner first, actor
        # string descending — concurrent sets stay as conflicts)
        s_node, s_actor, s_seq, s_cp = self.survivors
        per_node = {}
        for n, a, s, cp in zip(s_node.tolist(), s_actor.tolist(),
                               s_seq.tolist(), s_cp.tolist()):
            per_node.setdefault(n, []).append(
                {'actor': actors[a], 'seq': s,
                 'all_deps': {actors[a]: s - 1} if s > 1 else {},
                 'action': 'set', 'value': chr(cp)})
        for n, entries in per_node.items():
            entries.sort(key=lambda e: e['actor'], reverse=True)
            state.fields[(block.obj, rec.nodes[n])] = tuple(entries)

        # root link: the op identity of the LINK change, not makeText
        l_actor, l_seq = block.linker if block.linker else block.creator
        rec.inbound = [(ROOT_ID, block.root_key)]
        state.fields[(ROOT_ID, block.root_key)] = (
            {'actor': l_actor, 'seq': l_seq,
             'all_deps': {l_actor: l_seq - 1} if l_seq > 1 else {},
             'action': 'link', 'value': block.obj},)

        # clocks + body-less change log (snapshot-resume contract)
        heads = {}
        for i in range(block.n_changes):
            a = actors[block.actor[i]]
            heads[a] = max(heads.get(a, 0), int(block.seq[i]))
        for who in (block.creator, block.linker):
            if who:
                heads[who[0]] = max(heads.get(who[0], 0), who[1])
        state.clock = dict(heads)
        state.deps = dict(heads)
        for a, top in heads.items():
            state.states[a] = [
                {'change': None, 'all_deps': {a: s - 1} if s > 1 else {}}
                for s in range(1, top + 1)]
            state.state_lens[a] = top
        state.log_truncated = True
        state.rebuild_link_fields()
        return state

    def to_doc(self, actor_id=None):
        """A frontend document over :meth:`to_state` (ready to edit)."""
        from .. import frontend as Frontend
        from . import backend as DeviceBackend
        state = self.to_state()
        options = {'backend': DeviceBackend.for_device(self.device)}
        if actor_id is not None:
            options['actorId'] = actor_id
        doc = Frontend.init(options)
        patch = DeviceBackend.get_patch(state)
        patch['state'] = state
        return Frontend.apply_patch(doc, patch)


def replay_text_block(block, options=None, device=None):
    """Resolve a whole text history: vectorized staging, one RGA call.

    Validates per-actor seq chains (contiguous from 1 — causal delivery
    for independent chains), derives element visibility and winners with
    scatter-maxes, and orders the insertion tree on ``device`` (None:
    CUDA, raising without a card unless ``'cpu'`` is asked for).
    """
    device = resolve_device(device)
    opts = as_options(options)
    A = len(block.actors)
    if A == 0:
        raise ValueError('empty block')
    # per-actor chains must be contiguous from 1 (causally complete)
    order = np.lexsort((block.seq, block.actor))
    a_s, s_s = block.actor[order], block.seq[order]
    starts = np.concatenate([[True], a_s[1:] != a_s[:-1]])
    run = s_s - np.concatenate([[0], s_s[:-1]])
    ok = np.where(starts, s_s == 1, run == 1)
    if not ok.all():
        bad = int(np.flatnonzero(~ok)[0])
        raise ValueError(
            f'actor {block.actors[a_s[bad]]} has a non-contiguous seq '
            f'chain at seq {int(s_s[bad])}')

    # ---- node table: one node per ins op, in op order; node 0 = head ----
    is_ins = block.kind == TextBlock.INS
    ins_rows = np.flatnonzero(is_ins)
    n_nodes = len(ins_rows) + 1
    op_change = np.repeat(np.arange(block.n_changes, dtype=np.int64),
                          np.diff(block.op_ptr))
    nodes_actor = np.concatenate(
        [[0], block.actor[op_change[ins_rows]]]).astype(np.int32)
    nodes_elem = np.concatenate([[0], block.elem[ins_rows]]) \
        .astype(np.int32)

    # elemId (actor, elem) -> node id, via sorted composite keys; the
    # stride must cover REFERENCED counters too, or a dangling reference
    # could alias another actor's real node instead of raising
    max_elem = int(nodes_elem.max()) if n_nodes > 1 else 0
    if block.n_ops:
        max_elem = max(max_elem, int(block.ref_elem.max()))
    stride = np.int64(max_elem + 2)
    node_key = nodes_actor.astype(np.int64) * stride + nodes_elem
    node_key[0] = -1                                  # head sentinel
    key_order = np.argsort(node_key, kind='stable')
    sorted_keys = node_key[key_order]
    if len(sorted_keys) > 1 and (np.diff(sorted_keys) == 0).any():
        raise ValueError('duplicate list element ID in trace')

    def node_of(ra, re):
        probe = np.where(ra < 0, -1, ra.astype(np.int64) * stride + re)
        pos = np.searchsorted(sorted_keys, probe)
        pos = np.minimum(pos, n_nodes - 1)
        found = sorted_keys[pos] == probe
        if not found.all():
            raise ValueError('reference to unknown list element')
        return key_order[pos].astype(np.int32)

    parent = np.zeros(n_nodes, np.int32)
    parent[1:] = node_of(block.ref_actor[ins_rows],
                         block.ref_elem[ins_rows])

    # ---- element fate: latest op per (node, actor); visible iff any
    # actor's latest is a set; winner = highest such actor ----
    as_rows = np.flatnonzero(block.kind != TextBlock.INS)
    tgt_node = node_of(block.ref_actor[as_rows], block.ref_elem[as_rows])
    op_actor = block.actor[op_change[as_rows]]
    op_seq = block.seq[op_change[as_rows]]
    is_set = (block.kind[as_rows] == TextBlock.SET).astype(np.int64)
    # packed per (node, actor): (seq << 1 | is_set); scatter-max picks
    # the causally-latest op, ties impossible (one op per field per seq
    # in a well-formed trace; the frontend dedupes same-key ops)
    cell = tgt_node.astype(np.int64) * A + op_actor
    packed = (op_seq.astype(np.int64) << 1) | is_set
    fate = np.zeros(n_nodes * A, np.int64)
    np.maximum.at(fate, cell, packed)
    fate = fate.reshape(n_nodes, A)
    set_alive = (fate != 0) & ((fate & 1) == 1)        # latest op is a set
    visible = set_alive.any(axis=1)
    visible[0] = False

    # winning codepoint: the set from the highest alive actor (by STRING
    # rank, op_set.js:211) at its latest seq — recovered by matching
    # (node, actor, seq) against the set rows
    str_rank = np.argsort(np.argsort(np.asarray(block.actors,
                                                dtype=object)))
    by_rank = np.argsort(np.asarray(block.actors, dtype=object))
    rank_alive = np.where(set_alive, str_rank[None, :], -1)
    win_rank = rank_alive.max(axis=1)
    win_actor = np.where(visible, by_rank[np.maximum(win_rank, 0)], -1)
    win_seq = np.where(visible,
                       fate[np.arange(n_nodes),
                            np.maximum(win_actor, 0)] >> 1, 0)
    codepoint = np.zeros(n_nodes, np.int32)
    set_rows = as_rows[is_set.astype(bool)]
    sn = node_of(block.ref_actor[set_rows], block.ref_elem[set_rows])
    sa = block.actor[op_change[set_rows]]
    ss = block.seq[op_change[set_rows]]
    mine = (win_actor[sn] == sa) & (win_seq[sn] == ss)
    codepoint[sn[mine]] = block.value[set_rows[mine]]
    # ALL surviving set entries (each alive actor's latest set) — the
    # conflict metadata a continued document state must carry
    alive_row = set_alive[sn, sa] & ((fate[sn, sa] >> 1) == ss)
    survivors = (sn[alive_row], sa[alive_row], ss[alive_row],
                 block.value[set_rows[alive_row]])

    # ---- one device call: RGA order over the whole tree ----
    n_pad = opts.pad_nodes(n_nodes)

    def pad(x, fill=0):
        out = np.full(n_pad, fill, x.dtype)
        out[:len(x)] = x
        return out
    # actor RANKS must follow string order
    rank_col = pad(str_rank[nodes_actor].astype(np.int32))
    valid = np.zeros(n_pad, bool)
    valid[:n_nodes] = True
    planes = [torch.from_numpy(x).to(device) for x in
              (pad(parent), pad(nodes_elem), rank_col, pad(visible), valid)]
    out = rga_order(*planes)
    # outputs stay device-resident; consumers fetch what they use
    return TextReplay(block, nodes_actor, nodes_elem, visible, codepoint,
                      out, n_nodes, parent, win_actor, win_seq, survivors,
                      device)
