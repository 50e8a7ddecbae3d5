"""Columnar change/patch blocks: the bulk path of the change protocol.

The reference's wire protocol is per-change JSON (INTERNALS.md:142-146);
applying C changes costs O(C) JS object churn. This module defines the
same protocol messages in struct-of-arrays form for the bulk path — a
:class:`ChangeBlock` is a batch of changes across MANY documents encoded
as dense integer columns + interning tables, and a :class:`PatchBlock`
is the corresponding batch of patches. The two encodings are losslessly
interconvertible (:meth:`ChangeBlock.from_changes` /
:meth:`ChangeBlock.to_changes`, :meth:`PatchBlock.to_patches`), so block
users and dict users interoperate change-for-change.

:class:`BlockStore` is the struct-of-arrays document store of SURVEY §7:
per-field surviving entries as flat arrays (doc-major, field-grouped),
vector clocks as sorted columnar (doc, actor, seq) rows, per-change
transitive dependency closures as CSR. :func:`apply_block` is
`applyChanges` for the bulk path: causal admission as vectorized
fixed-point waves (the batch analogue of applyQueuedOps,
op_set.js:267-283), ONE device kernel call resolving every touched field
of every document (:mod:`.merge`), vectorized unpack back into the store,
patches out. The only Python-level loops run over *waves* (the longest
causal chain in the batch) and over queued/rare cross-block dependency
rows — every per-op computation is a numpy array pass, so a million-op
block packs in tens of milliseconds instead of tens of seconds.

Scope: flat map documents (set/del on root fields) — the DocSet bulk
merge shape of BASELINE config 5. Nested objects, links and sequences
take the per-document path (:mod:`.backend`), which speaks the same
change/patch protocol. A change carrying TWO assignments to the same key
(which the reference frontend never emits — `ensureSingleAssignment`,
frontend/index.js:46) matches the oracle: both survive, the first op
wins and the later ones surface as self-conflicts. Duplicate deliveries
are verified against the retained change bodies and an inconsistent
reuse of a seq number raises, exactly like the oracle (op_set.js:243-248);
with retention off or a truncated log the duplicate is dropped unverified.
"""

import bisect as _bisect
import json as _json

import numpy as np
import torch

from ..common import ROOT_ID
from ..config import resolve_device
from ..utils.metrics import metrics
from . import engine as _engine

_SET, _DEL = 0, 1
_ACTION_NAMES = {'set': _SET, 'del': _DEL}
_ACTION_CODES = {v: k for k, v in _ACTION_NAMES.items()}

# general-block action codes (superset; flat blocks only ever carry 0/1)
_INS, _LINK, _MAKE_MAP, _MAKE_LIST, _MAKE_TEXT = 2, 3, 4, 5, 6
_GEN_ACTION_NAMES = {'set': _SET, 'del': _DEL, 'ins': _INS, 'link': _LINK,
                     'makeMap': _MAKE_MAP, 'makeList': _MAKE_LIST,
                     'makeText': _MAKE_TEXT}
_GEN_ACTION_CODES = {v: k for k, v in _GEN_ACTION_NAMES.items()}
# key kinds for general blocks
_KEY_STR, _KEY_ELEM, _KEY_HEAD, _KEY_NONE = 0, 1, 2, 3

_SEQ_BITS = 20    # seq numbers < 2^20 per actor (assert-guarded)


def _intern(table, index, item):
    """Intern one string/value into (list, id-dict); returns its id."""
    i = index.get(item)
    if i is None:
        i = len(table)
        index[item] = i
        table.append(item)
    return i


_MISSING = object()


class HorizonTruncated(ValueError):
    """A peer's clock predates this store's compaction horizon for a
    document: the change bodies it needs were folded into the per-doc
    state snapshot and no longer exist as history. The sync layer
    answers with a ``'state'`` message (the snapshot + the retained
    tail) instead of a change replay; callers that cannot ship state
    surface this as the clear serve error it is."""

    def __init__(self, doc, message=None):
        super().__init__(
            message or
            f'history of doc {doc} at or behind the compaction '
            f'horizon was folded into its state snapshot; serve the '
            f'peer a state bootstrap')
        self.doc = doc


def _wire_entry_bytes(entry):
    """Resident byte size of one encode-cache entry: v1 entries are
    plain JSON bytes, v2 entries are ``(body, lits)`` columnar
    pairs."""
    if isinstance(entry, (bytes, bytearray)):
        return len(entry)
    body, lits = entry
    return len(body) + sum(len(l) for l in lits)


def change_hash(change):
    """Canonical 64-bit content hash of one reference-format change
    dict — the unit the per-doc state digest XOR-folds. Hashing the
    sorted-key compact JSON makes the value independent of dict
    ordering and of which wire path delivered the change (the dict
    protocol, the columnar blob and a journal replay all reconstruct
    the same canonical form), so two replicas holding the same change
    content always agree — and an "evil twin" (same ``(actor, seq)``,
    different ops) never does."""
    import hashlib
    import json
    payload = json.dumps(change, sort_keys=True,
                         separators=(',', ':'), default=str)
    return int.from_bytes(
        hashlib.blake2b(payload.encode('utf-8'),
                        digest_size=8).digest(), 'big')


class LazyValues:
    """Op values as byte spans into a wire buffer, JSON-decoded on first
    access (the native wire codec never parses values — most are never
    materialized on the bulk path). A negative start marks a null value
    (a set op without a "value" member, matching the dict edge's
    ``op.get('value')``)."""

    __slots__ = ('_buf', '_starts', '_ends', '_cache')

    def __init__(self, buf, starts, ends):
        self._buf = buf
        self._starts = starts
        self._ends = ends
        self._cache = {}

    def __len__(self):
        return len(self._starts)

    def __getitem__(self, i):
        n = len(self._starts)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        v = self._cache.get(i, _MISSING)
        if v is _MISSING:
            s = self._starts[i]
            v = None if s < 0 else self._decode(
                self._buf[s:self._ends[i]])
            self._cache[i] = v
        return v

    def _decode(self, raw):
        return _json.loads(raw.decode('utf-8'))

    def __iter__(self):
        for i in range(len(self._starts)):
            yield self[i]

    def compacted(self):
        """A copy whose buffer holds ONLY the value bytes — retaining a
        segment must not pin the whole wire message in memory."""
        keep = self._starts >= 0
        sizes = np.where(keep, self._ends - self._starts, 0)
        new_ends = np.cumsum(sizes)
        new_starts = np.where(keep, new_ends - sizes, -1)
        buf = b''.join(
            self._buf[self._starts[i]:self._ends[i]]
            for i in np.flatnonzero(keep))
        return type(self)(buf, new_starts, new_ends)


class TaggedValues(LazyValues):
    """Op values as TAGGED binary spans into a columnar v2 wire
    container (tag byte + payload — see ``wire.py``'s literal tags),
    decoded lazily on first access like their JSON twins. Only the
    composite tag (6) touches a JSON decoder, and only when such a
    value is actually materialized — the v2 apply path itself is
    JSON-free."""

    __slots__ = ()

    def _decode(self, raw):
        from .. import wire as _wire
        return _wire.decode_tagged_literal(raw)


class ValueTable:
    """The store's value store: plain appended values plus lazily-decoded
    wire segments, indexable in append order. ``extend`` of a
    :class:`LazyValues` keeps it as a segment (compacted — no decoding,
    no pinning of the full wire buffer); everything else lands in plain
    list segments."""

    __slots__ = ('_segs', '_offsets', '_len')

    def __init__(self):
        self._segs = []
        self._offsets = [0]
        self._len = 0

    def __len__(self):
        return self._len

    def extend(self, items):
        """Append ``items`` as one segment.

        OWNERSHIP TRANSFER: a plain ``list`` argument is stored as a
        shared segment WITHOUT copying — the caller must not mutate it
        afterwards (block value tables are immutable once built; a
        million-value block would otherwise pay a full list copy per
        apply). Pass any other iterable to get a private copy.
        """
        if isinstance(items, LazyValues):
            items = items.compacted()
        elif isinstance(items, ValueTable):
            for seg in items._segs:
                self.extend(seg)
            return
        elif type(items) is not list:
            items = list(items)
        if not len(items):
            return
        self._segs.append(items)
        self._len += len(items)
        self._offsets.append(self._len)

    def __getitem__(self, i):
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        seg = _bisect.bisect_right(self._offsets, i) - 1
        return self._segs[seg][i - self._offsets[seg]]

    def take(self, idx):
        """Values at `idx` (int array; -1 -> None) as a list — ONE
        vectorized segment search instead of a bisect per item (the
        diff-emission hot path reads tens of thousands per patch)."""
        idx = np.asarray(idx, np.int64)
        offs = np.asarray(self._offsets, np.int64)
        segs = np.searchsorted(offs, np.maximum(idx, 0),
                               side='right') - 1
        within = np.maximum(idx, 0) - offs[segs]
        stabs = self._segs
        return [None if i < 0 else stabs[s][w]
                for i, s, w in zip(idx.tolist(), segs.tolist(),
                                   within.tolist())]

    def __iter__(self):
        for seg in self._segs:
            yield from seg

    def _mark(self):
        """Opaque rollback token (see general._Txn)."""
        return (len(self._segs), self._len)

    def _restore(self, mark):
        n_segs, n_len = mark
        del self._segs[n_segs:]
        del self._offsets[n_segs + 1:]
        self._len = n_len


def check_block_ranges(store, block):
    """Composite-key range guards shared by every block consumer."""
    if block.n_docs != store.n_docs:
        raise ValueError(
            f'block is for {block.n_docs} docs, store holds {store.n_docs}')
    if block.n_changes:
        if int(block.seq.max()) >= (1 << _SEQ_BITS):
            raise ValueError(f'seq numbers must be < 2^{_SEQ_BITS}')
        if int(block.doc.max()) >= block.n_docs or \
                int(block.doc.min()) < 0:
            raise ValueError(
                f'block doc index out of range for {block.n_docs} docs')
    if store.n_docs >= (1 << 22):
        raise ValueError('store exceeds the 4M-document key space')


class ChangeBlock:
    """A batch of wire changes across documents, as columns.

    Change columns (length C, non-decreasing ``doc``):
      doc     int32 — document index within the batch
      actor   int32 — index into ``actors``
      seq     int32
      dep_ptr int32[C+1] — CSR over direct deps (dep_actor, dep_seq)
    Op columns (length N, CSR over changes via ``op_ptr``):
      action  int8  — 0 set, 1 del
      key     int32 — index into ``keys``
      value   int32 — index into ``values`` (-1 for del)
    Tables: ``actors`` (strings), ``keys`` (strings), ``values`` (host
    JSON values; never shipped to the device — ops reference them by row
    and winners map back on unpack).
    """

    __slots__ = ('n_docs', 'doc', 'actor', 'seq', 'dep_ptr', 'dep_actor',
                 'dep_seq', 'op_ptr', 'action', 'key', 'value',
                 'actors', 'keys', 'values', '_dup_keys',
                 'obj', 'key_kind', 'key_elem', 'elem', 'objs',
                 '_wire_lits')

    def __init__(self, n_docs, doc, actor, seq, dep_ptr, dep_actor, dep_seq,
                 op_ptr, action, key, value, actors, keys, values,
                 dup_keys=None, obj=None, key_kind=None, key_elem=None,
                 elem=None, objs=None):
        if len(doc) and (np.diff(doc) < 0).any():
            order = np.argsort(doc, kind='stable')
            dep_ptr, (dep_actor, dep_seq) = _csr_take(
                dep_ptr, order, (dep_actor, dep_seq))
            if obj is not None:
                op_ptr2, (obj, key_kind, key_elem, elem) = _csr_take(
                    op_ptr, order, (obj, key_kind, key_elem, elem))
            op_ptr, (action, key, value) = _csr_take(
                op_ptr, order, (action, key, value))
            doc, actor, seq = doc[order], actor[order], seq[order]
        self.n_docs = n_docs
        self.doc = doc
        self.actor = actor
        self.seq = seq
        self.dep_ptr = dep_ptr
        self.dep_actor = dep_actor
        self.dep_seq = dep_seq
        self.op_ptr = op_ptr
        self.action = action
        self.key = key
        self.value = value
        self.actors = actors
        self.keys = keys
        self.values = values
        self._dup_keys = dup_keys
        # general-op columns (None on flat root-map blocks): per-op
        # object row (into ``objs``), key kind (_KEY_*), elemId counter
        # for _KEY_ELEM keys (the actor rides in ``key``), ins counter
        self.obj = obj
        self.key_kind = key_kind
        self.key_elem = key_elem
        self.elem = elem
        self.objs = objs
        # pre-escaped JSON string-literal tables for the wire emitter
        # (wire.encode_change_rows), built lazily once per block
        self._wire_lits = None

    def is_general(self):
        """True when the block carries the general op schema (sequences,
        nested objects, links) — such blocks apply through
        :mod:`automerge_tpu.device.general`, not the flat-map paths."""
        return self.obj is not None

    def has_dup_keys(self):
        """True if any change assigns the same field more than once —
        the self-conflict shape the reference frontend never emits
        (ensureSingleAssignment, frontend/index.js:46) but hand-built
        changes can. Computed lazily, cached; the wire edges set it
        during their walk."""
        if self._dup_keys is None:
            if self.n_ops == 0:
                self._dup_keys = False
            else:
                op_change = np.repeat(
                    np.arange(self.n_changes, dtype=np.int64),
                    np.diff(self.op_ptr))
                if self.obj is None:
                    cell = op_change * max(len(self.keys), 1) + self.key
                    self._dup_keys = bool(
                        len(np.unique(cell)) < len(cell))
                else:
                    # general schema: field identity is (change, obj,
                    # kind, key, key_elem), assignment ops only — make
                    # and ins ops never collide
                    assign = (self.action <= _DEL) | \
                        (self.action == _LINK)
                    if not assign.any():
                        self._dup_keys = False
                    else:
                        cols = np.stack([
                            op_change[assign],
                            self.obj[assign].astype(np.int64),
                            self.key_kind[assign].astype(np.int64),
                            self.key[assign].astype(np.int64),
                            self.key_elem[assign].astype(np.int64)])
                        uniq = np.unique(cols, axis=1)
                        self._dup_keys = bool(
                            uniq.shape[1] < cols.shape[1])
        return self._dup_keys

    @property
    def n_changes(self):
        return len(self.doc)

    @property
    def n_ops(self):
        return len(self.action)

    @classmethod
    def from_changes(cls, changes_per_doc, n_docs=None):
        """Encode per-document dict changes (the JSON wire format) into one
        block. O(total ops) Python — the compatibility edge, not the bulk
        path. ``n_docs`` widens the block's document space beyond
        ``len(changes_per_doc)`` (a sparse tick touching few documents of
        a large store need not materialize one list per document)."""
        actors, actor_of = [], {}
        keys, key_of = [], {}
        values = []
        doc, actor, seq = [], [], []
        dep_ptr, dep_actor, dep_seq = [0], [], []
        op_ptr, action, key, value = [0], [], [], []

        def check_i32(v, what):
            # match the native codec: out-of-range wire counters are a
            # ValueError, never a silent int32 wraparound
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
                seq.append(check_i32(change['seq'], 'change seq'))
                # dep order is semantic: the reference folds deps in dict
                # order and later entries can clobber earlier transitive
                # seqs (transitiveDeps, op_set.js:29-37)
                for da, ds in change['deps'].items():
                    dep_actor.append(_intern(actors, actor_of, da))
                    dep_seq.append(check_i32(ds, 'dep seq'))
                dep_ptr.append(len(dep_actor))
                change_keys = set()
                for op in change['ops']:
                    if op['action'] not in _ACTION_NAMES:
                        raise ValueError(
                            f"block path supports set/del ops only, got "
                            f"{op['action']!r} (use the per-document path)")
                    if op['obj'] != ROOT_ID:
                        raise ValueError(
                            'block path supports root-map fields only '
                            '(use the per-document path)')
                    action.append(_ACTION_NAMES[op['action']])
                    k = _intern(keys, key_of, op['key'])
                    if k in change_keys:
                        dup_keys = True
                    change_keys.add(k)
                    key.append(k)
                    if op['action'] == 'set':
                        value.append(len(values))
                        values.append(op.get('value'))
                    else:
                        value.append(-1)
                op_ptr.append(len(action))

        if n_docs is None:
            n_docs = len(changes_per_doc)
        elif n_docs < len(changes_per_doc):
            raise ValueError(
                f'n_docs={n_docs} < {len(changes_per_doc)} change lists')
        return cls(n_docs,
                   np.asarray(doc, np.int32), np.asarray(actor, np.int32),
                   np.asarray(seq, np.int32),
                   np.asarray(dep_ptr, np.int32),
                   np.asarray(dep_actor, np.int32),
                   np.asarray(dep_seq, np.int32),
                   np.asarray(op_ptr, np.int32),
                   np.asarray(action, np.int8), np.asarray(key, np.int32),
                   np.asarray(value, np.int32), actors, keys, values,
                   dup_keys=dup_keys)

    def to_changes(self):
        """Decode back to per-document dict change lists (lossless)."""
        out = [[] for _ in range(self.n_docs)]
        for c in range(self.n_changes):
            out[self.doc[c]].append(self.change_dict(c))
        return out

    def change_dict(self, c):
        """One change row as a reference-format dict."""
        deps = {self.actors[self.dep_actor[j]]: int(self.dep_seq[j])
                for j in range(self.dep_ptr[c], self.dep_ptr[c + 1])}
        ops = []
        if self.obj is None:                       # flat root-map block
            for j in range(self.op_ptr[c], self.op_ptr[c + 1]):
                op = {'action': _ACTION_CODES[int(self.action[j])],
                      'obj': ROOT_ID, 'key': self.keys[self.key[j]]}
                if self.action[j] == _SET:
                    op['value'] = self.values[self.value[j]]
                ops.append(op)
        else:
            for j in range(self.op_ptr[c], self.op_ptr[c + 1]):
                a = int(self.action[j])
                op = {'action': _GEN_ACTION_CODES[a],
                      'obj': self.objs[self.obj[j]]}
                kind = int(self.key_kind[j])
                if kind == _KEY_STR:
                    op['key'] = self.keys[self.key[j]]
                elif kind == _KEY_ELEM:
                    op['key'] = (f'{self.actors[self.key[j]]}:'
                                 f'{int(self.key_elem[j])}')
                elif kind == _KEY_HEAD:
                    op['key'] = '_head'
                if a == _INS:
                    op['elem'] = int(self.elem[j])
                if a in (_SET, _LINK):
                    op['value'] = self.values[self.value[j]]
                ops.append(op)
        return {'actor': self.actors[self.actor[c]],
                'seq': int(self.seq[c]), 'deps': deps, 'ops': ops}


def _csr_take(ptr, rows, payloads):
    """Gather CSR rows (returns new ptr + payload arrays)."""
    counts = np.diff(ptr)[rows]
    new_ptr = np.zeros(len(rows) + 1, np.int32)
    np.cumsum(counts, out=new_ptr[1:])
    idx = _span_indices(ptr[rows], counts)
    return new_ptr, tuple(p[idx] for p in payloads)


def _span_indices(starts, counts):
    """Concatenated [s, s+c) ranges, vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    pos = np.arange(total) - np.repeat(ends - counts, counts)
    return np.repeat(starts.astype(np.int64), counts) + pos


class PatchBlock:
    """A batch of patches (one per document), as columns.

    Field columns (length F, doc-major, sorted by (doc, key id)):
    ``f_doc``/``f_key``/``f_action`` (0 set, 1 remove)/``f_value`` (store
    value row, -1 for remove) plus winner actor ``f_actor``. The surviving
    non-winner entries (the conflicts, op_set.js:95-103) live in the
    entry columns ``s_field``/``s_actor``/``s_value``, grouped by field
    via ``s_ptr``. ``diffs``/``to_patches`` materialize reference-format
    dicts per document."""

    __slots__ = ('n_docs', 'f_ptr', 'f_doc', 'f_key', 'f_action', 'f_value',
                 'f_actor', 's_ptr', 's_actor', 's_value',
                 'keys', 'values', 'actors', 'c_doc', 'c_actor', 'c_seq')

    def __init__(self, n_docs, f_ptr, f_doc, f_key, f_action, f_value,
                 f_actor, s_ptr, s_actor, s_value, keys, values, actors,
                 c_doc, c_actor, c_seq):
        self.n_docs = n_docs
        self.f_ptr = f_ptr
        self.f_doc = f_doc
        self.f_key = f_key
        self.f_action = f_action
        self.f_value = f_value
        self.f_actor = f_actor
        self.s_ptr = s_ptr
        self.s_actor = s_actor
        self.s_value = s_value
        self.keys = keys
        self.values = values
        self.actors = actors
        self.c_doc = c_doc      # clock snapshot rows (doc-sorted)
        self.c_actor = c_actor
        self.c_seq = c_seq

    @property
    def n_fields(self):
        return len(self.f_doc)

    def clock_of(self, d):
        lo, hi = np.searchsorted(self.c_doc, [d, d + 1])
        return {self.actors[self.c_actor[j]]: int(self.c_seq[j])
                for j in range(lo, hi)}

    def diffs(self, d):
        """Reference-format diff list for one document."""
        out = []
        for f in range(self.f_ptr[d], self.f_ptr[d + 1]):
            key = self.keys[self.f_key[f]]
            if self.f_action[f] == _DEL:
                out.append({'action': 'remove', 'type': 'map',
                            'obj': ROOT_ID, 'key': key, 'path': []})
                continue
            edit = {'action': 'set', 'type': 'map', 'obj': ROOT_ID,
                    'key': key, 'path': [],
                    'value': self.values[self.f_value[f]]}
            lo, hi = self.s_ptr[f], self.s_ptr[f + 1]
            losers = [(self.actors[self.s_actor[j]],
                       self.values[self.s_value[j]]
                       if self.s_value[j] >= 0 else None)
                      for j in range(lo, hi)]
            # STABLE actor-descending (op_set.js:211): rank ties (self-
            # conflicts from one change) keep their op order
            losers.sort(key=lambda t: t[0], reverse=True)
            if losers:
                edit['conflicts'] = [{'actor': a, 'value': v}
                                     for a, v in losers]
            out.append(edit)
        return out

    def patch(self, d):
        clock = self.clock_of(d)
        return {'clock': clock, 'deps': dict(clock), 'canUndo': False,
                'canRedo': False, 'diffs': self.diffs(d)}

    def to_patches(self):
        return [self.patch(d) for d in range(self.n_docs)]


class BlockStore:
    """Struct-of-arrays state for a batch of flat map documents.

    The SURVEY §7 store. Entry columns are doc-major and field-grouped
    (sorted by compact field key), so prior entries of touched fields
    gather with boolean masks — no per-apply sorting of untouched state.
    Mutated in place by :func:`apply_block`; durability comes from the
    change log, exactly like the reference's save(). Device work runs on
    ``device`` (:func:`~..config.resolve_device`: CUDA by default).
    """

    def __init__(self, n_docs, retain_log=True, device=None):
        self.device = resolve_device(device)
        self.n_docs = n_docs
        # Retained ChangeBlocks (shared references, one append per apply)
        # back get_missing_changes — the archival role the reference's
        # opSet.history plays, with the same grows-with-history contract.
        # retain_log=False drops retention: peers can then only be served
        # via snapshots.
        self.retain_log = retain_log
        self.actors = []                      # store actor table (strings)
        self.actor_of = {}
        self.keys = []                        # store key table (strings)
        self.key_of = {}
        self.values = ValueTable()            # host value store
        z32 = np.zeros(0, np.int32)
        # survivor entries (unordered; membership via compact field keys):
        self.e_doc = z32
        self.e_key = z32
        self.e_actor = z32                    # store actor id
        self.e_seq = z32
        self.e_value = z32                    # store value row (-1: none)
        self.e_change = z32                   # change-log row (closure ref)
        # vector clocks: rows sorted by (doc << 32 | actor); c_pure marks
        # chains whose transitive closure is OWN-ONLY ({actor: seq-1}) —
        # such closures are implicit (every consumer reconstructs the own
        # entry), so pure chains skip the closure fold and store zero
        # log entries. Purity is an optimization hint: a False for an
        # actually-pure chain only costs a no-op gather, never
        # correctness.
        self.c_doc = z32
        self.c_actor = z32
        self.c_seq = z32
        self.c_pure = np.zeros(0, bool)
        # applied-change log (append order) + closure CSR per change;
        # l_order keeps a sorted view over l_key for lookups
        self.l_key = np.zeros(0, np.int64)
        self.l_order = np.zeros(0, np.int64)
        self._l_sorted = np.zeros(0, np.int64)   # cache: l_key[l_order]
        self._l_pending = []    # appended-but-unmerged (keys, base) chunks
        self.l_dep_ptr = np.zeros(1, np.int32)
        self.l_dep_actor = z32
        self.l_dep_seq = z32
        self.queue = []                       # [(doc, change dict)] buffered
        # retained changes: [(block, rows, docs)] per apply — rows are
        # admitted block rows sorted by doc (admission order within each
        # doc), docs the parallel doc column; blocks are shared refs
        self.retained = []
        # per-change wire-encode cache over the retained log:
        # (doc, actor, seq) -> compact JSON bytes. Changes are immutable
        # once applied (an inconsistent seq reuse raises at admission),
        # so entries are never invalidated; they are built lazily at
        # serve time (get_missing_changes_wire), which means every key
        # references a COMMITTED change — a rolled-back apply can never
        # leave a stale body here. With N peers each change encodes
        # once and fans out N times; retransmits reuse the same bytes.
        # Three formats share the contract: v1 entries are compact JSON
        # bytes, v2 entries (_wire_cache_v2) are columnar
        # ``(body, lits)`` pairs, v3 entries (_wire_cache_v3) the same
        # shape with RLE bodies (the session-table remap happens at
        # message assembly, so the cached encoding stays session-
        # independent and shareable across peers) — a mixed-version
        # fleet encodes each change at most once PER FORMAT.
        self._wire_cache = {}
        self._wire_cache_v2 = {}
        self._wire_cache_v3 = {}
        self._wire_cache_bytes = 0
        self.wire_cache_hits = 0
        self.wire_cache_misses = 0
        # live wire-v3 session tables registered against this store
        # (weakrefs: a closed connection's table just drops) — cleared
        # alongside the wire caches so no session-table remap state
        # survives a cache invalidation
        self._wire_sessions = []
        self.log_truncated = False            # True after snapshot resume
        self._str_rank_cache = (0, None, None)
        # per-doc state digest: XOR fold of the content hashes of every
        # ADMITTED change (order-independent — both replicas of a
        # converged doc hold the same change set, so equal clocks must
        # mean equal digests; a mismatch is silent divergence). The
        # fold is LAZY: admission appends (block, rows, docs) refs here
        # (one list append per apply — nothing on the hot path), and
        # the first digest read folds them in, so the amortized cost is
        # one canonical hash per change, paid off the apply path like
        # the wire-encode cache.
        self._digest = np.zeros(n_docs, np.uint64)
        self._digest_pending = []
        # False when the digest history is unreconstructable (a resumed
        # snapshot that predates the digest field) — such a store must
        # not advertise digests (a zero digest vs a real one would be a
        # false divergence alarm)
        self._digest_valid = True
        # compaction horizon (tiered doc storage): doc index ->
        # {'clock': {actor: seq}, 'digest': int|None, 'state': bytes}.
        # History at or behind the horizon clock has been folded into
        # the doc's encoded state snapshot ('state' — the payload the
        # sync layer ships to peers whose clock predates the horizon);
        # the retained log holds only the TAIL (changes admitted after
        # the fold). Maintained by automerge_tpu.compaction.
        self.horizon = {}

    # -- interning / lookup helpers -----------------------------------------

    def intern(self, items, table, index):
        out = np.empty(len(items), np.int32)
        for i, s in enumerate(items):
            out[i] = _intern(table, index, s)
        return out

    def actor_str_ranks(self):
        """store actor id -> rank in string order (cached per table size).
        Conflict resolution sorts by actor string (op_set.js:211); device
        ranks must preserve that order."""
        n = len(self.actors)
        if self._str_rank_cache[0] != n:
            order = np.argsort(np.asarray(self.actors, dtype=object))
            rank = np.empty(n, np.int64)
            rank[order] = np.arange(n)
            self._str_rank_cache = (n, rank, order.astype(np.int32))
        return self._str_rank_cache[1]

    def actor_by_rank(self):
        self.actor_str_ranks()
        return self._str_rank_cache[2]       # string rank -> store actor id

    def change_key(self, doc, actor, seq):
        """Composite int64 key for (doc, actor, seq) rows."""
        assert len(self.actors) < (1 << 21), 'actor table exceeds key space'
        return (((doc.astype(np.int64) << 21) | actor) << _SEQ_BITS) | seq

    def _clock_table(self):
        """The packed (doc << 32 | actor) clock key table, memoized by
        column ref identity: the hit path of :meth:`clock_merge`
        scatters seqs in place (keys unchanged), so a warm tick reuses
        one packing across lookup/merge/purity instead of repacking
        the O(clock) table three times."""
        t = getattr(self, '_c_table', None)
        if t is not None and t[0] is self.c_doc \
                and t[1] is self.c_actor:
            return t[2]
        table = (self.c_doc.astype(np.int64) << 32) | self.c_actor
        self._c_table = (self.c_doc, self.c_actor, table)
        return table

    def clock_lookup(self, doc, actor):
        """Applied seq per (doc, actor) pair — vectorized."""
        if len(self.c_doc) == 0 or len(doc) == 0:
            return np.zeros(len(doc), np.int32)
        table = self._clock_table()
        probe = (doc.astype(np.int64) << 32) | actor
        pos = np.minimum(np.searchsorted(table, probe), len(table) - 1)
        return np.where(table[pos] == probe, self.c_seq[pos], 0) \
            .astype(np.int32)

    def clock_merge(self, doc, actor, seq, pure=None):
        """Scatter-max (doc, actor, seq) rows into the sorted clock
        table; `pure` carries the chain-purity flag of each row (the
        max-seq row's purity wins per key; None = impure)."""
        if len(doc) == 0:
            return
        if pure is None:
            pure = np.zeros(len(doc), bool)
        key_new = (doc.astype(np.int64) << 32) | actor
        order = np.argsort(key_new, kind='stable')
        key_new, seq, pure = key_new[order], seq[order], pure[order]
        # max seq per distinct key (segmented max over equal-key runs);
        # purity rides in the low bit so the max picks the winner's flag
        seg_start = np.concatenate([[True], key_new[1:] != key_new[:-1]])
        packed = (seq.astype(np.int64) << 1) | pure
        seg_max = np.maximum.reduceat(packed, np.flatnonzero(seg_start))
        key_new = key_new[seg_start]
        seq = (seg_max >> 1).astype(np.int32)
        pure = (seg_max & 1).astype(bool)
        table = self._clock_table()
        pos = np.minimum(np.searchsorted(table, key_new),
                         max(len(table) - 1, 0))
        hit = (table[pos] == key_new) if len(table) else \
            np.zeros(len(key_new), bool)
        if hit.any():
            sharers = getattr(self, '_c_sharers', None)
            if sharers:
                # a live patch snapshot aliases c_seq — copy before the
                # in-place scatter so its apply-time clock stays frozen
                self.c_seq = self.c_seq.copy()
                sharers.clear()
            jr = getattr(self, '_c_journal', None)
            if jr is not None:
                # O(delta) rollback record of the in-place scatter (the
                # _Txn undoes these instead of copying the whole table)
                ph = pos[hit]
                jr.append((ph, self.c_seq[ph].copy(),
                           self.c_pure[ph].copy(),
                           self.c_seq, self.c_pure))
            adv = seq[hit] > self.c_seq[pos[hit]]
            np.maximum.at(self.c_seq, pos[hit], seq[hit])
            self.c_pure[pos[hit][adv]] = pure[hit][adv]
        if (~hit).any():
            all_key = np.concatenate([table, key_new[~hit]])
            all_seq = np.concatenate([self.c_seq, seq[~hit]])
            all_pure = np.concatenate([self.c_pure, pure[~hit]])
            order = np.argsort(all_key, kind='stable')
            all_key, all_seq = all_key[order], all_seq[order]
            self.c_doc = (all_key >> 32).astype(np.int32)
            self.c_actor = (all_key & 0xFFFFFFFF).astype(np.int32)
            self.c_seq = all_seq.astype(np.int32)
            self.c_pure = all_pure[order]
            # the replaced arrays are frozen now — snapshots aliasing
            # them need no copy-on-write protection anymore
            sh = getattr(self, '_c_sharers', None)
            if sh:
                sh.clear()

    def clock_pure_lookup(self, doc, actor):
        """Chain purity per (doc, actor) pair (False on miss)."""
        if len(self.c_doc) == 0 or len(doc) == 0:
            return np.zeros(len(doc), bool)
        table = self._clock_table()
        probe = (doc.astype(np.int64) << 32) | actor
        pos = np.minimum(np.searchsorted(table, probe), len(table) - 1)
        return np.where(table[pos] == probe, self.c_pure[pos], False)

    def clock_of(self, d):
        lo, hi = np.searchsorted(self.c_doc, [d, d + 1])
        return {self.actors[self.c_actor[j]]: int(self.c_seq[j])
                for j in range(lo, hi) if self.c_seq[j] > 0}

    def doc_fields(self, d):
        """{key: [(actor, value), ...] winner first (actor-descending)}
        for one document — the test/inspection surface."""
        out = {}
        for j in np.flatnonzero(self.e_doc == d):
            key = self.keys[self.e_key[j]]
            out.setdefault(key, []).append(
                (self.actors[self.e_actor[j]],
                 self.values[self.e_value[j]] if self.e_value[j] >= 0
                 else None))
        return {k: sorted(v, key=lambda t: t[0], reverse=True)
                for k, v in out.items()}

    def log_sorted_keys(self):
        """l_key in sorted order. The sorted view merges lazily: appends
        park in ``_l_pending`` and fold in here, on DEMAND — pure chain
        streams never consult the log during admission, so they skip the
        O(log-size) merge every apply."""
        if self._l_pending:
            pend_keys = np.concatenate(
                [k for k, b in self._l_pending])
            pend_rows = np.concatenate(
                [b + np.arange(len(k), dtype=np.int64)
                 for k, b in self._l_pending])
            self._l_pending = []
            order_p = np.argsort(pend_keys, kind='stable')
            pend_sorted = pend_keys[order_p]
            if len(self._l_sorted) != len(self.l_order):
                self._l_sorted = self.l_key[self.l_order]
            pos = np.searchsorted(self._l_sorted, pend_sorted)
            self.l_order = np.insert(self.l_order, pos,
                                     pend_rows[order_p])
            self._l_sorted = np.insert(self._l_sorted, pos, pend_sorted)
        elif len(self._l_sorted) != len(self.l_order):
            # stale cache (e.g. a snapshot load set l_order directly)
            self._l_sorted = self.l_key[self.l_order]
        return self._l_sorted

    def merge_queued_into(self, block):
        """Fold this store's buffered queue into an incoming block (the
        general store overrides with its own encoder)."""
        return _merge_queued(block, self.queue)

    def get_missing_deps(self):
        """Unmet deps of buffered changes (op_set.js:347-358)."""
        missing = {}
        for d, change in self.queue:
            deps = dict(change['deps'])
            deps[change['actor']] = change['seq'] - 1
            clock = self.clock_of(d)
            for a, s in deps.items():
                if clock.get(a, 0) < s:
                    missing[a] = max(s, missing.get(a, 0))
        return missing

    def _missing_retained(self, d, have_deps):
        """Retained-log rows of document `d` a peer with clock
        `have_deps` lacks, in admission (causal) order: a list of
        ``(block, row, actor_str, seq)``. Shared by the dict serve path
        (:meth:`get_missing_changes`) and the wire serve path
        (:meth:`get_missing_changes_wire`); raises the same
        retention/truncation errors for both."""
        clock = self.clock_of(d)
        if all(have_deps.get(a, 0) >= s for a, s in clock.items()):
            return []
        rec = self.horizon.get(d)
        if rec is not None and \
                not all(have_deps.get(a, 0) >= s
                        for a, s in rec['clock'].items()):
            # the peer predates the fold point: the bodies it needs
            # were folded into the state snapshot — the sync layer
            # ships that (plus the tail below) instead of history
            raise HorizonTruncated(d)
        if not self.retain_log and not self.log_truncated:
            raise ValueError(
                'change-log retention is disabled on this store '
                '(retain_log=False); serve lagging peers a snapshot')
        out = []
        for block, rows, docs in self.retained:
            lo, hi = np.searchsorted(docs, [d, d + 1])
            for c in rows[lo:hi]:
                c = int(c)
                actor = block.actors[block.actor[c]]
                seq = int(block.seq[c])
                if seq > have_deps.get(actor, 0):
                    out.append((block, c, actor, seq))
        if self.log_truncated:
            # per actor the retained seqs run (resume point, clock]; a
            # peer needing anything below that range cannot be served
            min_seq = {}
            for _, _, a, s in out:
                min_seq[a] = min(min_seq.get(a, s), s)
            for a, s in clock.items():
                h = have_deps.get(a, 0)
                if h < s and (a not in min_seq or h + 1 < min_seq[a]):
                    raise ValueError(
                        'change log truncated by a snapshot resume; a '
                        'peer this far behind needs the snapshot or the '
                        'full log')
        return out

    def get_missing_changes(self, d, have_deps):
        """Changes applied to document `d` that a peer with clock
        `have_deps` lacks, in admission (causal) order — the Connection
        primitive for bulk stores (src/connection.js:58-66). The log is
        the retained ChangeBlocks (indexed per doc; converged peers
        short-circuit without touching it); after a snapshot resume it
        only goes back to the resume point (older gaps raise, like the
        per-doc backend)."""
        return [block.change_dict(c) for block, c, _, _
                in self._missing_retained(d, have_deps)]

    def get_missing_changes_wire(self, d, have_deps, version=1):
        """The wire-path twin of :meth:`get_missing_changes`: the same
        missing changes, as their compact wire encodings (one entry
        per change, admission order) served from the per-change encode
        cache — ``version=1`` JSON bytes, ``version=2`` columnar
        ``(body, lits)`` pairs. On a miss the encodings build in one
        batched emit per retained block (native C++ when available)
        and stay cached forever — a fan-out to N peers (or a
        retransmit) re-serves the same bytes with zero re-encode.
        Raises exactly the retention/truncation errors of the dict
        path."""
        blobs, errors = self.get_missing_changes_wire_batch(
            [(d, have_deps)], version=version)
        if d in errors:
            raise errors[d]
        return blobs[d]

    def get_missing_changes_wire_batch(self, wants, all_clocks=None,
                                       version=1):
        """Fleet-grained wire serve: ``wants`` is ``[(doc,
        have_deps)]``; returns ``({doc: [bytes, ...]}, {doc: error})``
        where ``error`` is the retention/truncation ValueError the dict
        path would raise for that doc (the caller's snapshot-fallback
        candidates — other docs still serve). ALL cache misses across
        every requested doc emit in ONE batched pass per retained
        block, so a multi-doc tick pays one native call, not one per
        document. ``all_clocks`` lets a caller that already swept the
        fleet clocks (``clocks_all``) share the pass."""
        sels, errors = {}, {}
        # fleet-grained converged short-circuit: ONE pass over the
        # clock rows replaces a clock_of (searchsorted + dict build)
        # per requested doc — on a steady-state tick most peers are
        # caught up and never reach the retained-log scan
        if all_clocks is None and len(wants) > 16 and \
                hasattr(self, 'clocks_all'):
            all_clocks = self.clocks_all()
        # bulk gather for EMPTY have-clocks (a fresh peer's full sync,
        # the 10k-doc bench shape): every retained row of the wanted
        # docs is missing by definition, so the rows of all such docs
        # gather per retained block in one vectorized pass instead of
        # a clock_of + searchsorted per document. Truncated/unretained
        # logs keep the per-doc path (its errors are per doc).
        fresh = [d for d, have_deps in wants
                 if not have_deps and d not in self.horizon] \
            if len(wants) > 16 and self.retain_log \
            and not self.log_truncated else []
        if fresh:
            for d in fresh:
                sels[d] = []
            want_arr = np.asarray(sorted(fresh), np.int64)
            for block, rows, docs in self.retained:
                lo = np.searchsorted(docs, want_arr)
                hi = np.searchsorted(docs, want_arr + 1)
                pos = _span_indices(lo, hi - lo)
                if not len(pos):
                    continue
                rr = rows[pos]
                dd = np.repeat(want_arr, hi - lo)
                actors = block.actors
                a_ids = block.actor[rr].tolist()
                seqs = block.seq[rr].tolist()
                for d, c, a, s in zip(dd.tolist(), rr.tolist(),
                                      a_ids, seqs):
                    sels[d].append((block, c, actors[a], s))
        for d, have_deps in wants:
            if d in sels:
                continue
            if all_clocks is not None:
                clock = all_clocks.get(d, {})
                if all(have_deps.get(a, 0) >= s
                       for a, s in clock.items()):
                    sels[d] = []
                    continue
            try:
                sels[d] = self._missing_retained(d, have_deps)
            except ValueError as err:
                errors[d] = err
        cache = self._wire_cache if version == 1 else \
            self._wire_cache_v2 if version == 2 else \
            self._wire_cache_v3
        out = {}
        # one cache probe per change: misses record their output slot
        # and are patched in place after the per-block batched emit
        misses = {}        # id(block) -> (block, [(row, key, lst, i)])
        n_total = 0
        for d, sel in sels.items():
            blobs = []
            for block, c, actor, seq in sel:
                key = (d, actor, seq)
                b = cache.get(key)
                if b is None:
                    misses.setdefault(id(block), (block, []))[1] \
                        .append((c, key, blobs, len(blobs)))
                blobs.append(b)
            out[d] = blobs
            n_total += len(blobs)
        n_miss = 0
        if misses:
            from .. import wire as _wire
            encoder = _wire.encode_change_rows if version == 1 \
                else _wire.encode_change_rows_columnar if version == 2 \
                else _wire.encode_change_rows_columnar_v3
            for block, entries in misses.values():
                n_miss += len(entries)
                encoded = encoder(block, [c for c, _, _, _ in entries])
                for (c, key, lst, i), blob in zip(entries, encoded):
                    cache[key] = blob
                    self._wire_cache_bytes += _wire_entry_bytes(blob)
                    lst[i] = blob
            metrics.set_gauge('sync_wire_cache_bytes',
                              self._wire_cache_bytes)
        self.wire_cache_misses += n_miss
        self.wire_cache_hits += n_total - n_miss
        metrics.bump('wire_encode_cache_misses', n_miss)
        metrics.bump('wire_encode_cache_hits', n_total - n_miss)
        return out, errors

    def adopt_wire_cache(self, old_store, drop_docs=()):
        """Carry the per-change encode caches (all three wire formats)
        across a store rebuild (doc eviction), DROPPING the evicted
        docs' entries. Safe under the cache's never-invalidate
        contract: every surviving entry was created at serve time from
        a committed retained change of ``old_store``, and this store
        was rebuilt by re-applying that same retained log — the same
        ``(doc, actor, seq)`` holds the same change body, so the
        cached bytes stay exact. Entries of ``drop_docs`` are released
        with the docs' store rows (an evicted doc that faults back in
        re-encodes on next serve). Live session-table registrations
        carry over too — their remap state is content-addressed, so a
        rebuild never invalidates it, but a clear must still reach
        them."""
        drop = set(int(d) for d in drop_docs)
        kept = {k: v for k, v in old_store._wire_cache.items()
                if k[0] not in drop}
        kept2 = {k: v for k, v in old_store._wire_cache_v2.items()
                 if k[0] not in drop}
        kept3 = {k: v for k, v in old_store._wire_cache_v3.items()
                 if k[0] not in drop}
        self._wire_cache = kept
        self._wire_cache_v2 = kept2
        self._wire_cache_v3 = kept3
        self._wire_cache_bytes = \
            sum(len(v) for v in kept.values()) + \
            sum(_wire_entry_bytes(v) for v in kept2.values()) + \
            sum(_wire_entry_bytes(v) for v in kept3.values())
        self.wire_cache_hits = old_store.wire_cache_hits
        self.wire_cache_misses = old_store.wire_cache_misses
        self._wire_sessions = [ref for ref in old_store._wire_sessions
                               if ref() is not None]
        metrics.set_gauge('sync_wire_cache_bytes',
                          self._wire_cache_bytes)

    def register_wire_session(self, table):
        """Track a live wire-v3 sender session table against this
        store (weakref — a closed connection's table just drops), so
        :meth:`clear_wire_cache` can reset session remap state along
        with the encodings it was built over."""
        import weakref
        self._wire_sessions = [ref for ref in self._wire_sessions
                               if ref() is not None]
        self._wire_sessions.append(weakref.ref(table))

    def clear_wire_cache(self):
        """Drop every cached change encoding (all formats) AND reset
        every registered wire-v3 session table (each mints a fresh
        epoch, so peers simply see a new sid and re-learn defs) — a
        bench/test hook; the caches refill lazily at next serve."""
        self._wire_cache.clear()
        self._wire_cache_v2.clear()
        self._wire_cache_v3.clear()
        self._wire_cache_bytes = 0
        self.wire_cache_hits = self.wire_cache_misses = 0
        for ref in self._wire_sessions:
            table = ref()
            if table is not None:
                table.reset()
        self._wire_sessions = [ref for ref in self._wire_sessions
                               if ref() is not None]
        metrics.set_gauge('sync_wire_cache_bytes', 0)

    # -- per-doc state digests ----------------------------------------------

    def _fold_digests(self):
        """Fold the admission-time pending refs into the digest array.
        The array is replaced (copy-on-fold), never mutated in place,
        so a rollback snapshot holding the pre-fold reference stays
        valid, and concurrent readers see either the old or the new
        fold, never a half-applied one."""
        pending, self._digest_pending = self._digest_pending, []
        if not pending:
            return
        dig = self._digest.copy()
        for block, rows, docs in pending:
            for c, d in zip(rows.tolist(), docs.tolist()):
                dig[d] ^= np.uint64(change_hash(block.change_dict(c)))
        self._digest = dig

    def digest_of(self, d):
        """The incremental state digest of document ``d`` (0 = no
        admitted changes)."""
        self._fold_digests()
        return int(self._digest[d])

    def digests_all(self):
        """The whole digest array (uint64, doc axis) after folding —
        the heartbeat surface reads every doc at once."""
        self._fold_digests()
        return self._digest

    def digest_recompute(self, d):
        """O(doc) from-scratch digest over the retained log — the
        parity oracle for the incremental fold (raises the usual
        retention errors when the log cannot serve the full history).
        On a compacted doc the fold starts from the digest recorded at
        the horizon and covers only the retained tail — the state
        snapshot carries the pre-horizon XOR exactly so this oracle
        keeps working after the bodies are gone."""
        rec = self.horizon.get(d)
        if rec is not None:
            if rec.get('digest') is None:
                raise ValueError(
                    f'doc {d} was compacted without a valid digest; '
                    f'its history digest cannot be recomputed')
            out = rec['digest']
            have = rec['clock']
        else:
            out = 0
            have = {}
        for change in self.get_missing_changes(d, have):
            out ^= change_hash(change)
        return out

    def state_snapshot_bytes(self):
        """Total resident bytes of the per-doc horizon state snapshots
        (the ``mem_state_snapshot_bytes`` gauge reads this)."""
        return sum(len(rec['state']) for rec in self.horizon.values()
                   if rec.get('state') is not None)


def init_store(n_docs, device=None):
    return BlockStore(n_docs, device=device)


# -- per-doc local actor coordinates -----------------------------------------

# delta-host master switch: False disables every persistent host-side
# staging fast path across the engine (the _LocalActors memo below,
# general.py's staging caches, sorted field index, commit slice path
# and suffix-window renumber) — the whole-plane A/B arm of
# bench_incremental_order's host_tick band and the parity oracle for
# the cached paths. None/True = on.
_DELTA_HOST = None


def _delta_host_on():
    return _DELTA_HOST is not False


class _LocalActors:
    """Per-document actor slots, ordered by actor STRING rank within each
    document — the rank order the conflict kernel relies on
    (op_set.js:211). Built once per apply from every (doc, actor) pair
    that can appear in a clock row."""

    def __init__(self, store, pair_doc, pair_actor):
        self.str_rank = store.actor_str_ranks()
        by_rank = store.actor_by_rank()
        key = (pair_doc.astype(np.int64) << 32) | self.str_rank[pair_actor]
        self.key = np.unique(key)
        la_doc = (self.key >> 32).astype(np.int32)
        self.store_id = by_rank[(self.key & 0xFFFFFFFF).astype(np.int64)]
        self.doc_start = np.searchsorted(
            la_doc, np.arange(store.n_docs + 1)).astype(np.int64)
        self.local = np.arange(len(self.key), dtype=np.int32) - \
            self.doc_start[la_doc].astype(np.int32)
        self.width = int(np.diff(self.doc_start).max()) \
            if len(self.key) else 1

    def local_of(self, doc, store_actor):
        """Local slot per (doc, store actor) pair — pairs must be in the
        universe (guaranteed by construction)."""
        key = (doc.astype(np.int64) << 32) | self.str_rank[store_actor]
        return self.local[np.searchsorted(self.key, key)]

    def store_of(self, doc, local):
        return self.store_id[self.doc_start[doc] + local]


def _local_actors_for(store, block, b_actor, dep_actor_store, dep_doc):
    """O(delta) _LocalActors for warm stores: the previous apply's
    universe is reused when the clock pair set (ref identity of
    c_doc/c_actor — replaced only when a NEW (doc, actor) pair merges)
    and the actor string table are unchanged and every pair this block
    mentions is already a member. The reused universe may be a strict
    superset of a cold build (pairs from since-buffered changes) —
    locals stay ordered by actor string rank within each doc, which is
    the only property the kernels rely on. Anything else rebuilds from
    the full clock (O(clock pairs log) — the legacy per-tick cost)."""
    cached = getattr(store, '_la_cache', None) if _delta_host_on() \
        else None
    if cached is not None:
        c_doc_ref, c_actor_ref, n_act, la = cached
        if (c_doc_ref is store.c_doc and c_actor_ref is store.c_actor
                and n_act == len(store.actors)):
            pd = np.concatenate([block.doc, dep_doc])
            pa = np.concatenate([b_actor, dep_actor_store])
            if not len(pd):
                return la
            if len(la.key):
                key = (pd.astype(np.int64) << 32) | la.str_rank[pa]
                p = np.minimum(np.searchsorted(la.key, key),
                               len(la.key) - 1)
                if (la.key[p] == key).all():
                    return la
    la = _LocalActors(
        store,
        np.concatenate([block.doc, dep_doc, store.c_doc]),
        np.concatenate([b_actor, dep_actor_store, store.c_actor]))
    store._la_cache = (store.c_doc, store.c_actor,
                       len(store.actors), la)
    return la


# -- vectorized causal admission ---------------------------------------------

def _body_index(store):
    """(doc, actor, seq) -> (block, row) over the retained blocks, built
    lazily on the first duplicate verification and EXTENDED incrementally
    as the (append-only) retained list grows — overlapping resyncs
    verify O(1) per duplicate instead of rescanning history."""
    seen, index = getattr(store, '_body_index_cache', (0, None))
    if index is None:
        index = {}
    for blk, rows, docs in store.retained[seen:]:
        actors = blk.actors
        b_actor, b_seq = blk.actor, blk.seq
        for r, d in zip(rows.tolist(), docs.tolist()):
            index[(d, actors[b_actor[r]], int(b_seq[r]))] = (blk, r)
    store._body_index_cache = (len(store.retained), index)
    return index


def _verify_duplicate(store, block, c):
    """A change whose seq is already applied must equal the applied one
    (op_set.js:243-248). Bodies live in the retained blocks; when the log
    is truncated (snapshot resume) or retention is off, the duplicate is
    dropped unverified — the same contract as the per-doc backend's
    snapshot-era entries."""
    d = int(block.doc[c])
    a = block.actors[block.actor[c]]
    s = int(block.seq[c])
    hit = _body_index(store).get((d, a, s))
    if hit is not None:
        blk, r = hit
        if blk.change_dict(int(r)) != block.change_dict(c):
            raise ValueError(
                f'Inconsistent reuse of sequence number {s} by {a}')


def _admit_block(store, block, b_actor, dep_actor_store, la):
    """Fixed-point causal delivery over the whole block (vectorized waves).

    Returns (admitted mask, leftover mask, R) where R[c] is the dense
    [C, A_loc] transitive-deps clock of change c in doc-local actor
    coordinates — the batch analogue of the oracle's per-change
    ``all_deps`` (op_set.js:29-37). Updates the store clock and change
    log. Duplicate changes — seq already applied, or a second copy of
    the same (doc, actor, seq) within the block — are verified against
    the applied body (raising on an inconsistent seq reuse, like the
    oracle, op_set.js:243-248) and dropped; with retention off or a
    truncated log the check is skipped and the duplicate drops
    unverified.
    """
    C = block.n_changes
    doc, seq = block.doc, block.seq
    a_pad = max(la.width, 1)
    R = np.zeros((C, a_pad), np.int32)

    in_key = store.change_key(doc, b_actor, seq)
    in_order = np.argsort(in_key, kind='stable')
    in_sorted = in_key[in_order]

    dep_change = np.repeat(np.arange(C, dtype=np.int64),
                           np.diff(block.dep_ptr))
    dep_seq = block.dep_seq
    b_local = la.local_of(doc, b_actor)
    dep_local = la.local_of(doc[dep_change], dep_actor_store)
    dep_key = store.change_key(doc[dep_change], dep_actor_store, dep_seq)

    def gather_closure_rows(sources_key, dest, out_idx, target_doc):
        """Fill dest[out_idx] with each source change's closure row (in
        doc-local coords). In-block sources read R (same doc => same
        local coords); prior-block sources read the store log CSR."""
        if len(sources_key) == 0:
            return
        pos = np.minimum(np.searchsorted(in_sorted, sources_key),
                         max(C - 1, 0))
        src = in_order[pos]
        in_hit = (in_sorted[pos] == sources_key) if C else \
            np.zeros(len(sources_key), bool)
        in_hit = in_hit & admitted[src]
        if in_hit.any():
            dest[out_idx[in_hit]] = R[src[in_hit]]
        rest = ~in_hit
        if not rest.any():
            return
        log_sorted = store.log_sorted_keys()  # lazy merge, on demand
        if len(log_sorted):
            lpos = np.minimum(np.searchsorted(log_sorted,
                                              sources_key[rest]),
                              len(log_sorted) - 1)
            lhit = log_sorted[lpos] == sources_key[rest]
            rows = store.l_order[lpos[lhit]]
            tgt = out_idx[rest][lhit]
            counts = store.l_dep_ptr[rows + 1] - store.l_dep_ptr[rows]
            if counts.sum():
                idx = _span_indices(store.l_dep_ptr[rows], counts)
                tgt_rep = np.repeat(tgt, counts)
                cols = la.local_of(target_doc[tgt_rep],
                                   store.l_dep_actor[idx])
                dest[tgt_rep, cols] = store.l_dep_seq[idx]

    def accumulate_closures(ready, ext, pure):
        """The reference's transitiveDeps fold, vectorized for one wave
        (op_set.js:29-37): for each ready change, deps are folded IN
        ORDER (own seq-1 appended last) as merge-max of the dep's
        closure followed by SET depActor = depSeq — the set can clobber
        a higher transitive seq, so the result is order-dependent and
        deliberately NOT a pure max. Equivalent closed form per dep j:
        final[a_j] = max(s_j, suffix-max over later deps' closures),
        and pure max for non-dep actors.

        Chain-EXTENSION changes (``ext``: admitted in the same wave as
        their own-actor predecessor) fold only their LISTED deps here —
        the own-prev merge is the run prefix-max applied afterwards,
        which is exactly the reference fold because own-prev comes last:
        R[s] = elementwise-max(D_s, R[s-1]) with R[s][own] = s-1.
        """
        rdep = ready[dep_change] if len(dep_change) else np.zeros(0, bool)
        # pure chains (own-only closure) skip the fold entirely: their R
        # row stays zero and every consumer reconstructs own = seq-1
        start = ready & ~ext & ~pure
        rows_start = np.flatnonzero(start)
        prev = seq[rows_start] - 1
        has_prev = prev > 0
        # combined dep rows: block deps (wire order), own-prev LAST
        t_change = np.concatenate([dep_change[rdep],
                                   rows_start[has_prev]])
        t_actor = np.concatenate([dep_local[rdep],
                                  b_local[rows_start[has_prev]]])
        t_seq = np.concatenate([dep_seq[rdep], prev[has_prev]])
        t_key = np.concatenate([dep_key[rdep],
                                store.change_key(
                                    doc[rows_start[has_prev]],
                                    b_actor[rows_start[has_prev]],
                                    prev[has_prev])])
        live = t_seq > 0                  # depSeq <= 0 rows are skipped
        t_change, t_actor = t_change[live], t_actor[live]
        t_seq, t_key = t_seq[live], t_key[live]
        if len(t_change) == 0:
            return
        # stable sort by target change: block-dep order and the
        # trailing own-prev position survive within each group
        order = np.argsort(t_change, kind='stable')
        t_change, t_actor = t_change[order], t_actor[order]
        t_seq, t_key = t_seq[order], t_key[order]

        n_r = len(t_change)
        a_pad_ = R.shape[1]
        D = np.zeros((n_r, a_pad_), np.int32)
        gather_closure_rows(t_key, D, np.arange(n_r), doc[t_change])

        # exclusive suffix max of D within each change's run (doubling:
        # S[x] covers rows (x, x+step] of its run; clocks are >= 0 so
        # zero is the identity)
        S = np.zeros_like(D)
        same1 = np.zeros(n_r, bool)
        same1[:-1] = t_change[1:] == t_change[:-1]
        j = np.flatnonzero(same1)
        S[j] = D[j + 1]
        step = 1
        while True:
            idx = np.arange(n_r) + step
            ok = idx < n_r
            ok &= np.where(ok, t_change[np.minimum(idx, n_r - 1)]
                           == t_change, False)
            if not ok.any():
                break
            upd = np.zeros_like(S)
            upd[ok] = S[idx[ok]]
            S = np.maximum(S, upd)
            step *= 2

        # merge-max part: rows are sorted by t_change, so the per-change
        # reduction is one reduceat (np.maximum.at is unbuffered and
        # ~50x slower at this size)
        run_starts = np.flatnonzero(np.concatenate(
            [[True], t_change[1:] != t_change[:-1]]))
        reduced = np.maximum.reduceat(D, run_starts, axis=0)
        uniq = t_change[run_starts]
        R[uniq] = np.maximum(R[uniq], reduced)
        R[t_change, t_actor] = np.maximum(           # the SET override
            t_seq, S[np.arange(n_r), t_actor])

    # changes with any LIVE listed dep can never be chain-pure
    has_deps = np.zeros(C, bool)
    if len(dep_change):
        live0 = dep_seq > 0
        dstart0 = np.flatnonzero(np.concatenate(
            [[True], dep_change[1:] != dep_change[:-1]]))
        has_deps[dep_change[dstart0]] = \
            np.logical_or.reduceat(live0, dstart0)

    duplicate = store.clock_lookup(doc, b_actor) >= seq
    # a duplicate must MATCH what was applied (op_set.js:243-248); check
    # before any store mutation so a mismatch leaves the store untouched
    for c in np.flatnonzero(duplicate):
        _verify_duplicate(store, block, int(c))
    # in-block duplicates: keep only the first row per (doc, actor, seq),
    # verifying the dropped copies equal the kept one
    if C:
        dup_sorted = np.zeros(C, bool)
        dup_sorted[1:] = in_sorted[1:] == in_sorted[:-1]
        if dup_sorted.any():
            first_of_run = np.maximum.accumulate(
                np.where(dup_sorted, -1, np.arange(C)))
            for i in np.flatnonzero(dup_sorted):
                kept = int(in_order[first_of_run[i]])
                dup = int(in_order[i])
                if not duplicate[kept] and \
                        block.change_dict(kept) != block.change_dict(dup):
                    raise ValueError(
                        f'Inconsistent reuse of sequence number '
                        f'{int(block.seq[dup])} by '
                        f'{block.actors[block.actor[dup]]}')
        duplicate[in_order[dup_sorted]] = True
    pending = ~duplicate
    admitted = np.zeros(C, bool)
    adm_waves = []                   # rows per wave -> admission order

    while True:                      # terminates: pending shrinks per wave
        if not pending.any():
            break
        own_prev = store.clock_lookup(doc, b_actor)
        chain_ok = seq == own_prev + 1
        dep_ok = np.ones(C, bool)
        if len(dep_change):
            dep_have = store.clock_lookup(doc[dep_change], dep_actor_store)
            sat = dep_have >= dep_seq
            # dep_change is sorted (a repeat of arange): per-change AND
            # via reduceat on the runs
            dstart = np.flatnonzero(np.concatenate(
                [[True], dep_change[1:] != dep_change[:-1]]))
            dep_ok[dep_change[dstart]] = \
                np.logical_and.reduceat(sat, dstart)
        # RUN admission: a maximal contiguous per-(doc, actor) seq run
        # whose every element's LISTED deps are satisfied by the
        # pre-wave clock admits as a unit — so a 100k-change single-
        # actor chain takes ONE wave, not 100k. (Waves now count only
        # cross-actor dependency depth within the block.)
        X = pending & dep_ok
        xs = X[in_order]
        ks = in_sorted
        start_ok_s = (pending & chain_ok & dep_ok)[in_order]
        brk = np.ones(C, bool)
        if C > 1:
            brk[1:] = (ks[1:] != ks[:-1] + 1) | ~xs[:-1]
        run_id = np.cumsum(brk) - 1
        run_start_ok = start_ok_s[np.flatnonzero(brk)]
        ready_s = xs & run_start_ok[run_id]
        if not ready_s.any():
            break
        ready = np.zeros(C, bool)
        ready[in_order[ready_s]] = True
        ext_s = ready_s & ~brk                   # chain extensions
        ext = np.zeros(C, bool)
        ext[in_order[ext_s]] = True

        # ---- chain purity, per sorted row: pure iff no live deps, and
        # the run start inherits purity (seq 1, or a pure clock chain);
        # one impure element poisons the rest of its run ----
        idxC = np.arange(C)
        start_s = ready_s & brk
        start_imp = np.zeros(C, bool)
        pos_s = np.flatnonzero(start_s)
        if len(pos_s):
            rows0 = in_order[pos_s]
            start_imp[pos_s] = np.where(
                seq[rows0] == 1, False,
                ~store.clock_pure_lookup(doc[rows0], b_actor[rows0]))
        base_imp = (has_deps[in_order] | start_imp) & ready_s
        run_first = np.maximum.accumulate(np.where(brk, idxC, -1))
        last_imp = np.maximum.accumulate(np.where(base_imp, idxC, -1))
        impure_s = ready_s & (last_imp >= run_first)
        pure = np.zeros(C, bool)
        pure[in_order[ready_s & ~impure_s]] = True

        accumulate_closures(ready, ext, pure)
        if ext_s.any():
            # segmented prefix max along runs (Hillis–Steele doubling),
            # then the exact own-seq SET (the fold's last step)
            Rs = R[in_order]
            idx = np.arange(C)
            step = 1
            while step < C:
                src = idx - step
                ok = (src >= 0) & ready_s
                srcc = np.maximum(src, 0)
                ok &= (run_id == run_id[srcc]) & ready_s[srcc]
                if ok.any():
                    np.maximum(Rs, np.where(ok[:, None], Rs[srcc], 0),
                               out=Rs)
                step <<= 1
            rows_ext = in_order[ext_s]
            R[rows_ext] = Rs[ext_s]
            imp_ext = rows_ext[~pure[rows_ext]]
            R[imp_ext, b_local[imp_ext]] = seq[imp_ext] - 1

        admitted |= ready
        pending &= ~ready
        adm_waves.append(in_order[ready_s])
        store.clock_merge(doc[ready], b_actor[ready], seq[ready],
                          pure=pure[ready])

    adm_order = np.concatenate(adm_waves) if adm_waves else \
        np.zeros(0, np.int64)
    cmap = _log_append(store, in_key, admitted, R, doc, la)
    return admitted, pending, R, cmap, adm_order


def _log_append(store, in_key, admitted, R, doc, la):
    """Append admitted changes + closures to the change log (append-order
    rows, sorted view refreshed). Returns cmap: block change row -> log
    row id (-1 for non-admitted)."""
    adm = np.flatnonzero(admitted)
    cmap = np.full(len(admitted), -1, np.int64)
    if not len(adm):
        return cmap
    base = len(store.l_key)
    cmap[adm] = base + np.arange(len(adm))
    Radm = R[adm]
    nz_r, nz_c = np.nonzero(Radm)
    ptr_new = np.zeros(len(adm), np.int32)
    counts = np.bincount(nz_r, minlength=len(adm)).astype(np.int32)
    np.cumsum(counts, out=ptr_new)
    la_actor = la.store_of(doc[adm[nz_r]], nz_c).astype(np.int32)
    la_seq = Radm[nz_r, nz_c]
    new_keys = in_key[adm]
    store.l_key = np.concatenate([store.l_key, new_keys])
    store.l_dep_ptr = np.concatenate([
        store.l_dep_ptr, store.l_dep_ptr[-1] + ptr_new])
    store.l_dep_actor = np.concatenate([store.l_dep_actor, la_actor])
    store.l_dep_seq = np.concatenate([store.l_dep_seq, la_seq])
    # the sorted view merges lazily on the next log LOOKUP
    # (log_sorted_keys) — pure chain streams never pay it
    store._l_pending.append((new_keys, base))
    return cmap


def _merge_queued(block, queue):
    """Fold buffered dict changes into an incoming block (small path).

    The block's values are NOT materialized: they carry over as a
    ValueTable segment (lazy spans stay lazy) and only the queued
    changes' values append as plain entries."""
    actors = list(block.actors)
    actor_of = {a: i for i, a in enumerate(actors)}
    keys = list(block.keys)
    key_of = {k: i for i, k in enumerate(keys)}
    values = ValueTable()
    values.extend(block.values)
    tail = []                      # queued changes' values (plain)

    doc, actor, seq = [], [], []
    dep_ptr = [int(block.dep_ptr[-1])]
    dep_actor, dep_seq = [], []
    op_ptr = [int(block.op_ptr[-1])]
    action, key, value = [], [], []
    for d, change in queue:
        doc.append(d)
        actor.append(_intern(actors, actor_of, change['actor']))
        seq.append(change['seq'])
        for da, ds in change['deps'].items():
            dep_actor.append(_intern(actors, actor_of, da))
            dep_seq.append(ds)
        dep_ptr.append(dep_ptr[0] + len(dep_actor))
        for op in change['ops']:
            action.append(_ACTION_NAMES[op['action']])
            key.append(_intern(keys, key_of, op['key']))
            if op['action'] == 'set':
                value.append(len(values) + len(tail))
                tail.append(op.get('value'))
            else:
                value.append(-1)
        op_ptr.append(op_ptr[0] + len(action))
    values.extend(tail)

    return ChangeBlock(
        block.n_docs,
        np.concatenate([block.doc, np.asarray(doc, np.int32)]),
        np.concatenate([block.actor, np.asarray(actor, np.int32)]),
        np.concatenate([block.seq, np.asarray(seq, np.int32)]),
        np.concatenate([block.dep_ptr,
                        np.asarray(dep_ptr[1:], np.int32)]),
        np.concatenate([block.dep_actor, np.asarray(dep_actor, np.int32)]),
        np.concatenate([block.dep_seq, np.asarray(dep_seq, np.int32)]),
        np.concatenate([block.op_ptr, np.asarray(op_ptr[1:], np.int32)]),
        np.concatenate([block.action, np.asarray(action, np.int8)]),
        np.concatenate([block.key, np.asarray(key, np.int32)]),
        np.concatenate([block.value, np.asarray(value, np.int32)]),
        actors, keys, values)


# -- shared host preamble -----------------------------------------------------

class _Staged:
    """Output of the shared admission preamble: the (possibly
    queue-merged) block, admission results, and the admitted ops as
    columns with store-id keys/actors and store value refs. For general
    blocks ``o_key`` is None (key semantics depend on the kind column);
    consumers use ``keep``/``a_tab``/``k_tab`` to map the raw columns."""

    __slots__ = ('block', 'admitted', 'R', 'cmap', 'la', 'b_actor',
                 'oc', 'o_doc', 'o_actor', 'o_seq', 'o_action', 'o_key',
                 'o_value', 'keep', 'a_tab', 'k_tab')


def _admit_and_stage(store, block, max_keys=None, max_actors=None):
    """Queue merge + interning + causal admission + admitted-op staging —
    the host phase shared by apply_block and DenseMapStore.

    Capacity limits are checked BEFORE any store mutation — a rejected
    block leaves the store usable AND its buffered queue intact. Values
    are interned for ADMITTED ops only — a change stuck in the queue does
    not grow ``store.values`` on every retry.
    """
    check_block_ranges(store, block)
    merged = store.merge_queued_into(block) if store.queue else block

    if max_keys is not None:
        n_keys = len(store.keys) + sum(1 for k in set(merged.keys)
                                       if k not in store.key_of)
        if n_keys > max_keys:
            raise ValueError(f'{n_keys} keys exceed key_capacity={max_keys}')
    if max_actors is not None:
        n_actors = len(store.actors) + sum(1 for a in set(merged.actors)
                                           if a not in store.actor_of)
        if n_actors > max_actors:
            raise ValueError(
                f'{n_actors} actors exceed actor_capacity={max_actors}')
    block = merged
    saved_queue, store.queue = store.queue, []

    a_tab = store.intern(block.actors, store.actors, store.actor_of)
    k_tab = store.intern(block.keys, store.keys, store.key_of)

    z32 = np.zeros(0, np.int32)
    b_actor = a_tab[block.actor] if block.n_changes else z32
    dep_actor_store = a_tab[block.dep_actor] if len(block.dep_actor) else z32

    # per-doc local actor universe: change + dep + already-applied
    # actors (memoized across applies — warm ticks reuse it in
    # O(block pairs))
    dep_doc = np.repeat(block.doc, np.diff(block.dep_ptr))
    la = _local_actors_for(store, block, b_actor, dep_actor_store,
                           dep_doc)

    try:
        admitted, leftover, R, cmap, adm_order = _admit_block(
            store, block, b_actor, dep_actor_store, la)
    except ValueError:
        # duplicate-content verification raises BEFORE any store
        # mutation; put the merged-away queue back so the store (and its
        # buffered changes) stay usable
        store.queue = saved_queue
        raise
    for c in np.flatnonzero(leftover):
        store.queue.append((int(block.doc[c]), block.change_dict(c)))
    if len(adm_order):
        # state-digest maintenance: remember the admitted rows; the
        # content hashes fold lazily on the first digest read (one
        # list append here — nothing on the apply hot path)
        store._digest_pending.append((block, adm_order,
                                      block.doc[adm_order]))
    if store.retain_log and len(adm_order):
        # doc-sorted, ADMISSION order within each doc (the causal order
        # get_missing_changes promises); stored whole — per-doc slices
        # resolve by binary search at read time, so retention is O(sort)
        doc_of = block.doc[adm_order]
        order = np.argsort(doc_of, kind='stable')
        store.retained.append((block, adm_order[order], doc_of[order]))

    # admitted ops as columns
    C = block.n_changes
    op_change = np.repeat(np.arange(C, dtype=np.int64),
                          np.diff(block.op_ptr))
    keep = admitted[op_change] if C else np.zeros(0, bool)
    oc = op_change[keep]

    st = _Staged()
    st.block = block
    st.admitted, st.R, st.cmap, st.la, st.b_actor = (admitted, R, cmap,
                                                     la, b_actor)
    st.oc = oc
    st.keep = keep
    st.a_tab, st.k_tab = a_tab, k_tab
    st.o_doc = block.doc[oc]
    st.o_actor = b_actor[oc]
    st.o_seq = block.seq[oc]
    st.o_action = block.action[keep]
    if block.is_general():
        st.o_key = None          # kind-dependent; the general engine maps
    else:
        st.o_key = k_tab[block.key[keep]] if keep.any() else z32

    # value interning, admitted ops only
    v_base = len(store.values)
    o_val = block.value[keep]
    refs = o_val[o_val >= 0]
    if admitted.all() and len(refs) == len(block.values):
        # fast path: every block value is referenced exactly once
        store.values.extend(block.values)
        st.o_value = np.where(o_val >= 0, o_val + v_base, -1) \
            .astype(np.int32)
    else:
        used = np.unique(refs)
        mapping = np.full(max(len(block.values), 1), -1, np.int64)
        mapping[used] = np.arange(len(used)) + v_base
        store.values.extend(block.values[i] for i in used.tolist())
        st.o_value = np.where(
            o_val >= 0, mapping[np.maximum(o_val, 0)], -1).astype(np.int32)
    return st


# -- apply: pack -> resolve -> unpack ----------------------------------------

def apply_block(store, block, options=None, return_timing=False):
    """`applyChanges` for the bulk path: ONE device resolution for every
    touched field of every document in the block.

    Mutates `store`; returns a :class:`PatchBlock` (or (patches, timing)
    with ``return_timing``). Duplicate changes are dropped; causally
    unready changes are buffered in ``store.queue`` (retried on the next
    apply; ``store.get_missing_deps()`` reports the gaps) — the block
    analogue of op_set.js:267-283, 347-358.
    """
    import time
    opts = _engine.as_options(options)
    if block.is_general():
        raise ValueError(
            'block carries general ops (sequences/nested objects); apply '
            'through automerge_tpu.device.general')
    t0 = time.perf_counter()
    st = _admit_and_stage(store, block)
    block = st.block
    admitted, R, cmap, la, b_actor = (st.admitted, st.R, st.cmap, st.la,
                                      st.b_actor)
    oc, o_doc, o_actor = st.oc, st.o_doc, st.o_actor
    o_seq, o_action, o_key, o_value = (st.o_seq, st.o_action, st.o_key,
                                       st.o_value)
    t1 = time.perf_counter()

    # ---- pack: admitted ops + prior entries of touched fields ----
    D = store.n_docs
    z32 = np.zeros(0, np.int32)
    if len(o_doc) == 0:
        empty = PatchBlock(
            D, np.zeros(D + 1, np.int32), z32, z32,
            np.zeros(0, np.int8), z32, z32, np.zeros(1, np.int32), z32, z32,
            store.keys, store.values, store.actors,
            store.c_doc.copy(), store.c_actor.copy(), store.c_seq.copy())
        return (empty, {'admit': t1 - t0, 'pack': 0.0, 'device': 0.0,
                        'unpack': 0.0}) if return_timing else empty

    K = max(len(store.keys), 1)
    fk_new = o_doc.astype(np.int64) * K + o_key
    e_fk = store.e_doc.astype(np.int64) * K + store.e_key
    if D * K <= (1 << 27):
        present = np.zeros(D * K, bool)
        present[fk_new] = True
        touched_fk = np.flatnonzero(present)           # sorted
        seg_of = np.full(D * K, -1, np.int64)
        seg_of[touched_fk] = np.arange(len(touched_fk))
        seg_new = seg_of[fk_new]
        prior_mask = present[e_fk] if len(e_fk) else np.zeros(0, bool)
        prior_rows = np.flatnonzero(prior_mask)
        seg_prior = seg_of[e_fk[prior_rows]]
    else:
        touched_fk, seg_new = np.unique(fk_new, return_inverse=True)
        if len(e_fk):
            pos = np.minimum(np.searchsorted(touched_fk, e_fk),
                             len(touched_fk) - 1)
            prior_mask = touched_fk[pos] == e_fk
            prior_rows = np.flatnonzero(prior_mask)
            seg_prior = pos[prior_rows]
        else:
            prior_mask = np.zeros(0, bool)
            prior_rows = np.zeros(0, np.int64)
            seg_prior = np.zeros(0, np.int64)
    F = len(touched_fk)
    f_doc = (touched_fk // K).astype(np.int32)
    f_key = (touched_fk % K).astype(np.int32)
    f_doc_start = np.searchsorted(f_doc, np.arange(D + 1)).astype(np.int64)
    S = opts.pad_segments(F)

    # flat segmented layout: no per-doc slots — the kernel reduces over
    # GLOBAL field segments, so packing is pure concatenation + padding
    p_doc = store.e_doc[prior_rows]
    n_new, n_prior = len(o_doc), len(prior_rows)
    n_rows = n_new + n_prior
    n_pad = opts.pad_ops(n_rows)
    A = opts.pad_actors(max(la.width, 1))

    def padded(new_vals, prior_vals, dtype):
        out = np.zeros(n_pad, dtype)
        out[:n_new] = new_vals
        out[n_new:n_rows] = prior_vals
        return out

    # per-op local actor ranks: computed per CHANGE for new ops (cheap),
    # per entry for priors
    rank_of_change = la.local_of(block.doc, b_actor) \
        if block.n_changes else z32
    seg_arr = padded(seg_new, seg_prior, np.int32)
    actor_arr = padded(rank_of_change[oc],
                       la.local_of(p_doc, store.e_actor[prior_rows]),
                       np.int32)
    seq_arr = padded(o_seq, store.e_seq[prior_rows], np.int32)
    del_arr = padded(o_action == _DEL, np.zeros(n_prior, bool), bool)
    valid_arr = np.zeros(n_pad, bool)
    valid_arr[:n_rows] = True
    # Clock rows: all-zero whenever every admitted change is wave-1
    # concurrent (no deps, seq 1) and no prior entries carry closures —
    # then the zeros are materialized ON DEVICE instead of shipping an
    # [n_pad, A] zero plane over PCIe.
    prior_nnz = 0
    if n_prior:
        e_log = store.e_change[prior_rows]
        prior_counts = (store.l_dep_ptr[e_log + 1]
                        - store.l_dep_ptr[e_log])
        prior_nnz = int(prior_counts.sum())
    r_any = bool(R.any())
    max_new_seq = int(o_seq.max()) if n_new else 0
    if r_any or prior_nnz or max_new_seq > 1:
        clock_arr = np.zeros((n_pad, A), np.int32)
        if r_any:
            new_clocks = R[oc]
            clock_arr[:n_new, :new_clocks.shape[1]] = new_clocks
        # the own-actor entry is IMPLICIT (always seq-1): pure chains
        # carry all-zero R rows, so reconstruct it here for every new op
        clock_arr[np.arange(n_new), actor_arr[:n_new]] = o_seq - 1
        if prior_nnz:
            idx = _span_indices(store.l_dep_ptr[e_log], prior_counts)
            rows_rep = np.repeat(np.arange(n_new, n_rows), prior_counts)
            doc_rep = np.repeat(p_doc, prior_counts)
            clock_arr[rows_rep,
                      la.local_of(doc_rep, store.l_dep_actor[idx])] = \
                store.l_dep_seq[idx]
        clock_dev = torch.as_tensor(clock_arr).to(store.device)
    else:
        clock_dev = torch.zeros((n_pad, A), dtype=torch.int32,
                                device=store.device)
    t2 = time.perf_counter()

    from .merge import resolve_assignments
    if opts.kernel == 'pallas':
        raise ValueError('the block path runs the flat XLA resolve kernel; '
                         'kernel="pallas" applies to the per-document path')
    dev = store.device
    out = resolve_assignments(
        torch.as_tensor(seg_arr).to(dev), torch.as_tensor(actor_arr).to(dev),
        torch.as_tensor(seq_arr).to(dev), clock_dev,
        torch.as_tensor(del_arr).to(dev), torch.as_tensor(valid_arr).to(dev),
        num_segments=S)
    surviving = out['surviving'].cpu().numpy()[:n_rows]
    w_row = out['winner'].cpu().numpy()[:F]        # flat row id, -1 if none
    t3 = time.perf_counter()

    # ---- unpack: patch block + store update ----
    r_value = np.concatenate([o_value, store.e_value[prior_rows]])
    r_actor_store = np.concatenate([o_actor, store.e_actor[prior_rows]])
    has_winner = w_row >= 0
    w_safe = np.maximum(w_row, 0)
    f_action = np.where(has_winner, _SET, _DEL).astype(np.int8)
    f_value = np.where(has_winner, r_value[w_safe], -1).astype(np.int32)
    f_actor = np.where(has_winner, r_actor_store[w_safe], -1) \
        .astype(np.int32)

    # conflicts: surviving losers grouped by field (radix argsort on the
    # int32 segment ids keeps this O(n))
    s_rows = np.flatnonzero(surviving)
    r_seg = seg_arr[:n_rows]
    ent_is_loser = s_rows != w_row[r_seg[s_rows]]
    loser_rows = s_rows[ent_is_loser]
    loser_rows = loser_rows[np.argsort(r_seg[loser_rows], kind='stable')]
    s_counts = np.bincount(r_seg[loser_rows], minlength=F) if F else \
        np.zeros(0, np.int64)
    s_ptr = np.zeros(F + 1, np.int32)
    np.cumsum(s_counts, out=s_ptr[1:])

    patches = PatchBlock(
        D, f_doc_start.astype(np.int32), f_doc, f_key, f_action, f_value,
        f_actor, s_ptr, r_actor_store[loser_rows], r_value[loser_rows],
        store.keys, store.values, store.actors,
        store.c_doc.copy(), store.c_actor.copy(), store.c_seq.copy())

    _store_update(
        store, prior_mask, s_rows,
        np.concatenate([o_doc, p_doc]),
        np.concatenate([o_key, store.e_key[prior_rows]]),
        r_actor_store,
        np.concatenate([o_seq, store.e_seq[prior_rows]]),
        r_value,
        np.concatenate([cmap[oc].astype(np.int32),
                        store.e_change[prior_rows]]))
    t4 = time.perf_counter()

    metrics.bump('block_batches')
    metrics.bump('block_ops', n_new)
    metrics.set_gauge('block_batch_occupancy', n_rows / max(n_pad, 1))
    if return_timing:
        return patches, {'admit': t1 - t0, 'pack': t2 - t1,
                         'device': t3 - t2, 'unpack': t4 - t3}
    return patches


def _store_update(store, prior_mask, s_rows, r_doc, r_key, r_actor, r_seq,
                  r_value, r_change):
    """Replace touched fields' entries with the surviving rows. Entries
    are unordered; closures live in the change log (``e_change`` refs),
    so the update is mask + concatenate — no scatters, no CSR copies."""
    keep = ~prior_mask if len(prior_mask) else np.zeros(0, bool)
    store.e_doc = np.concatenate([store.e_doc[keep], r_doc[s_rows]])
    store.e_key = np.concatenate([store.e_key[keep], r_key[s_rows]])
    store.e_actor = np.concatenate([store.e_actor[keep], r_actor[s_rows]])
    store.e_seq = np.concatenate([store.e_seq[keep], r_seq[s_rows]])
    store.e_value = np.concatenate([store.e_value[keep], r_value[s_rows]])
    store.e_change = np.concatenate([store.e_change[keep],
                                     r_change[s_rows]])
