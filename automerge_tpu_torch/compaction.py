"""Tiered doc storage: per-doc state snapshots + the history
compaction engine.

Every durability and bootstrap surface used to carry the FULL retained
change log: snapshots, park shards, journal replay and new-peer sync
all replayed history, which is why eviction on a snapshot-resumed
store was refused (``serving_evictions_blocked_truncated``) and why a
10k-doc first contact shipped entire histories. This module folds
history into compact per-doc **state snapshots** behind an explicit
**compaction horizon** (Okapi's cheap-causal-metadata framing,
PAPERS.md: replicas stay consistent shipping compact state, not
history; Jiffy's batch snapshots are the model for cutting a
consistent state without stopping ingest):

- A **state snapshot** is one document's complete CRDT state as
  columnar op planes — surviving entries, insertion-tree nodes with
  their current visibility, the object table, the causal-closure log
  rows (compact ``(actor, seq)`` metadata, no op bodies), interned
  tables and values — plus its clock and the PR 8 blake2b state
  digest, zlib-packed inside the checksummed
  :func:`~automerge_tpu_torch.durability.pack_snapshot` container.
- :func:`compact_docset` advances the **horizon** to the current
  clock: per-doc state snapshots are extracted from the live store
  (no stop-the-world — ingest admitted after the cut lands in the
  tail), the retained log shrinks to the post-horizon tail, and the
  folded change bodies are released. ``get_missing_changes*`` then
  raises :class:`~automerge_tpu_torch.device.blocks.HorizonTruncated` for
  peers whose clock predates the horizon, and the sync layer answers
  with a ``'state'`` message (snapshot + tail) — cold-peer bootstrap
  becomes O(state + divergence) instead of O(history).
- :func:`absorb_doc_states` is the restore path shared by every
  consumer: the wire ``'state'`` receive
  (:meth:`GeneralDocSet.apply_states <automerge_tpu_torch.sync.
  general_doc_set.GeneralDocSet.apply_states>`), park-shard fault-in,
  tiered snapshot resume and journal recovery. A doc restored from
  ``state + tail`` is digest- and materialize-identical to one
  rebuilt from the full log (asserted by ``tests/test_compaction.py``
  against the host oracle, including under chaos).

Durable artifacts only change through the existing atomic
tmp+fsync+rename containers (PR 4/6): compaction itself is an
in-memory fold, and :func:`compact_and_checkpoint` makes it durable
through ``DurableDocSet.checkpoint`` — a crash anywhere in between
leaves the pre-compaction tiers (old snapshot + journal) intact.

The PyTorch port's copy of ``automerge_tpu/compaction.py`` (host code
over the store's host mirrors; the same state-snapshot format).
"""

import json
import struct
import time
import zlib

import numpy as np

from .common import ROOT_ID
from .device import general as _general
from .device.blocks import HorizonTruncated, _span_indices  # noqa: F401
from .utils.metrics import metrics

STATE_FORMAT = 'automerge-tpu-doc-state@1'
_STATE_MAGIC = b'AMDST1\n'
_LEN = struct.Struct('>I')
_ELEM_BIT = np.int64(1) << 31
_SEQ_BITS = 20          # blocks._SEQ_BITS (change_key packing)
_ACTOR_BITS = 21

# the serialized column order — decode reconstructs by this manifest
_ARRAYS = (
    # surviving entries (doc-local object/actor/key/value/log refs)
    ('e_obj', '<i4'), ('e_key', '<i8'), ('e_actor', '<i4'),
    ('e_seq', '<i4'), ('e_value', '<i4'), ('e_link', 'u1'),
    ('e_change', '<i4'),
    # causal-closure log rows (append order; compact (actor, seq)
    # pairs + dep CSR — the metadata every future admission and
    # conflict resolution reads, with no op bodies)
    ('lg_actor', '<i4'), ('lg_seq', '<i4'), ('lg_dep_ptr', '<i4'),
    ('lg_dep_actor', '<i4'), ('lg_dep_seq', '<i4'),
    # insertion-tree nodes (per seq object, local order, with the
    # CURRENT visibility — the mirror encoders rebuild device planes
    # from exactly these columns on restore)
    ('nd_obj', '<i4'), ('nd_local', '<i4'), ('nd_parent', '<i4'),
    ('nd_actor', '<i4'), ('nd_elemc', '<i4'), ('nd_vis', 'u1'),
    ('nd_visidx', '<i4'))

# v2 column extension: the device-resident sequence index (tree_pos
# per node) rides the state snapshot, so a restore rebuilds the
# mirror WITH a valid 'tp' plane and skips the whole-object
# _rga_order rebuild on first touch. The header's 'idx' flag says
# whether the column is a live index (every seq object of the doc had
# idx_ok at extraction) or mere padding. Old payloads (len(lens) ==
# len(_ARRAYS)) decode exactly as before, with no index claim.
_ARRAYS_V2 = _ARRAYS + (('nd_tpos', '<i4'),)


def encode_state_snapshot(st):
    """Serialize one extracted doc state (the dict
    :func:`extract_doc_states` builds) into the checksummed container:
    JSON header + raw little-endian column planes, zlib-compressed,
    framed by :func:`~automerge_tpu_torch.durability.pack_snapshot` (magic +
    length + CRC32 — truncation and bit rot surface as a clean
    :class:`~automerge_tpu_torch.snapshot.SnapshotCorruptError`)."""
    from .durability import pack_snapshot
    if 'nd_tpos' not in st:
        st = dict(st)
        st['nd_tpos'] = np.zeros(len(st['nd_obj']), np.int32)
        st.setdefault('idx', False)
    header = {'format': STATE_FORMAT, 'clock': st['clock'],
              'digest': st['digest'], 'actors': st['actors'],
              'keys': st['keys'], 'values': st['values'],
              'objs': st['objs'], 'inbound': st['inbound'],
              'idx': bool(st.get('idx', False)),
              'lens': [int(len(st[name])) for name, _ in _ARRAYS_V2]}
    head = json.dumps(header, separators=(',', ':')).encode()
    body = b''.join([_LEN.pack(len(head)), head] +
                    [np.ascontiguousarray(
                        st[name].astype(dtype)).tobytes()
                     for name, dtype in _ARRAYS_V2])
    return pack_snapshot(_STATE_MAGIC + zlib.compress(body, 6))


def state_warm_literals(chunks, budget=64 * 1024):
    """Deterministic wire-v3 warm-up literal list from ``'state'``
    bootstrap payloads: the actor/key strings of each snapshot's JSON
    header, as tagged wire literals, in docs order with actors before
    keys, first occurrence winning, capped at ``budget`` literal
    bytes. BOTH ends of a bootstrap derive this list from the same
    payload bytes — the serving peer from the chunks it ships, the
    bootstrapping peer from the chunks it receives — so sequential
    refs assigned from 0 in list order agree by construction
    (:meth:`~automerge_tpu_torch.wire.SessionStringTable.warm` /
    the receiver's enumerate seed). Header-only: a ``decompressobj``
    inflates just each container's JSON head, never the column
    planes. A payload that fails to parse contributes nothing (it
    will quarantine at absorb time; warm-up must never raise)."""
    from .durability import unpack_snapshot
    from .snapshot import SnapshotCorruptError
    from .wire import _TAG_STR
    lits, seen, cost = [], set(), 0
    for chunk in chunks:
        try:
            payload = unpack_snapshot(bytes(chunk))
            if payload[:len(_STATE_MAGIC)] != _STATE_MAGIC:
                continue
            d = zlib.decompressobj()
            head = d.decompress(payload[len(_STATE_MAGIC):], 4)
            (hlen,) = _LEN.unpack_from(head, 0)
            body = head[4:]
            while len(body) < hlen and d.unconsumed_tail:
                body += d.decompress(d.unconsumed_tail,
                                     hlen - len(body))
            header = json.loads(body[:hlen].decode())
        except (SnapshotCorruptError, zlib.error, struct.error,
                ValueError, UnicodeDecodeError):
            continue
        if not isinstance(header, dict) or \
                header.get('format') != STATE_FORMAT:
            continue
        for field in ('actors', 'keys'):
            strs = header.get(field)
            if not isinstance(strs, list):
                continue
            for s in strs:
                if not isinstance(s, str) or not s:
                    continue
                lit = bytes([_TAG_STR]) + s.encode('utf-8')
                if lit in seen:
                    continue
                if cost + len(lit) > budget:
                    return lits
                seen.add(lit)
                cost += len(lit)
                lits.append(lit)
    return lits


def decode_state_snapshot(data):
    """Validate + decode an :func:`encode_state_snapshot` payload back
    into the column dict. Raises
    :class:`~automerge_tpu_torch.snapshot.SnapshotCorruptError` on
    truncation/bit rot/format mismatch."""
    from .durability import unpack_snapshot
    from .snapshot import SnapshotCorruptError
    payload = unpack_snapshot(bytes(data))
    if payload[:len(_STATE_MAGIC)] != _STATE_MAGIC:
        raise SnapshotCorruptError(
            'not a doc-state snapshot (bad inner magic)')
    try:
        body = zlib.decompress(payload[len(_STATE_MAGIC):])
        (hlen,) = _LEN.unpack_from(body, 0)
        header = json.loads(body[4:4 + hlen].decode())
    except (zlib.error, struct.error, ValueError,
            UnicodeDecodeError) as err:
        raise SnapshotCorruptError(
            f'doc-state snapshot body undecodable ({err})') from None
    if not isinstance(header, dict) or \
            header.get('format') != STATE_FORMAT:
        raise SnapshotCorruptError('not a doc-state snapshot')
    lens = header.get('lens')
    if not isinstance(lens, list) or \
            len(lens) not in (len(_ARRAYS), len(_ARRAYS_V2)):
        raise SnapshotCorruptError(
            "doc-state snapshot: missing field 'lens'")
    manifest = _ARRAYS_V2 if len(lens) == len(_ARRAYS_V2) else _ARRAYS
    out = {'clock': header.get('clock') or {},
           'digest': header.get('digest'),
           'actors': header.get('actors') or [],
           'keys': header.get('keys') or [],
           'values': header.get('values') or [],
           'objs': header.get('objs') or [],
           'inbound': header.get('inbound') or {},
           'idx': bool(header.get('idx', False))
           and len(lens) == len(_ARRAYS_V2)}
    pos = 4 + hlen
    for (name, dtype), n in zip(manifest, lens):
        try:
            arr = np.frombuffer(body, dtype=dtype, count=n,
                                offset=pos)
        except ValueError:
            raise SnapshotCorruptError(
                'doc-state snapshot truncated: column planes '
                'short') from None
        pos += arr.nbytes
        out[name] = arr
    if pos > len(body):
        raise SnapshotCorruptError(
            'doc-state snapshot truncated: column planes short')
    _validate_decoded(out)
    return out


def _validate_decoded(st):
    """Bounds-check every cross-reference of a decoded state payload
    BEFORE any store mutation — a CRC-valid but internally
    inconsistent payload (a buggy or hostile encoder) must fail here
    as a clean :class:`SnapshotCorruptError` that quarantines only
    its doc, never an IndexError mid-absorb that could tear the
    batch."""
    from .snapshot import SnapshotCorruptError

    def bad(what):
        raise SnapshotCorruptError(
            f'doc-state snapshot inconsistent: {what}')

    n_actors = len(st['actors'])
    n_keys = len(st['keys'])
    n_values = len(st['values'])
    n_objs = len(st['objs'])
    n_log = len(st['lg_seq'])

    def check(arr, lo, hi, what):
        if len(arr) and (int(arr.min()) < lo or
                         int(arr.max()) >= hi):
            bad(what)

    if len(st['lg_actor']) != n_log:
        bad('log column lengths disagree')
    check(st['lg_actor'], 0, max(n_actors, 1), 'log actor ref')
    ptr = st['lg_dep_ptr']
    if len(ptr) != n_log + 1:
        bad('log dep ptr length')
    if int(ptr[0]) != 0 or (np.diff(ptr) < 0).any() or \
            int(ptr[-1]) != len(st['lg_dep_actor']):
        bad('log dep CSR malformed')
    check(st['lg_dep_actor'], 0, max(n_actors, 1), 'log dep actor')
    n_ent = len(st['e_seq'])
    for name in ('e_obj', 'e_key', 'e_actor', 'e_value', 'e_link',
                 'e_change'):
        if len(st[name]) != n_ent:
            bad('entry column lengths disagree')
    check(st['e_obj'], 0, max(n_objs, 1), 'entry object ref')
    check(st['e_actor'], 0, max(n_actors, 1), 'entry actor ref')
    check(st['e_value'], -1, max(n_values, 1), 'entry value ref')
    check(st['e_change'], -1, max(n_log, 1), 'entry log ref')
    raw_key = np.asarray(st['e_key'], np.int64)
    map_keys = raw_key[(raw_key & _ELEM_BIT) == 0]
    check(map_keys, 0, max(n_keys, 1), 'entry key ref')
    n_nodes = len(st['nd_obj'])
    for name in ('nd_local', 'nd_parent', 'nd_actor', 'nd_elemc',
                 'nd_vis', 'nd_visidx'):
        if len(st[name]) != n_nodes:
            bad('node column lengths disagree')
    if 'nd_tpos' in st and len(st['nd_tpos']) != n_nodes:
        bad('node column lengths disagree')
    check(st['nd_obj'], 0, max(n_objs, 1), 'node object ref')
    check(st['nd_actor'], -1, max(n_actors, 1), 'node actor ref')
    check(st['nd_local'], 0, 1 << 22, 'node local index')
    if 'nd_tpos' in st:
        check(st['nd_tpos'], 0, 1 << 22, 'node tree position')
    for obj in st['objs']:
        if not (isinstance(obj, list) and len(obj) == 2 and
                isinstance(obj[0], str)):
            bad('object table entry')
    for li_s, edges in st['inbound'].items():
        try:
            li = int(li_s)
        except (TypeError, ValueError):
            bad('inbound key')
        if not 0 <= li < max(n_objs, 1):
            bad('inbound object ref')
        for edge in edges:
            if not (isinstance(edge, list) and len(edge) == 2 and
                    isinstance(edge[0], int) and
                    0 <= edge[0] < n_objs):
                bad('inbound parent ref')
    for actor, seq in st['clock'].items():
        if not isinstance(actor, str) or not isinstance(seq, int) \
                or isinstance(seq, bool) or seq < 0:
            bad('clock entry')


# -- extraction (live store -> per-doc state) ---------------------------------

def extract_doc_states(store, idxs):
    """Extract the complete current state of each doc index in
    ``idxs`` from a live :class:`~automerge_tpu_torch.device.general.
    GeneralStore`, as ``{idx: {'clock', 'digest', 'state': bytes}}``
    (the horizon-record shape). One batched CSR pass over each state
    family, then O(doc state) slicing per doc — never O(fleet) per
    doc. Digests ride only when the store's digest history is valid.
    """
    store._commit_pending()
    store.pool.sync()
    store.pool.sync_index()      # the order index rides the state
    #                              snapshot (docs with idx_ok claims)
    store._fold_digests()
    pool = store.pool
    digests_ok = getattr(store, '_digest_valid', False)

    # batched group-by-doc CSRs over entries, objects and log rows
    e_order = np.argsort(store.e_doc, kind='stable')
    e_sorted = store.e_doc[e_order]
    obj_doc_arr, obj_type_arr = store.obj_arrays()
    o_order = np.argsort(obj_doc_arr, kind='stable') \
        if len(obj_doc_arr) else np.zeros(0, np.int64)
    o_sorted = obj_doc_arr[o_order] if len(obj_doc_arr) else \
        np.zeros(0, np.int32)
    l_doc = (store.l_key >> (_ACTOR_BITS + _SEQ_BITS)).astype(np.int64)
    l_order = np.argsort(l_doc, kind='stable')
    l_sorted = l_doc[l_order]

    out = {}
    for d in idxs:
        out[d] = _extract_one(store, pool, d, e_order, e_sorted,
                              o_order, o_sorted, l_order, l_sorted,
                              obj_type_arr, digests_ok)
    return out


def _extract_one(store, pool, d, e_order, e_sorted, o_order, o_sorted,
                 l_order, l_sorted, obj_type_arr, digests_ok):
    actors, actor_of = [], {}
    keys, key_of = [], {}

    def amap(ids):
        ids = np.asarray(ids, np.int64)
        out = np.empty(len(ids), np.int32)
        tab = store.actors
        for i, a in enumerate(ids.tolist()):
            if a < 0:
                out[i] = -1
                continue
            s = tab[a]
            j = actor_of.get(s)
            if j is None:
                j = actor_of[s] = len(actors)
                actors.append(s)
            out[i] = j
        return out

    # objects of the doc, ascending global row order -> local index
    lo, hi = np.searchsorted(o_sorted, [d, d + 1])
    obj_rows = np.sort(o_order[lo:hi]).astype(np.int64)
    objs = [[store.obj_uuid[r], int(obj_type_arr[r])]
            for r in obj_rows.tolist()]
    inbound = {}
    for li, r in enumerate(obj_rows.tolist()):
        edges = store.obj_inbound.get(r)
        if edges:
            pos = np.searchsorted(obj_rows, [p for p, _ in edges])
            inbound[str(li)] = [[int(p), k]
                                for p, (_, k) in zip(pos.tolist(),
                                                     edges)]

    # insertion-tree nodes of the doc's sequence objects
    seq_objs = obj_rows[np.isin(obj_type_arr[obj_rows],
                                (_general._TYPE_LIST,
                                 _general._TYPE_TEXT))] \
        if len(obj_rows) else obj_rows
    if len(seq_objs):
        rows, counts = pool.rows_of_objs(seq_objs)
        nd_obj = np.repeat(
            np.searchsorted(obj_rows, seq_objs).astype(np.int32),
            counts)
        nd_local = pool.local[rows]
        nd_parent = pool.parent[rows]
        nd_actor = amap(pool.actor[rows])
        nd_elemc = pool.elemc[rows]
        nd_vis = pool.visible[rows].astype(np.uint8)
        nd_visidx = pool.vis_index[rows]
        nd_tpos = pool.tpos[rows]
        # a live index claim only when EVERY seq object of the doc is
        # index-valid (absorb sets idx_ok per object anyway; the
        # all-or-nothing flag keeps the header one bit)
        idx_ok = bool(pool.idx_ok[seq_objs].all()) \
            if len(pool.idx_ok) > int(seq_objs.max()) else False
    else:
        z = np.zeros(0, np.int32)
        nd_obj = nd_local = nd_parent = nd_actor = nd_elemc = \
            nd_visidx = nd_tpos = z
        nd_vis = np.zeros(0, np.uint8)
        idx_ok = True            # vacuously: nothing to rebuild

    # causal-closure log rows (append order within the doc)
    llo, lhi = np.searchsorted(l_sorted, [d, d + 1])
    log_rows = np.sort(l_order[llo:lhi]).astype(np.int64)
    lkeys = store.l_key[log_rows]
    lg_actor = amap((lkeys >> _SEQ_BITS) & ((1 << _ACTOR_BITS) - 1))
    lg_seq = (lkeys & ((1 << _SEQ_BITS) - 1)).astype(np.int32)
    dep_counts = (store.l_dep_ptr[log_rows + 1] -
                  store.l_dep_ptr[log_rows]).astype(np.int64)
    lg_dep_ptr = np.zeros(len(log_rows) + 1, np.int32)
    if len(log_rows):
        np.cumsum(dep_counts, out=lg_dep_ptr[1:])
    dep_idx = _span_indices(store.l_dep_ptr[log_rows].astype(np.int64),
                            dep_counts)
    lg_dep_actor = amap(store.l_dep_actor[dep_idx])
    lg_dep_seq = store.l_dep_seq[dep_idx]
    log_local = {int(r): i for i, r in enumerate(log_rows.tolist())}

    # surviving entries
    elo, ehi = np.searchsorted(e_sorted, [d, d + 1])
    ent = e_order[elo:ehi]
    raw_key = store.e_key[ent].astype(np.int64)
    is_elem = (raw_key & _ELEM_BIT) != 0
    e_key = raw_key.copy()
    for i in np.flatnonzero(~is_elem).tolist():
        s = store.keys[int(raw_key[i])]
        j = key_of.get(s)
        if j is None:
            j = key_of[s] = len(keys)
            keys.append(s)
        e_key[i] = j
    e_obj = np.searchsorted(obj_rows,
                            store.e_obj[ent]).astype(np.int32)
    e_actor = amap(store.e_actor[ent])
    e_seq = store.e_seq[ent]
    raw_val = store.e_value[ent]
    values = []
    vmap = {}
    e_value = np.empty(len(ent), np.int32)
    for i, v in enumerate(raw_val.tolist()):
        if v < 0:
            e_value[i] = -1
            continue
        j = vmap.get(v)
        if j is None:
            j = vmap[v] = len(values)
            values.append(store.values[v])
        e_value[i] = j
    e_link = store.e_link[ent].astype(np.uint8)
    e_change = np.asarray(
        [log_local.get(int(c), -1)
         for c in store.e_change[ent].tolist()], np.int32)

    st = {'clock': store.clock_of(d),
          'digest': store.digest_of(d) if digests_ok else None,
          'actors': actors, 'keys': keys, 'values': values,
          'objs': objs, 'inbound': inbound,
          'e_obj': e_obj, 'e_key': e_key, 'e_actor': e_actor,
          'e_seq': np.asarray(e_seq, np.int32), 'e_value': e_value,
          'e_link': e_link, 'e_change': e_change,
          'lg_actor': lg_actor, 'lg_seq': lg_seq,
          'lg_dep_ptr': lg_dep_ptr, 'lg_dep_actor': lg_dep_actor,
          'lg_dep_seq': np.asarray(lg_dep_seq, np.int32),
          'nd_obj': nd_obj, 'nd_local': nd_local,
          'nd_parent': nd_parent, 'nd_actor': nd_actor,
          'nd_elemc': nd_elemc, 'nd_vis': nd_vis,
          'nd_visidx': nd_visidx, 'nd_tpos': nd_tpos,
          'idx': idx_ok}
    return {'clock': st['clock'], 'digest': st['digest'],
            'state': encode_state_snapshot(st)}


# -- absorption (state -> live store) -----------------------------------------

def absorb_doc_states(store, items):
    """Restore per-doc state snapshots into a live store: ``items`` is
    ``[(idx, payload_bytes, decoded)]`` (``decoded`` optional — pass
    None to decode here). Every target doc index must be EMPTY in the
    store (no admitted changes) — callers replace a non-empty doc by
    dropping its state first. All docs' columns append in ONE bulk
    pass per state family (a 10k-doc state bootstrap is one concat,
    not 10k), the clock merges once, and the device mirror rebuilds
    once at the end. Each absorbed doc's horizon record is installed
    (clock + digest + the payload itself), so a bootstrapped replica
    can itself serve further cold peers from the same snapshot."""
    if not items:
        return
    items = [(idx, payload,
              decoded if decoded is not None
              else decode_state_snapshot(payload))
             for idx, payload, decoded in items]
    store._commit_pending()
    store.pool.sync()
    store.pool.sync_index()      # existing docs' order index must be
    #                              host-current BEFORE the mirror
    #                              rebuilds from the host columns
    store._fold_digests()
    pool = store.pool

    for idx, _, _ in items:
        if store.clock_of(idx):
            raise ValueError(
                f'absorb target doc {idx} is not empty; drop its '
                f'state first (apply_states handles the replace '
                f'path)')

    ent_chunks = {n: [] for n, _ in _ARRAYS}
    ent_doc = []
    pool_obj, pool_local, pool_parent, pool_actor = [], [], [], []
    pool_elemc, pool_vis, pool_visidx = [], [], []
    pool_tpos, idx_claims = [], []
    l_keys, l_dep_counts, l_dep_actor, l_dep_seq = [], [], [], []
    ck_doc, ck_actor, ck_seq = [], [], []
    l_base = len(store.l_key)
    v_base = len(store.values)
    any_digest_missing = False

    for idx, payload, st in items:
        a_map = store.intern(st['actors'], store.actors,
                             store.actor_of).astype(np.int64)
        k_map = store.intern(st['keys'], store.keys,
                             store.key_of).astype(np.int64)
        # object rows (appended in local order -> ascending global)
        obj_map = np.empty(len(st['objs']), np.int64)
        for li, (uuid, otype) in enumerate(st['objs']):
            row = len(store.obj_uuid)
            store.obj_of[(idx, uuid)] = row
            store.obj_uuid.append(uuid)
            store.obj_doc.append(idx)
            store.obj_type.append(int(otype))
            if uuid == ROOT_ID:
                store._root_row[idx] = row
            obj_map[li] = row
        for li_s, edges in st['inbound'].items():
            store.obj_inbound[int(obj_map[int(li_s)])] = \
                [(int(obj_map[p]), k) for p, k in edges]
        # nodes (per-object local order preserved; parents are local)
        if len(st['nd_obj']):
            pool_obj.append(obj_map[st['nd_obj']].astype(np.int32))
            pool_local.append(np.asarray(st['nd_local'], np.int32))
            pool_parent.append(np.asarray(st['nd_parent'], np.int32))
            na = np.asarray(st['nd_actor'], np.int64)
            pool_actor.append(np.where(
                na >= 0, a_map[np.maximum(na, 0)], -1)
                .astype(np.int32))
            pool_elemc.append(np.asarray(st['nd_elemc'], np.int32))
            pool_vis.append(np.asarray(st['nd_vis'], np.uint8)
                            .astype(bool))
            pool_visidx.append(np.asarray(st['nd_visidx'], np.int32))
            if 'nd_tpos' in st:
                pool_tpos.append(np.asarray(st['nd_tpos'], np.int32))
            else:
                pool_tpos.append(np.zeros(len(st['nd_obj']),
                                          np.int32))
            if st.get('idx'):
                # the snapshot shipped a live order index for this
                # doc's seq objects: claim it after grow_objects
                idx_claims.append(
                    obj_map[np.unique(st['nd_obj'])].astype(np.int64))
        # log rows
        n_log = len(st['lg_seq'])
        if n_log:
            doc_col = np.full(n_log, idx, np.int64)
            l_keys.append(store.change_key(
                doc_col, a_map[np.asarray(st['lg_actor'], np.int64)],
                np.asarray(st['lg_seq'], np.int64)))
            l_dep_counts.append(np.diff(
                np.asarray(st['lg_dep_ptr'], np.int64)))
            la = np.asarray(st['lg_dep_actor'], np.int64)
            l_dep_actor.append(a_map[la].astype(np.int32)
                               if len(la) else np.zeros(0, np.int32))
            l_dep_seq.append(np.asarray(st['lg_dep_seq'], np.int32))
        else:
            l_keys.append(np.zeros(0, np.int64))
            l_dep_counts.append(np.zeros(0, np.int64))
            l_dep_actor.append(np.zeros(0, np.int32))
            l_dep_seq.append(np.zeros(0, np.int32))
        # entries
        n_ent = len(st['e_seq'])
        if n_ent:
            ent_doc.append(np.full(n_ent, idx, np.int32))
            ent_chunks['e_obj'].append(
                obj_map[np.asarray(st['e_obj'], np.int64)]
                .astype(np.int32))
            raw_key = np.asarray(st['e_key'], np.int64)
            is_elem = (raw_key & _ELEM_BIT) != 0
            ent_chunks['e_key'].append(np.where(
                is_elem, raw_key,
                k_map[np.maximum(np.where(is_elem, 0, raw_key), 0)]))
            ent_chunks['e_actor'].append(
                a_map[np.asarray(st['e_actor'], np.int64)]
                .astype(np.int32))
            ent_chunks['e_seq'].append(
                np.asarray(st['e_seq'], np.int32))
            raw_val = np.asarray(st['e_value'], np.int64)
            ent_chunks['e_value'].append(np.where(
                raw_val >= 0, raw_val + v_base, -1).astype(np.int32))
            ent_chunks['e_link'].append(
                np.asarray(st['e_link'], np.uint8).astype(bool))
            raw_ch = np.asarray(st['e_change'], np.int64)
            ent_chunks['e_change'].append(np.where(
                raw_ch >= 0, raw_ch + (l_base - len(st['lg_seq'])
                                       + sum(len(k) for k in l_keys)),
                -1).astype(np.int32))
        store.values.extend(list(st['values']))
        v_base = len(store.values)
        # clock rows
        for a, s in st['clock'].items():
            ck_doc.append(idx)
            ck_actor.append(store.intern([a], store.actors,
                                         store.actor_of)[0])
            ck_seq.append(s)
        if st['digest'] is None:
            any_digest_missing = True

    # -- bulk appends ---------------------------------------------------------
    if ent_doc:
        store.e_doc = np.concatenate([store.e_doc] + ent_doc)
        for name in ('e_obj', 'e_key', 'e_actor', 'e_seq', 'e_value',
                     'e_link', 'e_change'):
            setattr(store, name, np.concatenate(
                [getattr(store, name)] + ent_chunks[name]))
    if pool_obj:
        base = len(pool.obj)
        obj_cat = np.concatenate(pool_obj)
        local_cat = np.concatenate(pool_local)
        pool.obj = np.concatenate([pool.obj, obj_cat])
        pool.local = np.concatenate([pool.local, local_cat])
        pool.parent = np.concatenate(
            [pool.parent] + pool_parent)
        pool.actor = np.concatenate([pool.actor] + pool_actor)
        elemc_cat = np.concatenate(pool_elemc)
        pool.elemc = np.concatenate([pool.elemc, elemc_cat])
        pool.visible = np.concatenate([pool.visible] + pool_vis)
        pool.vis_index = np.concatenate(
            [pool.vis_index] + pool_visidx)
        pool.tpos = np.concatenate([pool.tpos] + pool_tpos)
        # new object rows are strictly above every existing one, so
        # the position keys append at the tail of the sorted index
        keys = (obj_cat.astype(np.int64) << 32) | local_cat
        pool.pos_sorted = np.concatenate([pool.pos_sorted, keys])
        pool.pos_row = np.concatenate(
            [pool.pos_row,
             base + np.arange(len(keys), dtype=np.int64)])
        pool.grow_objects(int(obj_cat.max()) + 1)
        starts = np.flatnonzero(np.concatenate(
            [[True], obj_cat[1:] != obj_cat[:-1]]))
        ends = np.append(starts[1:], len(obj_cat)) - 1
        uo = obj_cat[starts].astype(np.int64)
        pool.n_of[uo] = local_cat[ends].astype(np.int64) + 1
        seg_max = np.maximum.reduceat(elemc_cat, starts)
        pool.max_elem_of[uo] = np.maximum(pool.max_elem_of[uo],
                                          seg_max)
        pool.max_tree = max(pool.max_tree,
                            int(local_cat[ends].max()) + 1)
        pool.max_elem = max(pool.max_elem, int(seg_max.max()))
        # chain-shape bit for the absorbed objects: grow_objects pads
        # it False, but a restored chain doc must stay window-eligible
        par_cat = pool.parent[base:]
        ok_chain = (local_cat == 0) | (par_cat == local_cat - 1)
        pool.idx_linear[uo] = np.logical_and.reduceat(ok_chain, starts)
    # per-object counters must cover node-less objects (maps) too —
    # rows_of_objs and friends index n_of by object row
    pool.grow_objects(len(store.obj_uuid))
    for rows_c in idx_claims:
        pool.idx_ok[rows_c] = True
    new_l = np.concatenate(l_keys)
    if len(new_l):
        dep_counts = np.concatenate(l_dep_counts)
        ptr_new = np.cumsum(dep_counts).astype(np.int32)
        store.l_key = np.concatenate([store.l_key, new_l])
        store.l_dep_ptr = np.concatenate(
            [store.l_dep_ptr, store.l_dep_ptr[-1] + ptr_new])
        store.l_dep_actor = np.concatenate(
            [store.l_dep_actor] + l_dep_actor)
        store.l_dep_seq = np.concatenate(
            [store.l_dep_seq] + l_dep_seq)
        store._l_pending.append((new_l, l_base))
    if ck_doc:
        store.clock_merge(np.asarray(ck_doc, np.int64),
                          np.asarray(ck_actor, np.int64),
                          np.asarray(ck_seq, np.int32))
    # digests: copy-on-write like _fold_digests, so concurrent readers
    # never see a half-written array
    dig = store._digest.copy()
    for idx, payload, st in items:
        if st['digest'] is not None:
            dig[idx] = np.uint64(st['digest'])
        store.horizon[idx] = {'clock': dict(st['clock']),
                              'digest': st['digest'],
                              'state': bytes(payload)}
    store._digest = dig
    if any_digest_missing:
        store._digest_valid = False
    store._bump_doc_versions(
        np.unique(np.asarray([i for i, _, _ in items], np.int64)))
    store._obj_arr_cache = (0, None, None)
    store._wire_obj_cache = None
    # the device mirror is host-stale after a bulk pool append outside
    # the fused apply path: rebuild it from the (current) host columns
    # exactly like a snapshot resume
    store._materialize_mirror()
    metrics.set_gauge('mem_state_snapshot_bytes',
                      store.state_snapshot_bytes())


# -- the compaction engine ----------------------------------------------------

def _unwrap_general(doc_set):
    """(general_doc_set, serving_or_None) from any wrapper stack."""
    serving = doc_set if hasattr(doc_set, '_evicted') else None
    inner = getattr(doc_set, 'inner', None)
    if inner is None:
        inner = getattr(doc_set, 'doc_set', doc_set)
        inner = getattr(inner, 'doc_set', inner)
    return inner, serving


def compact_docset(doc_set, doc_ids=None):
    """Advance the compaction horizon of a general doc set (or its
    Durable/Serving wrapper) to the CURRENT clock: extract per-doc
    state snapshots from the live store, install horizon records,
    shrink the retained log to the post-horizon tail (empty for the
    docs just folded; untouched history for docs left out) and release
    the folded change bodies and their encode-cache entries. Evicted
    docs of a serving stack are skipped (their park shard already IS
    their state tier). A snapshot-resumed (``log_truncated``) store
    comes out fully servable: peers behind the horizon get state,
    everyone else gets the tail — and eviction is unblocked. Returns
    ``{'docs', 'ops_folded', 'ms'}``."""
    inner, serving = _unwrap_general(doc_set)
    store = inner.store
    t0 = time.perf_counter()
    store._commit_pending()
    store.pool.sync()
    store._fold_digests()
    clocks = store.clocks_all()
    skip = set()
    if serving is not None:
        skip = {inner.id_of[d] for d in serving._evicted
                if d in inner.id_of}
    if doc_ids is None:
        idxs = [i for i in sorted(clocks) if i not in skip]
    else:
        idxs = [inner.id_of[d] for d in doc_ids
                if d in inner.id_of and
                clocks.get(inner.id_of[d]) and
                inner.id_of[d] not in skip]
    recs = extract_doc_states(store, idxs)
    folded = set(idxs)
    ops_folded = 0
    keep = {}
    for block, rows, docs in store.retained:
        opc = np.diff(block.op_ptr)
        for c, d in zip(rows.tolist(), docs.tolist()):
            if d in folded:
                ops_folded += int(opc[c])
            else:
                keep.setdefault(d, []).append(block.change_dict(c))
    store.horizon.update(recs)
    store.retained = _encode_retained(store, keep)
    store._body_index_cache = (0, None)
    # release folded docs' encode-cache entries with their bodies
    for cache in (store._wire_cache, store._wire_cache_v2):
        for k in [k for k in cache if k[0] in folded]:
            del cache[k]
    from .device.blocks import _wire_entry_bytes
    store._wire_cache_bytes = \
        sum(len(v) for v in store._wire_cache.values()) + \
        sum(_wire_entry_bytes(v)
            for v in store._wire_cache_v2.values())
    metrics.set_gauge('sync_wire_cache_bytes', store._wire_cache_bytes)
    # the blunt snapshot-resume refusal lifts only once EVERY doc with
    # history has a horizon record — a partial (doc_ids=...) fold of a
    # truncated store must keep raising the loud retention error for
    # the docs it did not cover, never silently serve them an
    # empty/incomplete history
    if store.log_truncated and \
            all(d in store.horizon for d in clocks):
        store.log_truncated = False
    dt_ms = (time.perf_counter() - t0) * 1e3
    metrics.bump('compaction_runs')
    metrics.bump('compaction_ops_folded', ops_folded)
    metrics.observe('compaction_ms', dt_ms)
    metrics.set_gauge('mem_state_snapshot_bytes',
                      store.state_snapshot_bytes())
    if metrics.active:
        metrics.emit('compaction', docs=len(idxs),
                     ops_folded=ops_folded)
    return {'docs': len(idxs), 'ops_folded': ops_folded, 'ms': dt_ms}


def _encode_retained(store, keep):
    """Re-encode surviving per-doc change-dict lists into ONE fresh
    retained block (admission order per doc, doc-major rows) — the
    shared tail-rebuild of compaction and tiered-snapshot load. The
    old blocks (and the folded bodies they pin) are released."""
    if not keep:
        return []
    per_doc = [keep.get(i, []) for i in range(max(keep) + 1)]
    block = store.encode_changes(per_doc, n_docs=store.n_docs)
    rows = np.arange(block.n_changes, dtype=np.int64)
    return [(block, rows, block.doc.astype(np.int64))]


def compact_and_checkpoint(serving_or_durable, doc_ids=None):
    """Compact, then make the new tiers durable through the existing
    atomic checkpoint (tmp + fsync + rename, PR 4): a crash BEFORE the
    rename leaves the old snapshot + journal — the pre-compaction
    tiers — fully intact, and recovery replays them as if the
    compaction never happened."""
    out = compact_docset(serving_or_durable, doc_ids=doc_ids)
    serving_or_durable.checkpoint()
    return out
