"""Host-side interning and struct-of-arrays packing.

The device sees only dense integers; this module owns the string<->int
boundary: actor UUIDs -> ranks (rank order preserves string order, which
the conflict-resolution kernel relies on — op_set.js:211), object UUIDs
and map keys -> segment ids, elemIds -> node indexes. Values never travel
to the device: ops reference them by row index and the winners map back to
host-side value lists, so arbitrary JSON payloads ride along for free.
"""

import numpy as np


def closure_clocks(changes, prior_states=None):
    """Transitive-deps clock per change for a self-contained batch.

    Port of the reference's per-change `transitiveDeps` accumulation
    (op_set.js:29-37, :250) over a whole batch at once: changes are
    processed in causal order (fixed-point over readiness, mirroring
    applyQueuedOps, op_set.js:267-283).

    Args:
      changes: list of {'actor','seq','deps',...}
      prior_states: optional {(actor, seq): all_deps_dict} for changes
        already applied before this batch.

    Returns:
      (ordered_changes, all_deps_list) — changes in an applicable causal
      order with their transitive-deps clocks. Raises if the batch is not
      causally self-contained w.r.t. prior_states.
    """
    states = dict(prior_states or {})
    clock = {}
    for (actor, seq) in states:
        clock[actor] = max(clock.get(actor, 0), seq)

    pending = list(changes)
    ordered, all_deps_list = [], []
    while pending:
        progress = False
        remaining = []
        for change in pending:
            actor, seq = change['actor'], change['seq']
            deps = dict(change['deps'])
            deps[actor] = seq - 1
            if all(clock.get(a, 0) >= s for a, s in deps.items()):
                all_deps = {}
                for dep_actor, dep_seq in deps.items():
                    if dep_seq <= 0:
                        continue
                    transitive = states.get((dep_actor, dep_seq), {})
                    for a, s in transitive.items():
                        all_deps[a] = max(all_deps.get(a, 0), s)
                    all_deps[dep_actor] = dep_seq
                states[(actor, seq)] = all_deps
                clock[actor] = max(clock.get(actor, 0), seq)
                ordered.append(change)
                all_deps_list.append(all_deps)
                progress = True
            else:
                remaining.append(change)
        if not progress:
            raise ValueError(
                f'Batch is not causally self-contained; {len(remaining)} '
                'changes have unmet dependencies')
        pending = remaining
    return ordered, all_deps_list


class PackedAssignments:
    """One document's assignment ops as dense numpy columns plus the host
    metadata needed to unpack kernel results back to JSON."""

    __slots__ = ('seg_id', 'actor', 'seq', 'clock', 'is_del', 'valid',
                 'segments', 'op_meta', 'actor_names', 'n_segments')

    def __init__(self, seg_id, actor, seq, clock, is_del, valid,
                 segments, op_meta, actor_names):
        self.seg_id = seg_id
        self.actor = actor
        self.seq = seq
        self.clock = clock
        self.is_del = is_del
        self.valid = valid
        self.segments = segments      # list of (obj, key) per segment id
        self.op_meta = op_meta        # per-op (action, value) for unpacking
        self.actor_names = actor_names
        self.n_segments = len(segments)


def pack_assignments(changes, prior_states=None):
    """Pack every map-assignment op ('set'/'del'/'link') of a change batch.

    Returns a :class:`PackedAssignments`. Non-assignment ops (makeX, ins)
    are ignored here — they are structural and handled by the sequence
    kernel / host.
    """
    ordered, all_deps_list = closure_clocks(changes, prior_states)

    actor_names = sorted({c['actor'] for c in ordered})
    rank = {a: i for i, a in enumerate(actor_names)}
    n_actors = max(len(actor_names), 1)

    seg_of = {}
    segments = []
    rows = []
    op_meta = []
    for change, all_deps in zip(ordered, all_deps_list):
        actor, seq = change['actor'], change['seq']
        crow = np.zeros(n_actors, dtype=np.int32)
        for a, s in all_deps.items():
            if a in rank:
                crow[rank[a]] = s
        for op in change['ops']:
            if op['action'] not in ('set', 'del', 'link'):
                continue
            field = (op['obj'], op['key'])
            if field not in seg_of:
                seg_of[field] = len(segments)
                segments.append(field)
            rows.append((seg_of[field], rank[actor], seq, crow,
                         op['action'] == 'del'))
            op_meta.append((op['action'], op.get('value')))

    n = len(rows)
    seg_id = np.fromiter((r[0] for r in rows), np.int32, n)
    actor = np.fromiter((r[1] for r in rows), np.int32, n)
    seq = np.fromiter((r[2] for r in rows), np.int32, n)
    clock = (np.stack([r[3] for r in rows])
             if rows else np.zeros((0, n_actors), np.int32))
    is_del = np.fromiter((r[4] for r in rows), bool, n)
    valid = np.ones(n, dtype=bool)
    return PackedAssignments(seg_id, actor, seq, clock, is_del, valid,
                             segments, op_meta, actor_names)


def pad_and_stack(packed_docs, n_ops=None, n_actors=None,
                  index_dtype=np.int32, clock_dtype=np.int32):
    """Stack per-doc :class:`PackedAssignments` into padded [D, ...] arrays.

    With `n_ops`/`n_actors` unset, pads to the next power of two (shared
    jit cache across batches — avoids the recompilation storm of truly
    dynamic shapes). A caller-fixed size is used EXACTLY (one pinned jit
    bucket, the Options contract) and overflow is a clear error.
    """
    d = len(packed_docs)
    need_n = max((p.seg_id.shape[0] for p in packed_docs), default=1)
    need_a = max((p.clock.shape[1] for p in packed_docs), default=1)
    if n_ops is not None and need_n > n_ops:
        raise ValueError(f'batch needs {need_n} op rows but op_pad is '
                         f'fixed at {n_ops}')
    if n_actors is not None and need_a > n_actors:
        raise ValueError(f'batch needs {need_a} actors but actor_pad is '
                         f'fixed at {n_actors}')
    n = n_ops if n_ops is not None else max(_next_pow2(need_n), 1)
    a = n_actors if n_actors is not None else max(_next_pow2(need_a), 1)

    seg_id = np.zeros((d, n), index_dtype)
    actor = np.zeros((d, n), index_dtype)
    seq = np.zeros((d, n), clock_dtype)
    clock = np.zeros((d, n, a), clock_dtype)
    is_del = np.zeros((d, n), bool)
    valid = np.zeros((d, n), bool)
    for i, p in enumerate(packed_docs):
        k = p.seg_id.shape[0]
        seg_id[i, :k] = p.seg_id
        actor[i, :k] = p.actor
        seq[i, :k] = p.seq
        clock[i, :k, :p.clock.shape[1]] = p.clock
        is_del[i, :k] = p.is_del
        valid[i, :k] = p.valid
    return seg_id, actor, seq, clock, is_del, valid, n


def _next_pow2(n):
    p = 1
    while p < n:
        p <<= 1
    return p
