"""The benchmark's one traffic generator.

Every configuration's document shape (its file's ``document`` block) and
every traffic mix (``benchmark/traffic/<mix>.json``) is a set of
parameters that this module reads; nothing here is specific to a cell.
Both the documents loaded in set-up and every tick of the window come
from the seed alone.

A document is a root map holding one sequence (``list`` or ``text``)
under ``document.key``, and the root keys ``document.root_keys``. A
sequence item is a scalar (a character of a text, an integer of a list)
or, where ``document.item`` names fields, a map object (a card) with
those fields, linked into the list.

A mix names which documents a tick touches (``docs``: ``{"pick":
"all"}``, ``{"pick": "uniform", "count": n}`` or ``{"pick": "zipf",
"count": n, "s": s}``, distinct documents drawn by Zipf weights over a
seeded ranking), how many writers each has and how each writes: items
typed at a cursor (``keys``, with ``backspace`` and ``jump``
probabilities a keystroke), ``sets`` on items visible before the tick,
``deletes`` of such items, and root keys set (``root_sets``). A
writer's sets in one tick write distinct items (or distinct fields of
map items); two writers may set the same one (a conflict).

Changes are Automerge 0.x change dicts (``actor``, ``seq``, ``deps``,
``ops``). The generator keeps, per document, what its clients know: the
visible items (for picking targets, not their order), the highest
element counter, the heads and the clock, and each writer's cursor. Its
choices never make two writers of one tick touch an item one of them
deletes, so the visible set it tracks is exact without ordering the
sequence.
"""

import numpy as np

ROOT_ID = '00000000-0000-0000-0000-000000000000'
_LETTERS = 'abcdefghijklmnopqrstuvwxyz'
_WORDS = ('add', 'api', 'auth', 'bug', 'build', 'cache', 'check', 'clean',
          'client', 'config', 'crash', 'data', 'deploy', 'design', 'docs',
          'draft', 'error', 'export', 'fix', 'flaky', 'guide', 'import',
          'index', 'layout', 'limit', 'login', 'merge', 'metrics', 'move',
          'page', 'parser', 'patch', 'plan', 'port', 'query', 'release',
          'remove', 'rename', 'report', 'retry', 'review', 'rewrite',
          'schema', 'search', 'server', 'setup', 'slow', 'split', 'sync',
          'table', 'test', 'theme', 'ticket', 'timeout', 'update',
          'upload', 'user', 'view', 'widget', 'worker', 'write', 'jax',
          'pallas', 'everything')


def seed_words(seed):
    """``--seed`` (any whole number) as SeedSequence entropy."""
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]


def rng_for(seed, *stream):
    return np.random.default_rng([*seed_words(seed), *stream])


def _actor_ids(rng, n):
    """``n`` actor ids: 16 hex digits each, as a client would mint them."""
    return [f'{v:016x}' for v in rng.integers(0, 1 << 63, n).tolist()]


def _draw(rng, span, n):
    lo, hi = span
    if lo == hi:
        return np.full(n, lo, np.int64)
    return rng.integers(lo, hi + 1, n)


def _spread(rng, span, n):
    """``n`` sizes evenly spread over ``span``, in an order drawn from
    the seed: every seed gets the same sizes."""
    lo, hi = span
    sizes = np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
    return rng.permutation(sizes.astype(np.int64))


class Values:
    """Values drawn in bulk: a field's or a scalar item's type names how
    (``int``: 30 bits; ``char``: a letter; ``bool``; ``string``: a card
    title of 2-5 words)."""

    def __init__(self, rng, n):
        self._ints = rng.integers(0, 1 << 30, n).tolist()
        self._words = rng.integers(0, len(_WORDS), (n, 5)).tolist()
        self._lens = rng.integers(2, 6, n).tolist()
        self._i = 0

    def take(self, kind):
        i = self._i % len(self._ints)
        self._i += 1
        v = self._ints[i]
        if kind == 'int':
            return v
        if kind == 'char':
            return _LETTERS[v % 26]
        if kind == 'bool':
            return bool(v & 1)
        if kind == 'string':
            return ' '.join(_WORDS[w] for w in
                            self._words[i][:self._lens[i]])
        raise ValueError(f'unknown value type {kind!r}')


class Writer:
    __slots__ = ('actor', 'seq', 'cursor', 'anchor', 'chain')

    def __init__(self, actor, seq=0):
        self.actor = actor
        self.seq = seq
        self.cursor = None        # elemId typed after next, or None
        self.anchor = None        # where the cursor last jumped to
        self.chain = []           # elemIds typed since the cursor jumped


class DocModel:
    """What the clients of one document know of it."""

    __slots__ = ('d', 'obj', 'max_elem', 'visible', 'vpos', 'nodes',
                 'heads', 'clock', 'writers', 'cards', 'card_of')

    def __init__(self, d, obj):
        self.d = d
        self.obj = obj
        self.max_elem = 0
        self.visible = []
        self.vpos = {}
        self.nodes = 0            # every element ever inserted
        self.heads = {}
        self.clock = {}
        self.writers = []
        self.cards = 0            # map items made
        self.card_of = {}         # elemId -> the map item's object id

    def add(self, eid):
        self.vpos[eid] = len(self.visible)
        self.visible.append(eid)

    def remove(self, eid):
        i = self.vpos.pop(eid)
        last = self.visible.pop()
        if i < len(self.visible):
            self.visible[i] = last
            self.vpos[last] = i

    def commit(self, changes):
        """The tick's changes are concurrent and depend on every head:
        they become the heads."""
        if changes:
            self.heads = {c['actor']: c['seq'] for c in changes}
            for c in changes:
                self.clock[c['actor']] = c['seq']


class Tick:
    """One tick: the touched documents (ascending) and their changes,
    with the counts the harness and the roofline read."""

    __slots__ = ('index', 'docs', 'changes', 'n_ops', 'n_changes', 'rows',
                 'ids', 'data')

    def __init__(self, index, docs, changes, rows):
        self.index = index
        self.docs = docs
        self.changes = changes
        self.n_changes = sum(len(c) for c in changes)
        self.n_ops = sum(len(c['ops']) for cs in changes for c in cs)
        # per touched sequence object: (nodes after the tick, nodes the
        # tick adds, sequence ops of the tick) — the roofline's content
        self.rows = rows
        # (doc, actor, seq) of every change, kept once ``changes`` is
        # dropped for the wire bytes ``data``
        self.ids = [(d, c['actor'], c['seq'])
                    for d, cs in zip(docs, changes) for c in cs]
        self.data = None


class Shape:
    """A configuration's ``document`` block, read once."""

    def __init__(self, document):
        self.kind = document['object']
        self.key = document['key']
        self.root_keys = tuple(document.get('root_keys', ()))
        item = document.get('item', 'char' if self.kind == 'text'
                            else 'int')
        self.fields = tuple(item.items()) if isinstance(item, dict) \
            else None
        self.scalar = None if self.fields else item
        self.load = document['load']

    def item_ops(self, doc, actor, obj, prev, e, values):
        """The ops that type one item after ``prev`` as element ``e``:
        an ``ins`` and its value (a scalar ``set``, or a new map object
        with its fields, linked)."""
        eid = f'{actor}:{e}'
        ops = [{'action': 'ins', 'obj': obj, 'key': prev, 'elem': e}]
        if self.fields is None:
            ops.append({'action': 'set', 'obj': obj, 'key': eid,
                        'value': values.take(self.scalar)})
            return eid, ops
        doc.cards += 1
        card = f'{doc.cards:08x}-0000-4000-a000-{doc.d:012x}'
        doc.card_of[eid] = card
        ops.append({'action': 'makeMap', 'obj': card})
        for name, kind in self.fields:
            ops.append({'action': 'set', 'obj': card, 'key': name,
                        'value': values.take(kind)})
        ops.append({'action': 'link', 'obj': obj, 'key': eid,
                    'value': card})
        return eid, ops

    def targets(self, items):
        """What a set can write among ``items``: each item, or each field
        of each map item."""
        if self.fields is None:
            return [(eid, None) for eid in items]
        return [(eid, name) for eid in items for name, _ in self.fields]

    def set_op(self, doc, obj, target, values):
        """One set on a visible item: its value, or one of its fields."""
        eid, name = target
        if name is None:
            return {'action': 'set', 'obj': obj, 'key': eid,
                    'value': values.take(self.scalar)}
        return {'action': 'set', 'obj': doc.card_of[eid], 'key': name,
                'value': values.take(dict(self.fields)[name])}


def _seq_ops(ops, obj):
    return sum(1 for op in ops if op['obj'] == obj)


class Generator:
    """Documents and ticks of one cell from one seed.

    ``document``: the configuration's document block; ``mix``: the
    traffic mix's parameters; ``n_docs``: the configuration's document
    count."""

    def __init__(self, n_docs, document, mix, seed):
        self.n_docs = n_docs
        self.shape = Shape(document)
        self.mix = mix
        self.seed = seed
        self.docs = []
        self.ticks = 0
        self._ranking = None

    # -- set-up: the documents as deployed --------------------------------

    def load(self):
        """The load tick: every document created and filled by its
        writers (``document.load``). Returns a :class:`Tick`."""
        shape = self.shape
        ld = shape.load
        kind = shape.kind
        n = self.n_docs
        rng = rng_for(self.seed, 0)
        lengths = _spread(rng, ld['length'], n)
        n_writers = ld['writers']
        actors = _actor_ids(rng, n * n_writers)
        changes, rows = [], []
        obj_tag = {'list': '8000', 'text': '9000'}[kind]
        for d in range(n):
            drng = rng_for(self.seed, 1, d)
            obj = f'00000000-0000-4000-{obj_tag}-{d:012x}'
            doc = DocModel(d, obj)
            self.docs.append(doc)
            writers = [Writer(a) for a in actors[d * n_writers:
                                                 (d + 1) * n_writers]]
            doc.writers = writers
            total = int(lengths[d])
            n0 = int(round(total * ld['first_share']))
            values = Values(drng, total * (1 + len(shape.fields or ())))
            # writer 0 makes the object and types its share, jumping
            # back to a random earlier element now and then
            w0 = writers[0]
            ops = [{'action': 'make' + kind.capitalize(), 'obj': obj},
                   {'action': 'link', 'obj': ROOT_ID, 'key': shape.key,
                    'value': obj}]
            prev, ids0 = '_head', []
            jumps = drng.random(n0) < ld['jump']
            picks = drng.random(n0)
            for i in range(n0):
                if ids0 and jumps[i]:
                    prev = ids0[int(picks[i] * len(ids0))]
                prev, item = shape.item_ops(doc, w0.actor, obj, prev, i + 1,
                                            values)
                ops += item
                ids0.append(prev)
            w0.seq = 1
            doc_changes = [{'actor': w0.actor, 'seq': 1, 'deps': {},
                            'ops': ops}]
            # the other writers type the rest in runs, each after writer
            # 0 (``chained``: each after the one before, continuing its
            # text), and delete a share of writer 0's elements
            rest = total - n0
            others = writers[1:]
            shares = [rest // len(others)] * len(others) if others else []
            if shares:
                shares[-1] += rest - sum(shares)
            dead = drng.choice(n0, int(ld['deleted_share'] * total),
                               replace=False) if n0 else []
            anchors = [ids0[int(j)] for j in
                       drng.integers(0, n0, ld['anchors'])] \
                if ld['anchors'] and n0 else []
            top = n0
            dead_ids = set()
            for w_i, (w, count) in enumerate(zip(others, shares), 1):
                ops = []
                e = top if ld['chained'] else n0
                done = 0
                while done < count:
                    run = min(int(drng.integers(ld['runs'][0],
                                                ld['runs'][1] + 1)),
                              count - done)
                    if not ld['chained']:
                        prev = anchors[int(drng.integers(len(anchors)))]
                    for _ in range(run):
                        e += 1
                        prev, item = shape.item_ops(doc, w.actor, obj, prev,
                                                    e, values)
                        ops += item
                        doc.add(prev)
                        done += 1
                for j in dead[w_i - 1::len(others)]:
                    ops.append({'action': 'del', 'obj': obj,
                                'key': ids0[int(j)]})
                    dead_ids.add(ids0[int(j)])
                deps = ({doc_changes[-1]['actor']: 1} if ld['chained']
                        else {w0.actor: 1})
                w.seq = 1
                doc_changes.append({'actor': w.actor, 'seq': 1,
                                    'deps': deps, 'ops': ops})
                top = max(top, e)
            # the last writer sets the root keys
            for rk in shape.root_keys:
                doc_changes[-1]['ops'].append(
                    {'action': 'set', 'obj': ROOT_ID, 'key': rk, 'value': d})
            for x in ids0:
                if x not in dead_ids:
                    doc.add(x)
            doc.max_elem = top
            doc.nodes = total
            for c in doc_changes:
                doc.clock[c['actor']] = c['seq']
            depended = {a for c in doc_changes for a in c['deps']}
            doc.heads = {c['actor']: c['seq'] for c in doc_changes
                         if c['actor'] not in depended}
            changes.append(doc_changes)
            rows.append((total, total,
                         sum(_seq_ops(c['ops'], obj) for c in doc_changes)))
        return Tick(-1, list(range(n)), changes, rows)

    # -- the window: one tick of the mix ----------------------------------

    def _pick(self, rng):
        """The documents a tick touches, ascending."""
        n = self.n_docs
        spec = self.mix['docs']
        how = spec['pick']
        count = min(spec.get('count', n), n)
        if how == 'all' or (how == 'uniform' and count >= n):
            return np.arange(n)
        if how == 'uniform':
            return np.sort(rng.choice(n, count, replace=False))
        if how == 'zipf':
            if self._ranking is None:
                # which document is the most popular, second, ...: one
                # ranking for the seed
                self._ranking = rng_for(self.seed, 4).permutation(n)
                w = 1.0 / np.arange(1, n + 1) ** float(spec['s'])
                self._weights = w / w.sum()
            at = rng.choice(n, count, replace=False, p=self._weights)
            return np.sort(self._ranking[at])
        raise ValueError(f'unknown document pick {how!r}')

    def tick(self):
        """The next tick of the mix: the documents it touches, and per
        document a change from each writer that writes."""
        mix = self.mix
        t = self.ticks
        self.ticks += 1
        rng = rng_for(self.seed, 2, t)
        touched = self._pick(rng)
        n_writers = mix['writers']
        new_actors = mix['new_actors']
        if new_actors:
            actors = _actor_ids(rng, len(touched) * n_writers)
        writes = rng.random((len(touched), n_writers)) < mix['p_write']
        docs, changes, rows = [], [], []
        for i, d in enumerate(touched.tolist()):
            doc = self.docs[d]
            drng = rng_for(self.seed, 3, t, d)
            if new_actors:
                writers = [Writer(a) for a in
                           actors[i * n_writers:(i + 1) * n_writers]]
            else:
                writers = doc.writers[:n_writers]
            active = [w for j, w in enumerate(writers) if writes[i, j]]
            if not active:
                continue
            cs, n_new, n_seq = self._doc_tick(doc, writers, active, drng)
            docs.append(d)
            changes.append(cs)
            rows.append((doc.nodes, n_new, n_seq))
        return Tick(t, docs, changes, rows)

    def _doc_tick(self, doc, writers, active, rng):
        mix = self.mix
        shape = self.shape
        obj = doc.obj
        base = doc.max_elem
        deps_all = dict(doc.heads)
        n_keys = _draw(rng, mix['keys'], len(active))
        n_del = _draw(rng, mix['deletes'], len(active))
        n_set = _draw(rng, mix['sets'], len(active))
        per_item = 1 + len(shape.fields or ())
        values = Values(rng, int(n_keys.sum() + n_set.sum()) * per_item + 1)
        per_writer = []
        chained = set()
        for w in writers:
            chained.update(w.chain)
        # 1. typing at each writer's cursor: before a keystroke the
        #    cursor jumps to a visible item (or the head) with
        #    probability ``jump``; backspace pops what the writer typed
        #    since its cursor last jumped
        gone = set()
        typed_all = []
        vis = doc.visible
        for j, w in enumerate(active):
            ops = []
            e = base
            typed = []            # (elemId, how many ops typed it)
            keys = int(n_keys[j])
            back = rng.random(keys) < mix['backspace']
            jump = rng.random(keys) < mix['jump']
            for k in range(keys):
                if w.cursor is None or jump[k]:
                    for x in w.chain:
                        chained.discard(x)
                    w.chain = []
                    pick = int(rng.integers(len(vis) + 1))
                    w.cursor = vis[pick] if pick < len(vis) else '_head'
                    w.anchor = w.cursor
                if back[k] and w.chain:
                    victim = w.chain.pop()
                    w.cursor = w.chain[-1] if w.chain else w.anchor
                    if typed and typed[-1][0] == victim:
                        # typed and erased within the tick: the client
                        # sends neither (in one change, a del would not
                        # overwrite the set: ops of a change are
                        # concurrent)
                        del ops[-typed.pop()[1]:]
                        continue
                    ops.append({'action': 'del', 'obj': obj,
                                'key': victim})
                    gone.add(victim)
                    continue
                e += 1
                eid, item = shape.item_ops(doc, w.actor, obj, w.cursor, e,
                                           values)
                ops += item
                w.cursor = eid
                w.chain.append(eid)
                typed.append((eid, len(item)))
            typed_all.append(([x for x, _ in typed], e))
            per_writer.append(ops)
        # 2. deletes and 3. sets on items visible before the tick, never
        #    on one a writer types after or deletes in this tick
        if n_del.any() or n_set.any():
            free = [x for x in vis if x not in chained and x not in gone]
            order = rng.permutation(len(free))
            k = 0
            dels = []
            for j in range(len(active)):
                mine = [free[int(p)] for p in order[k:k + int(n_del[j])]]
                k += int(n_del[j])
                dels.append(mine)
                gone.update(mine)
            rest = shape.targets(free[int(p)] for p in order[k:])
            for j, ops in enumerate(per_writer):
                if n_set[j]:
                    pick = rng.choice(len(rest), min(int(n_set[j]),
                                                     len(rest)),
                                      replace=False)
                    for p in pick.tolist():
                        ops.append(shape.set_op(doc, obj, rest[p], values))
                for x in dels[j]:
                    ops.append({'action': 'del', 'obj': obj, 'key': x})
        n_seq = sum(_seq_ops(ops, obj) for ops in per_writer)
        # 4. root keys, set by the writers the mix names
        for rk, who in mix.get('root_sets', {}).items():
            for j, w in enumerate(active):
                if writers.index(w) in who:
                    per_writer[j].append(
                        {'action': 'set', 'obj': ROOT_ID, 'key': rk,
                         'value': int(rng.integers(0, 1 << 30))})
        changes = []
        n_new = 0
        for w, ops, (typed, top) in zip(active, per_writer, typed_all):
            w.seq += 1
            deps = {a: s for a, s in deps_all.items() if a != w.actor}
            changes.append({'actor': w.actor, 'seq': w.seq, 'deps': deps,
                            'ops': ops})
            n_new += len(typed)
            doc.max_elem = max(doc.max_elem, top)
            for eid in typed:
                if eid not in gone:
                    doc.add(eid)
        for x in gone:
            if x in doc.vpos:
                doc.remove(x)
        doc.nodes += n_new
        doc.commit(changes)
        return changes, n_new, n_seq
