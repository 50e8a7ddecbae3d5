"""The plain reference: Automerge 0.x semantics for the ops the traffic
sends, written from the published algorithm and nothing of the program.

- Causal delivery: a change waits until its ``deps`` and its actor's
  previous change are applied.
- A field (a map key, or a sequence element) keeps the ops that no later
  op has overwritten: a ``set`` or ``del`` removes every op of its
  field whose change lies in its own change's causal past. The change
  itself is not in its past, so two ops of one change on one field are
  concurrent (as in the reference engine's ``isConcurrent``). The winner
  is the op of the greatest actor id; the rest are conflicts.
- A map is the root or an object a ``makeMap`` creates (a card, linked
  into a list); its keys are fields as above.
- A sequence is the insertion tree of its elements: each ``ins`` hangs
  under its ``key`` (``_head`` or an element), siblings in descending
  ``(elem, actor)``, document order the tree's pre-order. An element is
  visible while it keeps an op.
"""

ROOT_ID = '00000000-0000-0000-0000-000000000000'
HEAD = '_head'


class Sequence:
    __slots__ = ('type', 'children', 'rank', 'parent', 'fields', 'order')

    def __init__(self, type_):
        self.type = type_
        self.children = {HEAD: []}     # eid -> child eids, descending
        self.rank = {}                 # eid -> (elem, actor)
        self.parent = {}
        self.fields = {}               # eid -> surviving ops
        self.order = []                # every element, document order

    def insert(self, parent, eid, elem, actor):
        if eid in self.rank:
            raise ValueError(f'duplicate element {eid}')
        if parent != HEAD and parent not in self.rank:
            raise ValueError(f'insert after unknown element {parent}')
        key = (elem, actor)
        sibs = self.children[parent]
        i = 0
        while i < len(sibs) and self.rank[sibs[i]] > key:
            i += 1
        sibs.insert(i, eid)
        self.children[eid] = []
        self.rank[eid] = key
        self.parent[eid] = parent
        if self.order is None:
            return
        if i > 0:
            # after the whole subtree of the next greater sibling
            last = sibs[i - 1]
            while self.children[last]:
                last = self.children[last][-1]
            pos = self.order.index(last) + 1
        else:
            pos = 0 if parent == HEAD else self.order.index(parent) + 1
        self.order.insert(pos, eid)

    def rebuild(self):
        """Document order from the tree (a pre-order walk)."""
        out = []
        stack = list(reversed(self.children[HEAD]))
        while stack:
            eid = stack.pop()
            out.append(eid)
            stack.extend(reversed(self.children[eid]))
        self.order = out

    def items(self):
        """Visible elements in order: (eid, winner, conflicts)."""
        if self.order is None:
            self.rebuild()
        fields = self.fields
        return [(eid, *_resolve(fields[eid])) for eid in self.order
                if fields.get(eid)]


def tag(v):
    """A value as the comparison holds it: a bool tagged, so that
    ``True`` never equals ``1``."""
    return ('bool', v) if isinstance(v, bool) else v


def _resolve(ops):
    """(winner value, conflicts) of a field's surviving ops, each op
    ``(actor, seq, value)``: the greatest actor wins."""
    if len(ops) == 1:
        return ops[0][2], ()
    ranked = sorted(ops, key=lambda o: o[0], reverse=True)   # stable
    conflicts = tuple(sorted((o[0], o[2]) for o in ranked[1:]))
    return ranked[0][2], conflicts


class Doc:
    """One document of the reference."""

    sequence_class = Sequence

    def __init__(self):
        self.clock = {}
        self.vclock = {}               # (actor, seq) -> causal past
        self.queue = []
        self.maps = {ROOT_ID: {}}      # object uuid -> key -> ops
        self.seqs = {}                 # object uuid -> Sequence

    def apply(self, changes):
        """Apply ``changes`` in causal order; a change whose
        dependencies are missing waits in the queue."""
        self.queue.extend(changes)
        progress = True
        while progress and self.queue:
            progress = False
            waiting = []
            for c in self.queue:
                if self._ready(c):
                    self._apply_change(c)
                    progress = True
                else:
                    waiting.append(c)
            self.queue = waiting

    def _ready(self, c):
        if self.clock.get(c['actor'], 0) >= c['seq']:
            return True                # a duplicate: applied already
        if self.clock.get(c['actor'], 0) != c['seq'] - 1:
            return False
        return all(self.clock.get(a, 0) >= s for a, s in c['deps'].items())

    def _apply_change(self, c):
        actor, seq = c['actor'], c['seq']
        if self.clock.get(actor, 0) >= seq:
            return
        past = {}
        deps = dict(c['deps'])
        if seq > 1:
            deps[actor] = seq - 1
        for a, s in deps.items():
            for x, y in self.vclock[(a, s)].items():
                if past.get(x, 0) < y:
                    past[x] = y
        self.vclock[(actor, seq)] = {**past, actor: seq}
        self.clock[actor] = seq
        if len(c['ops']) > 256:
            # a bulk change: order the sequences once, when next read
            for s in self.seqs.values():
                s.order = None
        for op in c['ops']:
            self._apply_op(op, actor, seq, past)

    def _apply_op(self, op, actor, seq, past):
        action = op['action']
        obj = op['obj']
        if action in ('makeList', 'makeText'):
            if obj not in self.seqs:
                self.seqs[obj] = self.sequence_class(action[4:].lower())
            return
        if action == 'makeMap':
            self.maps.setdefault(obj, {})
            return
        if obj in self.maps:
            fields, key = self.maps[obj], op['key']
        else:
            s = self.seqs[obj]
            if action == 'ins':
                s.insert(op['key'], f"{actor}:{op['elem']}", op['elem'],
                         actor)
                return
            fields, key = s.fields, op['key']
        kept = [o for o in fields.get(key, ()) if past.get(o[0], 0) < o[1]]
        if action == 'set':
            kept.append((actor, seq, tag(op['value'])))
        elif action == 'link':
            kept.append((actor, seq, ('link', op['value'])))
        elif action != 'del':
            raise ValueError(f'unknown action {action}')
        fields[key] = kept

    # -- what the comparison reads ----------------------------------------

    def state(self):
        """``(maps, sequences)``: each map (the root and every map
        object) as its keys' ``(winner, conflicts)``, each sequence as
        its visible ``(eid, winner, conflicts)`` in order — what a
        client that applied every patch holds."""
        maps = {u: {k: _resolve(ops) for k, ops in m.items() if ops}
                for u, m in self.maps.items()}
        return maps, {u: s.items() for u, s in self.seqs.items()}

    def _view(self, v):
        if not isinstance(v, tuple):
            return v
        if v[0] == 'bool':
            return v[1]
        if v[1] in self.maps:
            return {k: self._view(_resolve(ops)[0])
                    for k, ops in self.maps[v[1]].items() if ops}
        s = self.seqs[v[1]]
        vals = [self._view(x[1]) for x in s.items()]
        return ''.join(vals) if s.type == 'text' else vals

    def view(self):
        """Winners only, links resolved: maps as dicts, lists as lists,
        text as a string."""
        return self._view(('link', ROOT_ID))
