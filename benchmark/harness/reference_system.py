"""The plain reference put in the program's place: the same calls as
a system under ``benchmark/systems/``, answered by
:mod:`benchmark.reference.crdt`, with each tick's patch worked out from
the document's state before and after it. The control runs it with one
guarantee broken; unbroken, it must come out correct."""

from ..reference.crdt import Doc


def _lit(v):
    if isinstance(v, tuple):
        return {'value': v[1], 'link': True} if v[0] == 'link' \
            else {'value': v[1]}
    return {'value': v}


def _conf(conflicts):
    return [{'actor': a, **_lit(v)} for a, v in conflicts]


def patch_between(doc, before, after):
    """Diffs that take a client from ``before`` to ``after`` (two
    :meth:`Doc.state` readings)."""
    maps0, seqs0 = before
    maps1, seqs1 = after
    out = []
    for u in maps1:
        if u not in maps0:
            out.append({'action': 'create', 'obj': u, 'type': 'map'})
    for u in seqs1:
        if u not in seqs0:
            out.append({'action': 'create', 'obj': u,
                        'type': doc.seqs[u].type})
    for u, fields in maps1.items():
        old = maps0.get(u, {})
        for k, (v, c) in fields.items():
            if old.get(k) != (v, c):
                d = {'action': 'set', 'type': 'map', 'obj': u, 'key': k,
                     **_lit(v)}
                if c:
                    d['conflicts'] = _conf(c)
                out.append(d)
        for k in old:
            if k not in fields:
                out.append({'action': 'remove', 'type': 'map', 'obj': u,
                            'key': k})
    for u, new in seqs1.items():
        typ = doc.seqs[u].type
        old = seqs0.get(u, [])
        new_at = {x[0]: x for x in new}
        old_at = {x[0]: x for x in old}
        for i in range(len(old) - 1, -1, -1):
            if old[i][0] not in new_at:
                out.append({'action': 'remove', 'type': typ, 'obj': u,
                            'index': i})
        for j, (eid, v, c) in enumerate(new):
            if eid not in old_at:
                d = {'action': 'insert', 'type': typ, 'obj': u, 'index': j,
                     'elemId': eid, **_lit(v)}
                if c:
                    d['conflicts'] = _conf(c)
                out.append(d)
        for j, (eid, v, c) in enumerate(new):
            if eid in old_at and old_at[eid][1:] != (v, c):
                d = {'action': 'set', 'type': typ, 'obj': u, 'index': j,
                     **_lit(v)}
                if c:
                    d['conflicts'] = _conf(c)
                out.append(d)
    return out


class ReferenceSystem:
    doc_class = Doc

    def __init__(self, n_docs):
        self.docs = [self.doc_class() for _ in range(n_docs)]
        self._patches = None

    def prepare(self, tick, gen):
        pass

    def apply(self, tick):
        patches = []
        for d, changes in zip(tick.docs, tick.changes):
            doc = self.docs[d]
            before = doc.state()
            doc.apply(changes)
            patches.append(patch_between(doc, before, doc.state()))
        self._patches = patches

    def read(self, tick, docs=None):
        if docs is None:
            return self._patches
        at = dict(zip(tick.docs, self._patches))
        return [at[d] for d in docs]

    def sync(self):
        pass

    def clock(self, d):
        return dict(self.docs[d].clock)

    def view(self, d):
        return self.docs[d].view()

    def close(self):
        self.docs = None
