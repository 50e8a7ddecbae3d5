"""A client's copy of a document, kept by applying the patches (diffs)
the system returns: the receiving side of what the comparison judges.
Diffs in any form this module does not know raise :class:`PatchError`."""

from .crdt import ROOT_ID, tag


class PatchError(ValueError):
    pass


def _value(d):
    return ('link', d['value']) if d.get('link') else tag(d['value'])


def _conflicts(d):
    return tuple(sorted((c['actor'], _value(c))
                        for c in d.get('conflicts') or ()))


class ClientView:
    def __init__(self):
        self.maps = {ROOT_ID: {}}      # uuid -> key -> (value, conflicts)
        self.seqs = {}                 # uuid -> [(eid, value, conflicts)]

    def apply(self, diffs):
        for d in diffs:
            action = d.get('action')
            if action == 'maxElem':
                continue
            if action == 'create':
                if d['type'] == 'map':
                    self.maps.setdefault(d['obj'], {})
                elif d['type'] in ('list', 'text'):
                    self.seqs.setdefault(d['obj'], [])
                else:
                    raise PatchError(f'unexpected object type in {d}')
                continue
            try:
                if d['type'] == 'map':
                    fields = self.maps[d['obj']]
                    if action == 'set':
                        fields[d['key']] = (_value(d), _conflicts(d))
                    elif action == 'remove':
                        del fields[d['key']]
                    else:
                        raise PatchError(f'unexpected diff {d}')
                    continue
                items = self.seqs[d['obj']]
                i = d['index']
                if action == 'insert':
                    if not 0 <= i <= len(items):
                        raise PatchError(f'index out of range in {d}')
                    items.insert(i, (d['elemId'], _value(d),
                                     _conflicts(d)))
                elif action == 'set':
                    items[i] = (items[i][0], _value(d), _conflicts(d))
                elif action == 'remove':
                    del items[i]
                else:
                    raise PatchError(f'unexpected diff {d}')
            except (KeyError, IndexError, TypeError) as exc:
                raise PatchError(f'{exc!r} applying {d}') from None

    def start_from(self, state):
        """Take a :meth:`state` reading as the client's copy."""
        maps, seqs = state
        self.maps = {u: dict(m) for u, m in maps.items()}
        self.seqs = {u: list(v) for u, v in seqs.items()}

    def state(self):
        """The copy, in the form of the reference's ``Doc.state()`` (not
        copied: read it before the next patch)."""
        return self.maps, self.seqs
