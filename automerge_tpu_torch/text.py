"""The Text sequence CRDT type (parity with reference frontend/text.js).

A ``Text`` is a sequence of single-character edits; each element carries its
CRDT element ID so concurrent edits merge by insertion-tree order. Read
access mirrors an immutable sequence of characters.
"""


class Text:
    def __init__(self, object_id=None, elems=None, max_elem=0):
        self._object_id = object_id
        self.elems = elems if elems is not None else []  # [{'elemId','value','conflicts'}]
        self._max_elem = max_elem
        self._frozen = False

    def _freeze(self):
        # Same contract as AmMap/AmList: materialized objects are immutable.
        # The elems sequence becomes a tuple so out-of-change mutation fails
        # loudly instead of silently diverging replicas.
        object.__setattr__(self, '_frozen', True)
        object.__setattr__(self, 'elems', tuple(self.elems))

    def __setattr__(self, name, value):
        if getattr(self, '_frozen', False):
            from .frontend.datatypes import FrozenError
            raise FrozenError(
                'This object is frozen; use change() to modify an Automerge document')
        object.__setattr__(self, name, value)

    def __len__(self):
        return len(self.elems)

    def get(self, index):
        return self.elems[index]['value']

    def get_elem_id(self, index):
        return self.elems[index]['elemId']

    getElemId = get_elem_id

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [e['value'] for e in self.elems[index]]
        return self.elems[index]['value']

    def __iter__(self):
        for elem in self.elems:
            yield elem['value']

    def __eq__(self, other):
        if isinstance(other, Text):
            return list(self) == list(other)
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f'Text({self.join("")!r})'

    # Read-only conveniences mirroring the reference's array delegation
    # (frontend/text.js:36-43).
    def join(self, sep=''):
        return sep.join(str(v) for v in self)

    def index_of(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        return -1

    indexOf = index_of

    def includes(self, value):
        return self.index_of(value) >= 0

    def slice(self, start=None, end=None):
        return list(self)[start:end]

    def map(self, fn):
        return [fn(v) for v in self]

    def to_string(self):
        return self.join('')

    toString = to_string


def get_elem_id(obj, index):
    """elemId of the index-th element of a Text or AmList (text.js:57-59)."""
    if isinstance(obj, Text):
        return obj.get_elem_id(index)
    return obj._elem_ids[index]
