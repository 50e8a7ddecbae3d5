"""Mutable proxy objects handed to ``change()`` callbacks.

Parity with `reference frontend/proxies.js`: inside a change callback
the document looks like ordinary mutable maps/lists, but every mutation is
routed through the :class:`~automerge_tpu.frontend.context.Context`, which
records CRDT ops and optimistic diffs. Reads always reflect mutations made
earlier in the same callback.

``MapProxy`` supports both attribute style (``doc.cards``) and item style
(``doc['cards']``). ``ListProxy`` supports Python list idioms (``append``,
``insert``, ``pop``, slicing reads) plus the reference's array surface
(``insert_at``/``delete_at``/``push``/``splice``/``unshift``/``fill`` with
camelCase aliases).
"""

from ..common import ROOT_ID
from ..text import Text


def _parse_list_index(key):
    if isinstance(key, str) and key.isdigit():
        key = int(key)
    if not isinstance(key, int) or isinstance(key, bool):
        raise TypeError(f'A list index must be a number, but you passed {key!r}')
    if key < 0:
        raise IndexError(f'A list index must be positive, but you passed {key}')
    return key


class MapProxy:
    __slots__ = ('_context', '_obj_id')

    def __init__(self, context, object_id):
        object.__setattr__(self, '_context', context)
        object.__setattr__(self, '_obj_id', object_id)

    # -- metadata ----------------------------------------------------------

    @property
    def _object_id(self):
        return self._obj_id

    @property
    def _type(self):
        return 'map'

    @property
    def _change(self):
        return self._context

    # -- reads -------------------------------------------------------------

    def __getitem__(self, key):
        return self._context.get_object_field(self._obj_id, key)

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        return self._context.get_object_field(self._obj_id, name)

    def get(self, key, default=None):
        value = self._context.get_object_field(self._obj_id, key)
        if value is None and key not in self:
            return default
        return value

    def __contains__(self, key):
        return key in self._context.get_object(self._obj_id)

    def __len__(self):
        return len(self._context.get_object(self._obj_id))

    def __iter__(self):
        return iter(list(self._context.get_object(self._obj_id).keys()))

    def keys(self):
        return list(self._context.get_object(self._obj_id).keys())

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __repr__(self):
        return f'MapProxy({self._obj_id})'

    # -- writes ------------------------------------------------------------

    def __setitem__(self, key, value):
        self._context.set_map_key(self._obj_id, key, _unproxy(value))

    def __setattr__(self, name, value):
        self._context.set_map_key(self._obj_id, name, _unproxy(value))

    def update(self, other=(), /, **kwargs):
        """Bulk assignment (the reference's Object.assign support,
        proxies_test.js:68-73).

        Like every method name on this proxy (``get``/``keys``/...), a
        document field literally named ``update`` must be read with item
        access (``doc['update']``) — attribute access resolves the method.
        """
        items = other.items() if hasattr(other, 'items') else other
        for k, v in items:
            self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __delitem__(self, key):
        self._context.delete_map_key(self._obj_id, key)

    def __delattr__(self, name):
        self._context.delete_map_key(self._obj_id, name)


class ListProxy:
    __slots__ = ('_context', '_obj_id')

    def __init__(self, context, object_id):
        object.__setattr__(self, '_context', context)
        object.__setattr__(self, '_obj_id', object_id)

    @property
    def _object_id(self):
        return self._obj_id

    @property
    def _type(self):
        return 'list'

    @property
    def _change(self):
        return self._context

    # -- reads -------------------------------------------------------------

    def _target(self):
        return self._context.get_object(self._obj_id)

    @property
    def length(self):
        return len(self._target())

    def __len__(self):
        return len(self._target())

    def __getitem__(self, key):
        if isinstance(key, slice):
            return [self[i] for i in range(*key.indices(len(self)))]
        n = len(self)
        if isinstance(key, int) and key < 0:
            key += n
        key = _parse_list_index(key)
        return self._context.get_object_field(self._obj_id, key)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __contains__(self, value):
        return any(v == value for v in self)

    def index(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        raise ValueError(f'{value!r} is not in list')

    def index_of(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        return -1

    indexOf = index_of

    def count(self, value):
        return sum(1 for v in self if v == value)

    def __repr__(self):
        return f'ListProxy({self._obj_id})'

    def __eq__(self, other):
        if isinstance(other, (list, tuple, ListProxy)):
            return list(self) == list(other)
        return NotImplemented

    def __hash__(self):
        return id(self)

    # -- writes ------------------------------------------------------------

    def __setitem__(self, key, value):
        n = len(self)
        if isinstance(key, int) and key < 0:
            key += n
        self._context.set_list_index(self._obj_id, _parse_list_index(key), _unproxy(value))

    def __delitem__(self, key):
        n = len(self)
        if isinstance(key, int) and key < 0:
            key += n
        self._context.splice(self._obj_id, _parse_list_index(key), 1, [])

    def append(self, *values):
        self._context.splice(self._obj_id, len(self), 0, [_unproxy(v) for v in values])

    def push(self, *values):
        self.append(*values)
        return len(self)

    def extend(self, values):
        self.append(*values)

    def insert(self, index, *values):
        self._context.splice(self._obj_id, _parse_list_index(index), 0,
                             [_unproxy(v) for v in values])
        return self

    insert_at = insert
    insertAt = insert

    def delete_at(self, index, num_delete=1):
        self._context.splice(self._obj_id, _parse_list_index(index), num_delete, [])
        return self

    deleteAt = delete_at

    def pop(self, index=None):
        n = len(self)
        if n == 0:
            if index is None:
                return None
            raise IndexError('pop from empty list')
        if index is None:
            index = n - 1
        elif index < 0:
            index += n
        value = self[index]
        self._context.splice(self._obj_id, index, 1, [])
        return value

    def shift(self):
        if len(self) == 0:
            return None
        value = self[0]
        self._context.splice(self._obj_id, 0, 1, [])
        return value

    def unshift(self, *values):
        self._context.splice(self._obj_id, 0, 0, [_unproxy(v) for v in values])
        return len(self)

    def splice(self, start, delete_count=None, *values):
        start = _parse_list_index(start)
        if delete_count is None:
            delete_count = len(self) - start
        deleted = [self[start + n] for n in range(delete_count)]
        self._context.splice(self._obj_id, start, delete_count,
                             [_unproxy(v) for v in values])
        return deleted

    def remove(self, value):
        self._context.splice(self._obj_id, self.index(value), 1, [])

    def fill(self, value, start=0, end=None):
        if end is None:
            end = len(self)
        for index in range(_parse_list_index(start), _parse_list_index(end)):
            self._context.set_list_index(self._obj_id, index, _unproxy(value))
        return self


def _unproxy(value):
    """Resolve proxies to their materialized objects so nested assignment of
    an existing Automerge object links by ID (context.js:66)."""
    if isinstance(value, (MapProxy, ListProxy)):
        return value._context.get_object(value._obj_id)
    if getattr(value, '_object_id', None) is not None:
        return value  # existing materialized CRDT object: link by ID
    if isinstance(value, dict):
        return {k: _unproxy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_unproxy(v) for v in value]
    return value


def instantiate_proxy(context, object_id):
    obj = context.get_object(object_id)
    if isinstance(obj, (list, Text)):
        return ListProxy(context, object_id)
    return MapProxy(context, object_id)


def root_object_proxy(context):
    context.instantiate_object = lambda object_id: instantiate_proxy(context, object_id)
    return MapProxy(context, ROOT_ID)
