"""Materialized document object types.

The reference materializes documents as frozen plain JS objects/arrays with
hidden metadata properties (frontend/constants.js, frontend/index.js:15-39).
Here the equivalents are ``AmMap`` (a dict subclass) and ``AmList`` (a list
subclass) carrying the same metadata as Python attributes:

* ``_object_id``   — the CRDT object ID (reference OBJECT_ID)
* ``_conflicts``   — per-key / per-index conflict sets (reference CONFLICTS)
* ``_elem_ids``    — list only: elemId per index (reference ELEM_IDS)
* ``_max_elem``    — list only: max elem counter (reference MAX_ELEM)

The root map additionally carries ``_options``, ``_cache``, ``_inbound``,
``_state`` and ``_actor_id``. Objects are frozen after materialization:
mutation must go through ``change()`` callbacks.
"""


class FrozenError(TypeError):
    pass


class AmMap(dict):
    """A materialized map object. Supports attribute-style reads
    (``doc.cards``) in addition to item access (``doc['cards']``)."""

    _am_attrs = ('_object_id', '_conflicts', '_options', '_cache', '_inbound',
                 '_state', '_actor_id', '_frozen', '_change')

    def __init__(self, object_id=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, '_object_id', object_id)
        object.__setattr__(self, '_conflicts', {})
        object.__setattr__(self, '_frozen', False)

    # -- attribute-style access --------------------------------------------

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        if name in AmMap._am_attrs:
            if getattr(self, '_frozen', False) and name not in ('_state',):
                raise FrozenError('Cannot modify a frozen document object')
            object.__setattr__(self, name, value)
        else:
            self[name] = value

    # -- freeze enforcement -------------------------------------------------

    def _check_frozen(self):
        if getattr(self, '_frozen', False):
            raise FrozenError(
                'This object is frozen; use change() to modify an Automerge document')

    def __setitem__(self, key, value):
        self._check_frozen()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check_frozen()
        super().__delitem__(key)

    def update(self, *args, **kwargs):
        self._check_frozen()
        super().update(*args, **kwargs)

    def pop(self, *args):
        self._check_frozen()
        return super().pop(*args)

    def popitem(self):
        self._check_frozen()
        return super().popitem()

    def clear(self):
        self._check_frozen()
        super().clear()

    def setdefault(self, *args):
        self._check_frozen()
        return super().setdefault(*args)

    def _freeze(self):
        object.__setattr__(self, '_frozen', True)


class AmList(list):
    """A materialized list object."""

    def __init__(self, object_id=None, *args):
        super().__init__(*args)
        object.__setattr__(self, '_object_id', object_id)
        object.__setattr__(self, '_conflicts', [])
        object.__setattr__(self, '_elem_ids', [])
        object.__setattr__(self, '_max_elem', 0)
        object.__setattr__(self, '_frozen', False)

    def _check_frozen(self):
        if getattr(self, '_frozen', False):
            raise FrozenError(
                'This object is frozen; use change() to modify an Automerge document')

    def __setitem__(self, key, value):
        self._check_frozen()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check_frozen()
        super().__delitem__(key)

    def append(self, value):
        self._check_frozen()
        super().append(value)

    def extend(self, values):
        self._check_frozen()
        super().extend(values)

    def insert(self, index, value):
        self._check_frozen()
        super().insert(index, value)

    def pop(self, *args):
        self._check_frozen()
        return super().pop(*args)

    def remove(self, value):
        self._check_frozen()
        super().remove(value)

    def sort(self, **kwargs):
        self._check_frozen()
        super().sort(**kwargs)

    def reverse(self):
        self._check_frozen()
        super().reverse()

    def clear(self):
        self._check_frozen()
        super().clear()

    def _freeze(self):
        object.__setattr__(self, '_frozen', True)
