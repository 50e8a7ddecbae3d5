"""Mutation context: translates proxy mutations into CRDT operations.

Parity with `reference frontend/context.js`. A :class:`Context` is
created per ``change()`` callback; proxy mutations call into it, and it
records both the operation list for the backend (``ops``) and the
optimistic local diffs (``diffs``) applied immediately to the document.
"""

from ..common import is_object
from ..text import Text, get_elem_id
from ..uuid import uuid
from .apply_patch import apply_diffs
from .datatypes import AmList


def _is_primitive(value):
    return value is None or isinstance(value, (str, bool, int, float))


def _valid_value(value):
    return _is_primitive(value) or is_object(value)


class Context:
    def __init__(self, doc, actor_id):
        self.actor_id = actor_id
        self.cache = doc._cache
        self.updated = {}
        self.inbound = dict(doc._inbound)
        self.ops = []
        self.diffs = []
        self.instantiate_object = None  # installed by root_object_proxy()

    def add_op(self, operation):
        self.ops.append(operation)

    def apply(self, diff):
        """Optimistically apply a local diff (context.js:32-35)."""
        self.diffs.append(diff)
        apply_diffs([diff], self.cache, self.updated, self.inbound)

    def get_object(self, object_id):
        obj = self.updated.get(object_id)
        if obj is None:
            obj = self.cache.get(object_id)
        if obj is None:
            raise ValueError(f'Target object does not exist: {object_id}')
        return obj

    def get_object_field(self, object_id, key):
        obj = self.get_object(object_id)
        if isinstance(obj, Text):
            if not isinstance(key, int) or key < 0 or key >= len(obj):
                return None
            value = obj.elems[key]['value']
        elif isinstance(obj, AmList):
            if not isinstance(key, int) or key < 0 or key >= len(obj):
                return None
            value = obj[key]
        else:
            value = obj.get(key)
        if is_object(value):
            return self.instantiate_object(value._object_id)
        return value

    def create_nested_objects(self, value):
        """Recursively create CRDT objects for a nested value; returns the
        root objectId (context.js:65-94)."""
        existing_id = getattr(value, '_object_id', None)
        if isinstance(existing_id, str):
            return existing_id
        object_id = uuid()

        if isinstance(value, Text):
            if len(value) > 0:
                raise ValueError('Assigning a non-empty Text object is not supported')
            self.apply({'action': 'create', 'type': 'text', 'obj': object_id})
            self.add_op({'action': 'makeText', 'obj': object_id})
        elif isinstance(value, (list, tuple)):
            self.apply({'action': 'create', 'type': 'list', 'obj': object_id})
            self.add_op({'action': 'makeList', 'obj': object_id})
            self.splice(object_id, 0, 0, list(value))
        else:
            self.apply({'action': 'create', 'type': 'map', 'obj': object_id})
            self.add_op({'action': 'makeMap', 'obj': object_id})
            for key in value:
                self.set_map_key(object_id, key, value[key])
        return object_id

    def set_map_key(self, object_id, key, value):
        """(context.js:100-126)"""
        if not isinstance(key, str):
            raise ValueError(f'The key of a map entry must be a string, not {type(key).__name__}')
        if key == '':
            raise ValueError('The key of a map entry must not be an empty string')
        if key.startswith('_'):
            raise ValueError(f'Map entries starting with underscore are not allowed: {key}')

        obj = self.get_object(object_id)
        if not _valid_value(value):
            raise TypeError(f'Unsupported type of value: {type(value).__name__}')
        if is_object(value):
            child_id = self.create_nested_objects(value)
            self.apply({'action': 'set', 'type': 'map', 'obj': object_id,
                        'key': key, 'value': child_id, 'link': True})
            self.add_op({'action': 'link', 'obj': object_id, 'key': key, 'value': child_id})
        else:
            # No-op if the assigned value strictly equals the existing one and
            # the assignment does not resolve a conflict (context.js:120-122).
            same = (key in obj and obj[key] == value
                    and isinstance(obj[key], bool) == isinstance(value, bool))
            if not same or obj._conflicts.get(key):
                self.apply({'action': 'set', 'type': 'map', 'obj': object_id,
                            'key': key, 'value': value})
                self.add_op({'action': 'set', 'obj': object_id, 'key': key, 'value': value})

    def delete_map_key(self, object_id, key):
        """(context.js:131-137)"""
        obj = self.get_object(object_id)
        if key in obj:
            self.apply({'action': 'remove', 'type': 'map', 'obj': object_id, 'key': key})
            self.add_op({'action': 'del', 'obj': object_id, 'key': key})

    def insert_list_item(self, object_id, index, value):
        """(context.js:143-167)"""
        lst = self.get_object(object_id)
        if index < 0 or index > len(lst):
            raise IndexError(
                f'List index {index} is out of bounds for list of length {len(lst)}')
        if not _valid_value(value):
            raise TypeError(f'Unsupported type of value: {type(value).__name__}')

        max_elem = lst._max_elem + 1
        obj_type = 'text' if isinstance(lst, Text) else 'list'
        prev_id = '_head' if index == 0 else get_elem_id(lst, index - 1)
        elem_id = f'{self.actor_id}:{max_elem}'
        self.add_op({'action': 'ins', 'obj': object_id, 'key': prev_id, 'elem': max_elem})

        if is_object(value):
            child_id = self.create_nested_objects(value)
            self.apply({'action': 'insert', 'type': obj_type, 'obj': object_id,
                        'index': index, 'value': child_id, 'link': True, 'elemId': elem_id})
            self.add_op({'action': 'link', 'obj': object_id, 'key': elem_id, 'value': child_id})
        else:
            self.apply({'action': 'insert', 'type': obj_type, 'obj': object_id,
                        'index': index, 'value': value, 'elemId': elem_id})
            self.add_op({'action': 'set', 'obj': object_id, 'key': elem_id, 'value': value})
        obj = self.get_object(object_id)
        object.__setattr__(obj, '_max_elem', max_elem)

    def set_list_index(self, object_id, index, value):
        """(context.js:173-199)"""
        lst = self.get_object(object_id)
        if index == len(lst):
            self.insert_list_item(object_id, index, value)
            return
        if index < 0 or index > len(lst):
            raise IndexError(
                f'List index {index} is out of bounds for list of length {len(lst)}')
        if not _valid_value(value):
            raise TypeError(f'Unsupported type of value: {type(value).__name__}')

        elem_id = get_elem_id(lst, index)
        obj_type = 'text' if isinstance(lst, Text) else 'list'

        if is_object(value):
            child_id = self.create_nested_objects(value)
            self.apply({'action': 'set', 'type': obj_type, 'obj': object_id,
                        'index': index, 'value': child_id, 'link': True})
            self.add_op({'action': 'link', 'obj': object_id, 'key': elem_id, 'value': child_id})
        else:
            if isinstance(lst, Text):
                current = lst.elems[index]['value']
                conflict = lst.elems[index].get('conflicts')
            else:
                current = lst[index]
                conflict = lst._conflicts[index] if index < len(lst._conflicts) else None
            same = current == value and isinstance(current, bool) == isinstance(value, bool)
            if not same or conflict:
                self.apply({'action': 'set', 'type': obj_type, 'obj': object_id,
                            'index': index, 'value': value})
                self.add_op({'action': 'set', 'obj': object_id, 'key': elem_id, 'value': value})

    def splice(self, object_id, start, deletions, insertions):
        """(context.js:206-228)"""
        lst = self.get_object(object_id)
        obj_type = 'text' if isinstance(lst, Text) else 'list'

        if deletions > 0:
            if start < 0 or start > len(lst) - deletions:
                raise IndexError(
                    f'{deletions} deletions starting at index {start} are out of '
                    f'bounds for list of length {len(lst)}')
            for i in range(deletions):
                self.add_op({'action': 'del', 'obj': object_id,
                             'key': get_elem_id(lst, start)})
                self.apply({'action': 'remove', 'type': obj_type, 'obj': object_id,
                            'index': start})
                if i == 0:
                    lst = self.get_object(object_id)

        for i, value in enumerate(insertions):
            self.insert_list_item(object_id, start + i, value)
