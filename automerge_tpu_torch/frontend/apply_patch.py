"""Applies backend diffs to the materialized document tree.

Parity with `reference frontend/apply_patch.js`: documents are trees
of frozen :class:`AmMap` / :class:`AmList` / :class:`Text` objects with
structure sharing — applying a patch clones only the objects on the path
from each modified object to the root (``update_parent_objects``), leaving
everything else aliased to the previous version.
"""

import re

from ..common import ROOT_ID, is_object
from ..text import Text
from .datatypes import AmMap, AmList

_ELEMID_RE = re.compile(r'^(.*):(\d+)$')


def parse_elem_id(elem_id):
    """'actor:counter' -> (counter, actor) (apply_patch.js:10-16)."""
    match = _ELEMID_RE.match(elem_id or '')
    if not match:
        raise ValueError(f'Not a valid elemId: {elem_id}')
    return int(match.group(2)), match.group(1)


def _child_references_map(obj, key):
    refs = {}
    conflicts = obj._conflicts.get(key, {})
    children = [obj.get(key)] + list(conflicts.values())
    for child in children:
        if is_object(child):
            refs[child._object_id] = True
    return refs


def _child_references_list(lst, index):
    refs = {}
    conflicts = (lst._conflicts[index] if index < len(lst._conflicts) else None) or {}
    children = ([lst[index]] if index < len(lst) else []) + list(conflicts.values())
    for child in children:
        if is_object(child):
            refs[child._object_id] = True
    return refs


def update_inbound(object_id, refs_before, refs_after, inbound):
    """Maintain the child->parent index (apply_patch.js:40-51)."""
    for ref in refs_before:
        if ref not in refs_after:
            inbound.pop(ref, None)
    for ref in refs_after:
        if inbound.get(ref) is not None and inbound[ref] != object_id:
            raise ValueError(f'Object {ref} has multiple parents')
        if ref not in inbound:
            inbound[ref] = object_id


def clone_map_object(original, object_id):
    """Writable copy of an immutable map object (apply_patch.js:57-66)."""
    if original is not None and original._object_id != object_id:
        raise ValueError(
            f'cloneMapObject ID mismatch: {original._object_id} != {object_id}')
    obj = AmMap(object_id)
    if original is not None:
        dict.update(obj, original)
        object.__setattr__(obj, '_conflicts', dict(original._conflicts))
    return obj


def _resolve(value, link, cache, updated):
    if link:
        resolved = updated.get(value)
        return resolved if resolved is not None else cache.get(value)
    return value


def update_map_object(diff, cache, updated, inbound):
    """Apply one diff to a map object (apply_patch.js:74-106)."""
    if diff['obj'] not in updated:
        updated[diff['obj']] = clone_map_object(cache.get(diff['obj']), diff['obj'])
    obj = updated[diff['obj']]
    conflicts = obj._conflicts
    refs_before, refs_after = {}, {}

    if diff['action'] == 'create':
        pass
    elif diff['action'] == 'set':
        refs_before = _child_references_map(obj, diff['key'])
        dict.__setitem__(obj, diff['key'],
                         _resolve(diff.get('value'), diff.get('link'), cache, updated))
        if diff.get('conflicts'):
            conflicts[diff['key']] = {
                c['actor']: _resolve(c.get('value'), c.get('link'), cache, updated)
                for c in diff['conflicts']}
        else:
            conflicts.pop(diff['key'], None)
        refs_after = _child_references_map(obj, diff['key'])
    elif diff['action'] == 'remove':
        refs_before = _child_references_map(obj, diff['key'])
        dict.pop(obj, diff['key'], None)
        conflicts.pop(diff['key'], None)
    else:
        raise ValueError('Unknown action type: ' + diff['action'])

    update_inbound(diff['obj'], refs_before, refs_after, inbound)


def parent_map_object(object_id, cache, updated):
    """Point a map at the updated versions of its children (apply_patch.js:113-141)."""
    if object_id not in updated:
        updated[object_id] = clone_map_object(cache.get(object_id), object_id)
    obj = updated[object_id]

    for key in list(obj.keys()):
        value = obj[key]
        if is_object(value) and value._object_id in updated:
            dict.__setitem__(obj, key, updated[value._object_id])

        conflicts = obj._conflicts.get(key)
        if conflicts:
            new_conflicts = None
            for actor_id, value in conflicts.items():
                if is_object(value) and value._object_id in updated:
                    if new_conflicts is None:
                        new_conflicts = dict(conflicts)
                        obj._conflicts[key] = new_conflicts
                    new_conflicts[actor_id] = updated[value._object_id]


def clone_list_object(original, object_id):
    """Writable copy of an immutable list object (apply_patch.js:147-160)."""
    if original is not None and original._object_id != object_id:
        raise ValueError(
            f'cloneListObject ID mismatch: {original._object_id} != {object_id}')
    lst = AmList(object_id)
    if original is not None:
        list.extend(lst, original)
        object.__setattr__(lst, '_conflicts', list(original._conflicts))
        object.__setattr__(lst, '_elem_ids', list(original._elem_ids))
        object.__setattr__(lst, '_max_elem', original._max_elem)
    return lst


def update_list_object(diff, cache, updated, inbound, lenient=False):
    """Apply one diff to a list object (apply_patch.js:168-210).

    ``lenient`` is set ONLY when replaying in-flight local request diffs:
    they pass through the deliberately-approximate OT
    (frontend/index.js:131-192, documented there as "incomplete and
    incorrect"), which can produce out-of-range indexes and inserts
    without elemIds. The reference survives because JS arrays tolerate
    both; here lenient mode clamps indexes (a remove past the end is a
    no-op) — the backend's authoritative patch replaces every transient
    approximation. Authoritative patches stay strict: a bad index there
    is a backend bug and must fail loudly, not diverge silently.
    """
    if diff['obj'] not in updated:
        updated[diff['obj']] = clone_list_object(cache.get(diff['obj']), diff['obj'])
    lst = updated[diff['obj']]
    conflicts, elem_ids = lst._conflicts, lst._elem_ids
    value, conflict = None, None

    if diff['action'] in ('insert', 'set'):
        value = _resolve(diff.get('value'), diff.get('link'), cache, updated)
        if diff.get('conflicts'):
            conflict = {c['actor']: _resolve(c.get('value'), c.get('link'), cache, updated)
                        for c in diff['conflicts']}

    refs_before, refs_after = {}, {}
    if diff['action'] == 'create':
        # a create may carry the true maxElem — visible inserts alone
        # under-count it past tombstones (see backend get_patch)
        if diff.get('maxElem'):
            object.__setattr__(lst, '_max_elem',
                               max(lst._max_elem, diff['maxElem']))
    elif diff['action'] == 'maxElem':
        # batched device patches net out insert+delete within one apply;
        # this diff keeps the local elemId counter truthful anyway
        object.__setattr__(lst, '_max_elem',
                           max(lst._max_elem, diff['value']))
    elif diff['action'] == 'insert':
        index = diff['index']
        elem_id = diff.get('elemId')
        if lenient:
            index = min(index, len(lst))
        if elem_id is not None:
            object.__setattr__(lst, '_max_elem',
                               max(lst._max_elem, parse_elem_id(elem_id)[0]))
        elif not lenient:
            raise ValueError('List insert diff requires an elemId')
        if index > len(lst):
            raise IndexError(f'List insert index {index} out of range')
        list.insert(lst, index, value)
        conflicts.insert(index, conflict)
        elem_ids.insert(index, elem_id)
        refs_after = _child_references_list(lst, index)
    elif diff['action'] == 'set':
        if lenient and diff['index'] >= len(lst):  # transient OT overshoot
            list.append(lst, value)
            conflicts.append(conflict)
            elem_ids.append(None)
            refs_after = _child_references_list(lst, len(lst) - 1)
        else:
            refs_before = _child_references_list(lst, diff['index'])
            list.__setitem__(lst, diff['index'], value)
            conflicts[diff['index']] = conflict
            refs_after = _child_references_list(lst, diff['index'])
    elif diff['action'] == 'remove':
        if lenient and diff['index'] >= len(lst):
            pass                                   # transient OT overshoot
        else:
            refs_before = _child_references_list(lst, diff['index'])
            list.__delitem__(lst, diff['index'])
            del conflicts[diff['index']]
            del elem_ids[diff['index']]
    else:
        raise ValueError('Unknown action type: ' + diff['action'])

    update_inbound(diff['obj'], refs_before, refs_after, inbound)


def parent_list_object(object_id, cache, updated):
    """Point a list at the updated versions of its children (apply_patch.js:217-245)."""
    if object_id not in updated:
        updated[object_id] = clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]

    for index in range(len(lst)):
        value = lst[index]
        if is_object(value) and value._object_id in updated:
            list.__setitem__(lst, index, updated[value._object_id])

        conflicts = lst._conflicts[index] if index < len(lst._conflicts) else None
        if conflicts:
            new_conflicts = None
            for actor_id, value in conflicts.items():
                if is_object(value) and value._object_id in updated:
                    if new_conflicts is None:
                        new_conflicts = dict(conflicts)
                        lst._conflicts[index] = new_conflicts
                    new_conflicts[actor_id] = updated[value._object_id]


def update_text_object(diffs, start_index, end_index, cache, updated):
    """Apply a run of text diffs with run-coalesced splices
    (apply_patch.js:253-316)."""
    object_id = diffs[start_index]['obj']
    if object_id not in updated:
        if object_id in cache:
            elems = list(cache[object_id].elems)
            max_elem = cache[object_id]._max_elem
            updated[object_id] = Text(object_id, elems, max_elem)
        else:
            updated[object_id] = Text(object_id)

    elems = updated[object_id].elems
    max_elem = updated[object_id]._max_elem
    splice_pos, deletions, insertions = -1, 0, []

    i = start_index
    while i <= end_index:
        diff = diffs[i]
        if diff['action'] == 'create':
            # true maxElem may exceed the visible inserts' (tombstones)
            max_elem = max(max_elem, diff.get('maxElem', 0))
        elif diff['action'] == 'maxElem':
            max_elem = max(max_elem, diff['value'])
        elif diff['action'] == 'insert':
            if splice_pos < 0:
                splice_pos, deletions, insertions = diff['index'], 0, []
            max_elem = max(max_elem, parse_elem_id(diff['elemId'])[0])
            insertions.append({'elemId': diff['elemId'], 'value': diff.get('value'),
                               'conflicts': diff.get('conflicts')})
            if (i == end_index or diffs[i + 1]['action'] != 'insert'
                    or diffs[i + 1]['index'] != diff['index'] + 1):
                elems[splice_pos:splice_pos + deletions] = insertions
                splice_pos = -1
        elif diff['action'] == 'set':
            elems[diff['index']] = {'elemId': elems[diff['index']]['elemId'],
                                    'value': diff.get('value'),
                                    'conflicts': diff.get('conflicts')}
        elif diff['action'] == 'remove':
            if splice_pos < 0:
                splice_pos, deletions, insertions = diff['index'], 0, []
            deletions += 1
            if (i == end_index or diffs[i + 1]['action'] not in ('insert', 'remove')
                    or diffs[i + 1]['index'] != diff['index']):
                elems[splice_pos:splice_pos + deletions] = []
                splice_pos = -1
        else:
            raise ValueError('Unknown action type: ' + diff['action'])
        i += 1

    updated[object_id] = Text(object_id, elems, max_elem)


def update_parent_objects(cache, updated, inbound):
    """Propagate updated children up to the root (apply_patch.js:326-344)."""
    affected = updated
    while affected:
        parents = {}
        for child_id in list(affected.keys()):
            parent_id = inbound.get(child_id)
            if parent_id:
                parents[parent_id] = True
        affected = parents

        for object_id in parents:
            existing = updated.get(object_id)
            if existing is None:
                existing = cache.get(object_id)
            if isinstance(existing, list):
                parent_list_object(object_id, cache, updated)
            else:
                parent_map_object(object_id, cache, updated)


def apply_diffs(diffs, cache, updated, inbound, lenient=False):
    """Dispatch diffs to the per-type appliers; text diffs are grouped into
    runs per object (apply_patch.js:353-373). ``lenient`` applies only to
    replayed in-flight request diffs (see update_list_object)."""
    start_index = 0
    for end_index, diff in enumerate(diffs):
        if diff['type'] == 'map':
            update_map_object(diff, cache, updated, inbound)
            start_index = end_index + 1
        elif diff['type'] == 'list':
            update_list_object(diff, cache, updated, inbound, lenient)
            start_index = end_index + 1
        elif diff['type'] == 'text':
            if end_index == len(diffs) - 1 or diffs[end_index + 1]['obj'] != diff['obj']:
                update_text_object(diffs, start_index, end_index, cache, updated)
                start_index = end_index + 1
        else:
            raise TypeError(f"Unknown object type: {diff['type']}")


def clone_root_object(root):
    if root._object_id != ROOT_ID:
        raise ValueError(f'Not the root object: {root._object_id}')
    return clone_map_object(root, ROOT_ID)
