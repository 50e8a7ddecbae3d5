"""Shared constants and small utilities.

TPU-native reimplementation of the helpers in the reference's ``src/common.js``
(`reference src/common.js:1-22`): the all-zeros root object ID, the
object test, and the vector-clock partial order. Clocks here are plain
``dict[str, int]`` on the host; the device-side dense-array clock kernels live
in :mod:`automerge_tpu.device.clock`.
"""

ROOT_ID = '00000000-0000-0000-0000-000000000000'


def is_object(value):
    """True for container values (dict / list / CRDT objects), false for primitives."""
    from .text import Text
    from .frontend.datatypes import AmMap, AmList
    return isinstance(value, (dict, list, Text, AmMap, AmList))


def less_or_equal(clock1, clock2):
    """Vector-clock partial order: every component of clock1 <= clock2.

    Mirrors ``lessOrEqual`` (reference ``src/common.js:14-18``).
    """
    for key in set(clock1) | set(clock2):
        if clock1.get(key, 0) > clock2.get(key, 0):
            return False
    return True
