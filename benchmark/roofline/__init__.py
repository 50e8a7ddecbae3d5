"""The yardstick of the kernels' roofline shares.

Bytes are counted from a tick's content as the generator made it, never
from a launch's padded slots, the variant that ran, or whether the
program rebuilt a row or ordered only its delta: each input byte read
once, each output byte written once, for what the tick's content needs.
So a share reads the same work whatever implements it, and no kernel can
do that work in less time than the bytes take at the peak.

A tick's content is, per touched sequence (one row): its nodes after the
tick, the nodes the tick adds, and the tick's ops on its elements.

- RGA ordering (``rga``): each added node's parent slot, elem counter and
  actor rank read (3 x 4 B), its anchor's position read (4 B) and its
  own position written (4 B); each row with added nodes, its length
  (4 B).
- Edit stream (``edit_stream``): each touched row's prior and new
  visibility, one bit each a node; each sequence op's node slot read
  (4 B), its visible index (4 B) and its action (1 B) written.

Kernel names map to the two families through ``kernels.json``; the peak
is in ``peaks.json``.
"""

import json
import os
import re

_DIR = os.path.dirname(os.path.abspath(__file__))

with open(os.path.join(_DIR, 'peaks.json')) as _f:
    PEAKS = json.load(_f)
with open(os.path.join(_DIR, 'kernels.json')) as _f:
    _FAMILIES = {fam: [re.compile(p) for p in pats]
                 for fam, pats in json.load(_f).items()}


def rga_bytes(rows):
    return sum(20 * new + 4 for _, new, _ in rows if new)


def edit_stream_bytes(rows):
    return sum((2 * nodes + 7) // 8 + 9 * ops
               for nodes, _, ops in rows if ops)


BYTES = {'rga': rga_bytes, 'edit_stream': edit_stream_bytes}


def family_of(kernel_name):
    for fam, pats in _FAMILIES.items():
        if any(p.search(kernel_name) for p in pats):
            return fam
    return None


def share(record, family):
    """The family's share of its roofline over the window, in %: the
    least time the window's bytes take at the peak over the family's
    device time; None where the trace holds none of its kernels."""
    if not record.device:
        return None
    busy = sum(e - s for name, s, e in record.device
               if family_of(name) == family)
    if busy <= 0:
        return None
    nbytes = sum(BYTES[family](t['rows']) for t in record.ticks)
    return 100.0 * nbytes / PEAKS['hbm_bytes_per_s'] / busy
