"""Sync surface: the 95th percentile (nearest rank) of the ticks' time,
apply plus every touched document's diffs, ending in a device
synchronize (the harness's host clock), in ms."""

import math


def read(rec):
    if not rec.ticks:
        return None
    ms = sorted((t['t1'] - t['t0']) * 1e3 for t in rec.ticks)
    return ms[math.ceil(0.95 * len(ms)) - 1]
