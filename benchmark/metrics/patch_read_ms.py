"""Patch read: the harness's span around the diffs of every touched
document, ending in a device synchronize (host clock), ms a tick."""


def read(rec):
    if not rec.ticks:
        return None
    return sum(t['t1'] - t['t_apply'] for t in rec.ticks) * 1e3 \
        / len(rec.ticks)
