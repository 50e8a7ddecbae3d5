"""Sync surface: per tick, the ``apply_wire`` wall (the harness's host
clock) less the program's spans under it (``wire.parse``,
``device.admit``, ``device.stage``, ``device.dispatch``): the part no
span names yet, mean over the window, in ms."""

NAMED = ('wire.parse', 'device.admit', 'device.stage', 'device.dispatch')


def read(rec):
    spans = [(s, e) for n, s, e in rec.spans if n in NAMED]
    if not rec.ticks or not spans:
        return None
    rest = 0.0
    for t in rec.ticks:
        inside = sum(e - s for s, e in spans
                     if s >= t['t0'] and e <= t['t_apply'])
        rest += t['t_apply'] - t['t0'] - inside
    return rest * 1e3 / len(rec.ticks)
