"""Fused device program: the program's span ``device.dispatch`` (the
host's enqueue wall, not device time), ms a tick."""


def read(rec):
    return rec.span_ms_per_tick('device.dispatch')
