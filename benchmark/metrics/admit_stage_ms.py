"""Admission and staging: the program's spans ``device.admit`` and
``device.stage``, ms a tick."""


def read(rec):
    return rec.span_ms_per_tick('device.admit', 'device.stage')
