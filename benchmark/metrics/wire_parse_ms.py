"""Wire codec: the program's span ``wire.parse``, ms a tick."""


def read(rec):
    return rec.span_ms_per_tick('wire.parse')
