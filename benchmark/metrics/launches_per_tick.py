"""Fused device program: the program's launch counters
(``cuda_sequence``, ``cuda_view``, ``cuda_merge``), launches a tick."""


def read(rec):
    if not rec.ticks or rec.launches is None:
        return None
    return rec.launches / rec.n_ticks
