"""Device: the share of the window in which no operation ran on the
card (profiler, CUDA activity), in %."""

from benchmark.harness.trace import busy_and_gaps


def read(rec):
    if rec.device is None or not rec.ticks:
        return None
    busy, _ = busy_and_gaps([(s, e) for _, s, e in rec.device],
                            rec.window())
    return 100.0 * (1.0 - busy / rec.window_s)
