"""Kernels: the RGA ordering kernels' share of their roofline, in %
(bytes from ``benchmark/roofline``, device time from the profiler)."""

from benchmark.roofline import share


def read(rec):
    return share(rec, 'rga')
