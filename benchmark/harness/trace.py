"""Tracing for ``--trace 1`` runs: the program's spans (a subscriber on
``automerge_tpu_torch.utils.metrics``) and the device's activity
(``torch.profiler`` with CUDA activity only, so the host's Python runs
untraced). Nothing here runs in a ``--trace 0`` run."""

import bisect
import json
import os
import shutil
import tempfile
import time

# trace event categories that are device activity
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class SpanRecorder:
    def __init__(self, record):
        self.record = record
        from automerge_tpu_torch.utils.metrics import metrics
        self._metrics = metrics

    def _on_event(self, ev):
        if ev.get('event') == 'span':
            end = ev['mono']
            self.record.spans.append(
                (ev['name'], end - ev['dur_ms'] / 1e3, end))

    def __enter__(self):
        self._metrics.subscribe(self._on_event)
        return self

    def __exit__(self, *exc):
        self._metrics.unsubscribe(self._on_event)
        return False


class DeviceProfiler:
    """CUDA activity over the window, placed on the host clock by a marker
    launched right after the profiler starts, on an idle device."""

    def __init__(self, record):
        self.record = record

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        marker = torch.zeros(1, device='cuda')
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._h0 = time.perf_counter()
        marker.add_(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.stop()
        tmp = tempfile.mkdtemp(prefix='bench_trace_')
        try:
            path = os.path.join(tmp, 'trace.json')
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get('traceEvents', [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._prof = None
        dev = sorted((float(e['ts']), float(e.get('dur', 0)), e['name'])
                     for e in events
                     if e.get('ph') == 'X' and e.get('cat') in _DEVICE_CATS)
        if not dev:
            self.record.device = []
            return False
        # the first device event is the marker (the device was idle)
        ts0 = dev[0][0]
        self.record.device = [
            (name, self._h0 + (ts - ts0) / 1e6,
             self._h0 + (ts - ts0 + dur) / 1e6)
            for ts, dur, name in dev[1:]]
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_and_gaps(intervals, windows):
    """Over ``windows`` (sorted, disjoint (start, end)): the length of the
    union of ``intervals`` inside them, and the gaps no interval covers."""
    merged = _merge(intervals)
    ends = [e for _, e in merged]
    busy, gaps = 0.0, []
    for w0, w1 in windows:
        t = w0
        i = bisect.bisect_right(ends, w0)
        while i < len(merged) and merged[i][0] < w1:
            s, e = max(merged[i][0], w0), min(merged[i][1], w1)
            if s > t:
                gaps.append((t, s))
            busy += e - s
            t = e
            i += 1
        if t < w1:
            gaps.append((t, w1))
    return busy, gaps


def breakdown(record, top=10):
    """The device operations that took most time, and the idle time by
    the innermost span (program or harness) the host was in."""
    ops = {}
    for name, s, e in record.device:
        ops[name] = ops.get(name, 0.0) + (e - s)
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(record.spans + record.host_spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    _, gaps = busy_and_gaps([(s, e) for _, s, e in record.device],
                            record.window())
    idle = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        best = None
        # spans nest inside one tick or lie between two: look back over
        # the spans that started before the gap's middle, to the tick's
        # start or the gap before it
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            n, s, e = spans[j]
            if s <= mid <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
            if n in ('harness.tick', 'harness.between'):
                break
        name = best[0] if best else 'other'
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[n, v] for n, v in device_ops],
            'idle_gaps': [[n, v] for n, v in top_idle]}
