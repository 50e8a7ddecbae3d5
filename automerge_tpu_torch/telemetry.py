"""Telemetry export: the observability registry in standard formats.

PR 7/8 built the signal surface — counters, gauges, 96-bucket latency
histograms, spans with cross-peer correlation, flight-recorder event
dumps. This module makes that whole surface consumable by standard
tooling with ZERO new dependencies:

- :func:`render_prometheus` — the live registry as Prometheus text
  exposition (version 0.0.4): plain counters/gauges as untyped
  samples, every ``observe`` series as a cumulative histogram whose
  ``le`` edges come straight from the shared log-spaced bucket
  geometry, and the per-connection ``peer/<id>/...`` scope prefixes
  re-expressed as labels (``sync_retransmits{peer="p1"}``) so one
  scrape shows both the aggregates and the per-link slices. Every
  REGISTERED name renders even when never bumped — a dashboard keyed
  on a registered metric can never silently read nothing
  (tests/test_metrics.py asserts it). PR 19's ``transport_*`` (socket
  framing/mux) and ``membership_*`` (failure detector) registries
  export through the same path with no exporter changes — the
  ``node/<id>/...`` scopes the transport stamps become labels exactly
  like the per-peer connection scopes.
- :func:`dump_chrome_trace` — completed ``span`` events (from a
  :class:`~automerge_tpu_torch.utils.metrics.FlightRecorder`, a subscriber
  log, or a replayed incident file) as Chrome-trace/Perfetto JSON:
  one lane per trace id, complete ("X") events carrying span/parent
  ids and attrs, non-span events as instants. Load the file in
  ``chrome://tracing`` or https://ui.perfetto.dev.

``tools/trace_report.py`` is the CLI wrapper converting incident
JSON-lines and span dumps into a Chrome-trace file.

The PyTorch port's copy of ``automerge_tpu/telemetry.py`` (host code;
the same output formats).
"""

import json
import re

from .utils.metrics import (ALL_COUNTER_REGISTRIES, HIST_BUCKETS,
                            HIST_LO, HIST_RATIO, HIST_SUFFIXES,
                            metrics as _metrics)

_BAD_CHARS = re.compile(r'[^a-zA-Z0-9_:]')


def _sanitize(name):
    """A legal Prometheus metric name (dots/dashes become
    underscores; a leading digit gets prefixed)."""
    out = _BAD_CHARS.sub('_', name)
    if not out or out[0].isdigit():
        out = '_' + out
    return out


def _split_scope(name):
    """Split a scoped registry key (``peer/p1/sync_retransmits``,
    ``node/n0/peer/n1/x``) into (labels, bare name). Scope prefixes
    are ``key/value/`` pairs by construction
    (:meth:`Metrics.scoped`); anything that does not parse as pairs
    stays one flat (sanitized) name."""
    parts = name.split('/')
    if len(parts) >= 3 and len(parts) % 2 == 1:
        labels = {}
        for i in range(0, len(parts) - 1, 2):
            key = parts[i]
            if not key or _BAD_CHARS.search(key):
                return {}, name
            labels[key] = parts[i + 1]
        return labels, parts[-1]
    return {}, name


def _fmt_value(value):
    if isinstance(value, bool):
        return '1' if value else '0'
    if isinstance(value, float):
        return repr(value)
    return str(value)


def _escape_label(value):
    return str(value).replace('\\', '\\\\').replace('"', '\\"') \
        .replace('\n', '\\n')


def _label_str(labels):
    if not labels:
        return ''
    body = ','.join(f'{_sanitize(k)}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items()))
    return '{' + body + '}'


def bucket_edges():
    """The shared histogram geometry as Prometheus ``le`` upper
    bounds: bucket 0 holds everything <= LO; bucket b covers
    (LO*R^(b-1), LO*R^b]."""
    return [HIST_LO * HIST_RATIO ** b if b else HIST_LO
            for b in range(HIST_BUCKETS)]


def render_prometheus(m=None, registered=ALL_COUNTER_REGISTRIES):
    """Render registry ``m`` (default: the process-wide one) as
    Prometheus text exposition. ``registered`` names render even at
    zero (series-suffixed names — ``*_ms`` — render as empty
    histograms), so no registered metric is ever silently
    unexported."""
    m = _metrics if m is None else m
    with m._lock:
        counters = dict(m.counters)
        hists = {name: list(buckets)
                 for name, buckets in m._hists.items()}
    if registered:
        for name in registered:
            if name.endswith(HIST_SUFFIXES):
                hists.setdefault(name, [0] * HIST_BUCKETS)
            else:
                counters.setdefault(name, 0)
    edges = bucket_edges()
    lines = []
    scalars = {}                   # metric name -> [(labels, value)]

    # aggregate observe series render as real cumulative histograms;
    # their .count/.sum backing counters are consumed here (the .max
    # convenience stat renders as its own gauge)
    consumed = set()
    for name in sorted(hists):
        metric = _sanitize(name)
        hist = hists[name]
        lines.append(f'# TYPE {metric} histogram')
        cum = 0
        for b, n in enumerate(hist):
            cum += n
            lines.append(f'{metric}_bucket{{le="{repr(edges[b])}"}} '
                         f'{cum}')
        lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
        lines.append(f'{metric}_sum '
                     f'{_fmt_value(counters.get(name + ".sum", 0))}')
        lines.append(f'{metric}_count {cum}')
        consumed.add(name + '.count')
        consumed.add(name + '.sum')
    for name, value in counters.items():
        if name in consumed:
            continue
        labels, bare = _split_scope(name)
        scalars.setdefault(_sanitize(bare), []).append(
            (labels, value))
    for metric in sorted(scalars):
        lines.append(f'# TYPE {metric} untyped')
        for labels, value in sorted(scalars[metric],
                                    key=lambda kv: sorted(
                                        kv[0].items())):
            lines.append(
                f'{metric}{_label_str(labels)} {_fmt_value(value)}')
    return '\n'.join(lines) + '\n'


def dump_chrome_trace(events, path=None):
    """Convert observability events (a list of event dicts, a
    :class:`FlightRecorder`, or anything with ``.events()``) into a
    Chrome-trace/Perfetto JSON object. Completed ``span`` events
    become complete ("X") slices — one thread lane per trace id, so a
    cross-peer tick reads as one aligned group, EXCEPT the device
    phases (``device.*`` span names), which get one dedicated lane
    per phase so a 10k-doc bench trace shows the admit/pack/dispatch/
    device/patch-read split as aligned per-phase rows. ``counter``
    events (the sampled device profiler's utilization/memory/retrace
    samples) become Perfetto counter ("C") tracks — one per numeric
    field — and every other event becomes an instant ("i") on the
    shared events lane. With ``path``, the JSON is written atomically
    (snapshot-grade: never torn) and the object is still returned."""
    if hasattr(events, 'events'):
        events = events.events()
    PID = 1
    lane_of = {}                   # trace id -> tid (lane)
    device_lane_of = {}            # device phase name -> tid
    trace_events = []
    # device lanes and trace lanes share the tid space; device phases
    # allocate from the top so trace-lane ids stay dense from 1
    _DEVICE_BASE = 1 << 20
    for event in events:
        if not isinstance(event, dict):
            continue
        kind = event.get('event')
        ts = event.get('ts')
        if not isinstance(ts, (int, float)):
            continue
        if kind == 'span':
            dur_ms = event.get('dur_ms')
            if not isinstance(dur_ms, (int, float)) or dur_ms < 0:
                continue
            name = str(event.get('name', 'span'))
            if name.startswith('device.'):
                tid = device_lane_of.setdefault(
                    name, _DEVICE_BASE + len(device_lane_of))
            else:
                trace = event.get('trace')
                tid = lane_of.setdefault(trace, len(lane_of) + 1)
            args = {k: v for k, v in event.items()
                    if k not in ('event', 'ts', 'mono', 'name',
                                 'dur_ms')}
            trace_events.append({
                'name': name,
                'cat': 'span', 'ph': 'X', 'pid': PID, 'tid': tid,
                'ts': ts * 1e6 - dur_ms * 1e3,
                'dur': dur_ms * 1e3, 'args': args})
        elif kind == 'counter':
            for key, value in event.items():
                if key in ('event', 'ts', 'mono') or \
                        not isinstance(value, (int, float)) or \
                        isinstance(value, bool):
                    continue
                trace_events.append({
                    'name': key, 'cat': 'counter', 'ph': 'C',
                    'pid': PID, 'tid': 0, 'ts': ts * 1e6,
                    'args': {'value': value}})
        else:
            args = {k: v for k, v in event.items()
                    if k not in ('event', 'ts', 'mono')}
            trace_events.append({
                'name': str(kind), 'cat': 'event', 'ph': 'i',
                'pid': PID, 'tid': 0, 'ts': ts * 1e6, 's': 't',
                'args': args})
    meta = [{'ph': 'M', 'pid': PID, 'tid': 0, 'name': 'process_name',
             'args': {'name': 'automerge_tpu'}},
            {'ph': 'M', 'pid': PID, 'tid': 0, 'name': 'thread_name',
             'args': {'name': 'events'}}]
    for trace, tid in sorted(lane_of.items(), key=lambda kv: kv[1]):
        meta.append({'ph': 'M', 'pid': PID, 'tid': tid,
                     'name': 'thread_name',
                     'args': {'name': f'trace {trace}'}})
    for phase, tid in sorted(device_lane_of.items(),
                             key=lambda kv: kv[1]):
        meta.append({'ph': 'M', 'pid': PID, 'tid': tid,
                     'name': 'thread_name',
                     'args': {'name': phase}})
    out = {'traceEvents': meta + trace_events,
           'displayTimeUnit': 'ms'}
    if path is not None:
        from .durability import atomic_write_bytes
        atomic_write_bytes(
            path, json.dumps(out, default=repr).encode('utf-8'))
    return out
