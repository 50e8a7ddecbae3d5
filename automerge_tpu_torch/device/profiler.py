"""Device-path performance observatory: retrace tracking + sampled
per-phase device-time attribution.

The kernel/e2e gap (ROADMAP: 26.6M ops/s kernel vs 1.3M general
engine) can only be attacked with attribution, and the two classic
silent killers in a jit-heavy serving stack are invisible by default:

- **Recompiles.** XLA compiles one program per distinct shape
  signature; a workload that keeps crossing padding buckets (or a
  refactor that leaks a new static argument) spends seconds per tick
  in the compiler while every counter still reads "healthy".
  :func:`note_dispatch` wraps every jit entry point in a
  shape-signature registry: each dispatch records its signature, the
  first sighting counts as a compile (``device_compiles_total``), a
  new signature on an already-compiled function counts as a RETRACE
  (``device_retraces_total``), emits a ``recompile`` event into the
  flight recorder, and feeds the ``recompile_storm`` health signal
  (``GeneralDocSet._health_signals`` grades the per-quantum retrace
  delta). Per-function slices land under ``jit/<fn>/...`` scope keys,
  which the Prometheus exporter re-expresses as labels
  (``device_compiles{jit="general.fused_packed"}``); the padded row
  count of every dispatch feeds the ``device_dispatch_rows`` histogram
  — the shape-bucket distribution.

- **Unattributed device time.** Between ``doc_set.apply`` and the
  fused program, production ticks are a black box: the dispatch
  returns immediately (JAX async), so host timing points cannot see
  where the device time went. :func:`should_sample` +
  :func:`record_phases` promote the bench-only admit/pack/dispatch/
  device split to an always-on SAMPLED profiler: every Nth apply
  (``AUTOMERGE_TPU_PROFILE_SAMPLE``, default 16; 0 disables) fences
  with ``block_until_ready`` and records real per-phase time into the
  shared 96-bucket histogram series (``device_admit_ms`` /
  ``device_pack_ms`` / ``device_dispatch_ms`` / ``device_run_ms``;
  ``device_patch_read_ms`` closes the read side), plus a
  ``device_utilization`` gauge (device ms / wall ms of the sampled
  apply). Off-sample applies pay ONE integer check — the idle-observer
  smoke guard (``bench.py --smoke``) asserts it stays inside the
  existing ns/site budget.

Sampled ticks also emit a ``counter`` event (utilization, device
memory, retrace total) when a subscriber is attached — the Perfetto
exporter (:func:`automerge_tpu.telemetry.dump_chrome_trace`) renders
those as counter tracks alongside the per-phase device lanes.

Everything here is process-wide by design: jit caches are process
state, so the signature registry must be too (two doc sets dispatching
the same shapes share one compile). ``reset()`` exists for tests.
"""

import os
import threading

from ..utils.metrics import metrics

# Sampling cadence for the per-phase device profiler: every Nth apply
# fences and attributes; 0 disables sampling entirely. The default of
# 16 keeps the fence cost (one pipeline bubble per sample) under a few
# percent of wall clock on the 10k-doc sync bench.
SAMPLE_EVERY = int(os.environ.get('AUTOMERGE_TPU_PROFILE_SAMPLE',
                                  '16'))

_lock = threading.Lock()
_signatures = {}           # fn -> set of shape signatures seen
_tick = 0                  # dispatch counter driving the sampler


def set_sample_every(n):
    """Set the sampling cadence (0 disables). Returns the previous
    value — tests force 1 and restore."""
    global SAMPLE_EVERY
    prev = SAMPLE_EVERY
    SAMPLE_EVERY = int(n)
    return prev


def should_sample():
    """True on every ``SAMPLE_EVERY``-th call — the off-sample fast
    path is one integer add + modulo (no lock: a rare lost increment
    under thread races shifts a sample point, never corrupts)."""
    global _tick
    if SAMPLE_EVERY <= 0:
        return False
    _tick = t = _tick + 1
    return t % SAMPLE_EVERY == 0


def shape_bucket(n):
    """Next power of two >= n — the padding-style bucket used to
    signature host-side vectorized entry points (winner select,
    visible walk), whose 'retrace' analog is a new size class."""
    return 1 << max(int(n) - 1, 0).bit_length()


def note_dispatch(fn, signature, rows=None, jit=True):
    """Record one dispatch of tracked entry point ``fn`` with shape
    ``signature`` (any hashable — static args + operand shape/dtype
    tuple). For jit entries (the default), the first sighting of a
    signature is a compile (``device_compiles_total``) and a new
    signature on an already-compiled function is a retrace (counted,
    flight-recorded, feeds ``recompile_storm``). With ``jit=False``
    (the host-side vectorized view gathers, whose size-class growth
    is worth tracking but costs NO XLA compile), the signature set
    and the per-fn ``device_signatures`` gauge still grow but the
    compile/retrace totals and the storm signal are untouched.
    ``rows`` (the padded leading row count) feeds the shape-bucket
    distribution histogram. Returns True when the signature was
    new."""
    with _lock:
        seen = _signatures.get(fn)
        if seen is None:
            seen = _signatures[fn] = set()
        fresh = signature not in seen
        if fresh:
            seen.add(signature)
        n_sigs = len(seen)
    metrics.bump('device_dispatches_total')
    if rows is not None:
        metrics.observe('device_dispatch_rows', float(rows))
    if not fresh:
        return False
    metrics.set_gauge(f'jit/{fn}/device_signatures', n_sigs)
    if not jit:
        return True
    metrics.bump('device_compiles_total')
    metrics.bump(f'jit/{fn}/device_compiles')
    if n_sigs > 1:
        # beyond the first compile of fn: a RETRACE — the silent perf
        # killer this registry exists to surface
        metrics.bump('device_retraces_total')
        metrics.bump(f'jit/{fn}/device_retraces')
        if metrics.active:
            metrics.emit('recompile', fn=fn, signatures=n_sigs,
                         signature=repr(signature))
    return True


def signature_counts():
    """{fn: distinct signatures seen} — the live registry view."""
    with _lock:
        return {fn: len(sigs) for fn, sigs in _signatures.items()}


def record_phases(admit_ms, pack_ms, dispatch_ms, run_ms, wall_ms,
                  idx_ms=None):
    """Fold one SAMPLED apply's per-phase attribution into the shared
    histogram series and the utilization gauge; with a subscriber
    attached, also emit a ``counter`` event for the Perfetto counter
    tracks (utilization, device-plane bytes, retraces). ``idx_ms``
    (when the sampled apply took the incremental index-update path)
    additionally feeds ``device_idx_update_ms`` — the fused merge
    pass's fenced run time, separable from rebuild-path samples."""
    metrics.observe('device_admit_ms', admit_ms)
    metrics.observe('device_pack_ms', pack_ms)
    metrics.observe('device_dispatch_ms', dispatch_ms)
    metrics.observe('device_run_ms', run_ms)
    if idx_ms is not None:
        metrics.observe('device_idx_update_ms', idx_ms)
    util = run_ms / wall_ms if wall_ms > 0 else 0.0
    metrics.set_gauge('device_utilization', util)
    if metrics.active:
        counters = metrics.counters
        metrics.emit(
            'counter',
            device_utilization=round(util, 4),
            device_run_ms=round(run_ms, 4),
            mem_device_plane_bytes=counters.get(
                'mem_device_plane_bytes', 0),
            device_retraces_total=counters.get(
                'device_retraces_total', 0))


def retraces_total():
    """The process-wide retrace count — what the ``recompile_storm``
    health signal differentiates per serving quantum."""
    return metrics.counters.get('device_retraces_total', 0)


def reset():
    """Clear the signature registry and the sample counter (tests
    only — in production the registry mirrors the process's jit
    caches, which never forget either)."""
    global _tick
    with _lock:
        _signatures.clear()
        _tick = 0
