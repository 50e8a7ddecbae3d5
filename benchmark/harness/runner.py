"""One run of one cell: set-up, the measured window, the comparison.

Set-up plays the clients: it generates, from the seed, the load, the
warm-up ticks and the window's queue of ticks, and encodes each into the
wire bytes the system is handed (the cell's ``ticks_per_second`` times
``--seconds`` ticks, at least one: a fixed amount of work, the same for
every program). Then it plays the hub's set-up: the load is applied and
the warm-up ticks run, so every kernel and shape the window uses is
built.

The window is a closed loop at saturation: each tick's batch stands for
the queue that built up during the tick before, and the queued ticks run
back to back. Between two ticks the harness only picks the sampled
documents' patches out of the tick's diffs. The window runs from the
first tick's start to the last one's end on the host's clock, and ends
when the queue is done (or, for a program far slower than the queue was
sized for, at the first tick that ends three times ``--seconds`` after
the start).
"""

import contextlib
import gc
import sys
import time

from .check import LIMITS, Evidence, compare, sample_docs
from .record import Record
from .traffic import Generator

# the window ends at the first tick that ends this many times
# ``--seconds`` after it started, queue done or not
CAP = 3.0


def launch_count():
    """Kernel launches the program has counted so far (all three
    families)."""
    from automerge_tpu_torch.device import cuda_merge, cuda_sequence
    from automerge_tpu_torch.device import cuda_view
    return sum(sum(m.launches.values())
               for m in (cuda_sequence, cuda_view, cuda_merge))


def queue_length(cell, seconds):
    return max(1, round(seconds * cell.settings['ticks_per_second']))


def run_cell(cell, seed, seconds, trace, system, t_start, on_card=True):
    """Returns ``(result, record)``: ``result`` holds ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``check`` and, traced,
    ``busy_s`` / ``window_s`` / ``breakdown``; ``system`` is built by
    ``system(cell)``."""
    def log(msg):
        print(f'[{time.perf_counter() - t_start:8.2f} s] {msg}',
              file=sys.stderr, flush=True)

    sut = system(cell)
    gen = Generator(cell.n_docs, cell.config['document'], cell.mix, seed)
    load = gen.load()
    evidence = Evidence(sample_docs(
        cell.n_docs, cell.settings['check_docs'], seed,
        [rows[0] for rows in load.rows]))

    # the clients: every tick generated and encoded before the hub starts
    def client(tick):
        evidence.keep_changes(tick)
        sut.prepare(tick, gen)
        return tick

    client(load)
    warm = [client(gen.tick()) for _ in range(cell.settings['warmup_ticks'])]
    queue = [client(gen.tick()) for _ in range(queue_length(cell, seconds))]
    log(f'clients: load {load.n_ops} ops, {len(warm)} warm-up and '
        f'{len(queue)} queued ticks ({sum(t.n_ops for t in queue)} ops) '
        'generated and encoded')

    def step(tick, sampled):
        t0 = time.perf_counter()
        sut.apply(tick)
        if sampled is not None:
            evidence.keep_patches(tick, sut.read(tick, docs=sampled))
        sut.sync()
        log(f'tick {tick.index}: {tick.n_ops} ops, {len(tick.docs)} docs, '
            f'{time.perf_counter() - t0:.3f} s')

    # the hub's set-up: the documents as deployed (no client waits for
    # the load's patch), then warm-up ticks that read the sample's
    # patches (the first read of a tick runs the device read for the
    # whole tick, so every kernel is built)
    step(load, None)
    for tick in warm:
        step(tick, evidence.sampled(tick))
    gen = None
    gc.collect()
    setup_s = time.perf_counter() - t_start
    log(f'set-up done: {setup_s:.3f} s')

    record = Record()
    times = []
    launches0 = launch_count()
    with contextlib.ExitStack() as stack:
        if trace:
            from .trace import DeviceProfiler, SpanRecorder
            stack.enter_context(SpanRecorder(record))
            if on_card:
                stack.enter_context(DeviceProfiler(record))
        for tick in queue:
            t0 = time.perf_counter()
            sut.apply(tick)
            t_apply = time.perf_counter()
            diffs = sut.read(tick)
            sut.sync()
            t1 = time.perf_counter()
            evidence.keep_patches(tick, diffs)
            diffs = None
            times.append((t0, t_apply, t1))
            if t1 - times[0][0] >= CAP * seconds:
                break
    record.launches = launch_count() - launches0
    done = queue[:len(times)]
    for tick, (t0, t_apply, t1) in zip(done, times):
        record.ticks.append({'t0': t0, 't_apply': t_apply, 't1': t1,
                             'ops': tick.n_ops, 'changes': tick.n_changes,
                             'rows': tick.rows})
        if trace:
            record.host_spans += [('harness.tick', t0, t1),
                                  ('harness.apply_wire', t0, t_apply),
                                  ('harness.patch_read', t_apply, t1)]
    if trace:
        record.host_spans += [('harness.between', a[2], b[0])
                              for a, b in zip(times, times[1:])]
    ticks_ms = sorted((t1 - t0) * 1e3 for t0, _, t1 in times)
    log(f'window done: {record.n_ticks} of {len(queue)} ticks, '
        f'{record.window_s:.3f} s; tick {ticks_ms[0]:.1f}-'
        f'{ticks_ms[-1]:.1f} ms')
    memory_peak = None
    if on_card:
        import torch
        memory_peak = torch.cuda.max_memory_allocated()

    # the system's answers, then its state freed, then the reference
    evidence.clocks = {d: sut.clock(d) for d in range(cell.n_docs)}
    evidence.views = {d: sut.view(d) for d in evidence.sample}
    sut.close()
    log('answers read, system freed')
    handed = [load] + warm + done
    expected = [{} for _ in range(cell.n_docs)]
    for tick in handed:
        for d, actor, seq in tick.ids:
            if expected[d].get(actor, 0) < seq:
                expected[d][actor] = seq
    window_ids = [x for tick in done for x in tick.ids]
    values = compare(evidence, [t.index for t in handed], window_ids,
                     dict(enumerate(expected)), seed)
    log('comparison done')
    check = {name: {'value': values[name], 'limit': limit}
             for name, limit in LIMITS.items()}
    correct = all(values[n] <= lim for n, lim in LIMITS.items())

    result = {'correct': correct,
              'attempted': len(window_ids),
              'failed': values['failed_changes'],
              'setup_s': setup_s,
              'ops_per_s': sum(t['ops'] for t in record.ticks)
              / record.window_s,
              'memory_peak_bytes': memory_peak,
              'ticks': record.n_ticks,
              'check': check}
    if trace and record.device is not None:
        from .trace import breakdown, busy_and_gaps
        busy, _ = busy_and_gaps([(s, e) for _, s, e in record.device],
                                record.window())
        result['busy_s'] = busy
        result['window_s'] = record.window_s
        result['breakdown'] = breakdown(record)
    return result, record
