"""Tick wall times of the PyTorch port's general engine on one CUDA card,
in turns: another checkout's port against this tree's, and this tree's
with and without a metrics subscriber attached to every timed tick.

    mkdir -p _archive/base && git archive <commit> | tar -x -C _archive/base
    python3 tools/torch_tick_ab.py --base _archive/base \\
        [--docs 10240] [--out chiprun_out/tick_ab.json]

Each turn is a process of its own (``--turn``), which puts one
checkout's ``automerge_tpu_torch`` first on its path, builds its kernels
(outside the timings) and times, on ``chip_smoke.py``'s workloads:

- the config-5 fleet (``chip_smoke.gen_mixed_docs`` and ``gen_tick2``,
  ``--docs`` documents): each tick's ``apply_changes_batch`` wall time
  with the device drained, and its first patch read;
- on this tree only (the base need not carry the wide mirror): the long
  text (``chip_smoke.long_text_applies``, 32,760 chars then 48 ticks of
  8) in its two arms, the shipped one and ``_INDEX_MODE='rebuild'`` +
  ``_WINDOW_MODE='off'``: p50 and p90 of the tick (apply -> drained ->
  diff read) over the ticks after the 8th, the text checked against the
  host string at the end.

The turns run base, tree, tree+subscriber, tree+subscriber, tree, base,
so that a drift of the host's clock over the call shows as a difference
between the two turns of one arm. Prints one line per turn and a summary
with the card's name and power limit, and writes them all to ``--out``.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = (('base', False), ('tree', False), ('tree', True), ('tree', True),
         ('tree', False), ('base', False))


def _smoke():
    """This tree's ``chip_smoke.py`` (its generators), loaded from its
    file so that the checkout under test stays first on the path."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(fn, subscribe):
    """Wall ms of ``fn()`` with the device drained; with ``subscribe``,
    a metrics subscriber collects the span events meanwhile."""
    import torch
    from automerge_tpu_torch.utils.metrics import metrics
    events = []
    if subscribe:
        metrics.subscribe(events.append)
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out
    finally:
        if subscribe:
            metrics.unsubscribe(events.append)


def _fleet(smoke, n_docs, subscribe):
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    ticks = [smoke.gen_mixed_docs(n_docs, 48), smoke.gen_tick2(n_docs, 48)]
    ids = [f'doc{d}' for d in range(n_docs)]
    gds = GeneralDocSet(n_docs, device='cuda')
    out = {}
    for k, batch in enumerate(ticks):
        t_apply, _ = _timed(lambda: gds.apply_changes_batch(
            {ids[d]: batch[d] for d in range(n_docs)}), subscribe)
        t_read, _ = _timed(lambda: gds.last_patch.diffs(0), subscribe)
        out[f'tick{k + 1}_apply_ms'] = t_apply
        out[f'tick{k + 1}_read_ms'] = t_read
    return out


def _long_text(smoke, subscribe):
    from automerge_tpu_torch.device import general as G
    from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
    applies, texts = smoke.long_text_applies()
    out = {}
    saved = G._INDEX_MODE, G._WINDOW_MODE
    try:
        for arm, imode, wmode in (('incremental', None, None),
                                  ('rebuild', 'rebuild', 'off')):
            G._INDEX_MODE, G._WINDOW_MODE = imode, wmode
            ds = GeneralDocSet(1, device='cuda')
            times = []
            for k, ch in enumerate(applies):
                def tick():
                    ds.apply_changes('t', ch)
                    return ds.last_patch.diffs(0)
                dt, _ = _timed(tick, subscribe)
                if k > smoke.LONG_WARM:
                    times.append(dt)
            if ds.materialize('t')['text'] != texts[-1]:
                raise AssertionError(f'long text ({arm}) != host string')
            times.sort()
            out[f'long_{arm}_p50_ms'] = times[len(times) // 2]
            out[f'long_{arm}_p90_ms'] = times[int(0.9 * len(times))]
            out[f'long_{arm}_ms'] = times
    finally:
        G._INDEX_MODE, G._WINDOW_MODE = saved
    return out


def turn(args):
    """One turn in this process: the port of ``args.root``."""
    sys.path.insert(0, os.path.abspath(args.root))
    import automerge_tpu_torch
    from automerge_tpu_torch import native
    from automerge_tpu_torch.device import cuda_build
    if not automerge_tpu_torch.__file__.startswith(
            os.path.abspath(args.root)):
        raise RuntimeError(f'imported {automerge_tpu_torch.__file__}, not '
                           f'the port of {args.root}')
    cuda_build.build_all()
    native.build_all()
    smoke = _smoke()
    out = {'root': args.root, 'subscriber': args.subscribe}
    out.update(_fleet(smoke, args.docs, args.subscribe))
    if args.long_text:
        out.update(_long_text(smoke, args.subscribe))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--base', default=os.path.join(ROOT, '_archive', 'base'))
    ap.add_argument('--docs', type=int, default=10240)
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'automerge_tpu_torch', '_build', 'tick_ab.json'))
    ap.add_argument('--turn', action='store_true', help=argparse.SUPPRESS)
    ap.add_argument('--root', help=argparse.SUPPRESS)
    ap.add_argument('--subscribe', action='store_true',
                    help=argparse.SUPPRESS)
    ap.add_argument('--long-text', action='store_true',
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        return turn(args)
    card = _smoke()._card_line()
    print(card, flush=True)
    turns = []
    for who, sub in ORDER:
        root = args.base if who == 'base' else ROOT
        cmd = [sys.executable, os.path.abspath(__file__), '--turn',
               '--root', root, '--docs', str(args.docs)]
        cmd += ['--subscribe'] * sub + ['--long-text'] * (who == 'tree')
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False)
        if res.returncode:
            raise RuntimeError(f'turn {who} (subscriber {sub}) failed:\n'
                               f'{res.stdout}{res.stderr}')
        t = json.loads(res.stdout.strip().splitlines()[-1])
        t['who'] = who
        turns.append(t)
        print(f'{who}, subscriber {sub} ({card}): ' + ', '.join(
            f'{k} {v:.4f}' for k, v in t.items()
            if isinstance(v, float)), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump({'card': card, 'order': ORDER, 'turns': turns}, f,
                  indent=1)
    print(f'wrote {args.out}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
