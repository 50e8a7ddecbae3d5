"""Run one cell of the benchmark of ``automerge_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix and metrics are found by name
(``benchmark/harness/spec.py``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, each
number the comparison read beside its limit (also the last lines of
standard error). With no CUDA card, or fewer than the cell asks for, it
prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules that must not be loaded in the process that prints a result,
# compared by their whole top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'automerge_tpu', 'bench')


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules} &
                  set(FORBIDDEN))


def _power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits', '-i', '0'],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program builds its kernels under ``automerge_tpu_torch/_build``
    and its host codec under ``automerge_tpu_torch/_native``)."""
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ.setdefault('USE_FLAX', '0')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec
    try:
        cell = spec.load_cell(args.workload, ROOT)
    except spec.SpecError as exc:
        print(f'benchmark: {exc}', file=sys.stderr)
        return 2
    _caches()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'benchmark: {cell.name} needs {cell.chips} CUDA card(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 3
    try:
        import automerge_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f'benchmark: the program is missing: {exc}', file=sys.stderr)
        return 4

    from benchmark.harness.runner import run_cell
    res, record = run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        lambda c: c.make_system('cuda'), T_START)

    units = {m['name']: m['unit'] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m['name'])(record)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': units[m['name']]}
    else:
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': res[m['name']],
                                  'unit': units[m['name']]}
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': cell.chips,
              'memory_peak_bytes': res['memory_peak_bytes'],
              'power_limit_w': _power_limit()}
    for key in ('busy_s', 'window_s'):
        if args.trace and key in res:
            device[key] = res[key]
    line = {'correct': res['correct'], 'attempted': res['attempted'],
            'failed': res['failed'], 'metrics': metrics, 'device': device,
            'ticks': res['ticks']}
    if args.trace and 'breakdown' in res:
        line['breakdown'] = res['breakdown']
    line['check'] = res['check']
    # every reader has run: nothing may have loaded JAX or the JAX
    # package into this process
    found = forbidden_modules()
    if found:
        print(f'benchmark: forbidden modules loaded: {found}',
              file=sys.stderr)
        return 5
    for name, c in res['check'].items():
        print(f'check {name} {c["value"]} limit {c["limit"]}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
