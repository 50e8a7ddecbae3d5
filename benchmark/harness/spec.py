"""Finds a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix and the metrics; the
rest sits in files of its own under ``benchmark/``:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), which
  names its system,
- ``systems/<system>.py``, the system under test's entry (``make``),
- ``traffic/<traffic>.json``, the mix's parameters, read by the one
  generator (``harness/traffic.py``),
- ``cells/<cell>.json``, the cell's own settings,
- ``metrics/<metric>.py``, one reader a per-layer metric.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(Exception):
    pass


def _json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f'missing file {path}') from None


class Cell:
    def __init__(self, name, entry, config, mix, settings, end_to_end,
                 per_layer, root):
        self.name = name
        self.chips = entry['chips']
        self.config_name = entry['config']
        self.traffic_name = entry['traffic']
        self.config = config
        self.mix = mix
        self.settings = settings
        self.end_to_end = end_to_end
        self.per_layer = per_layer
        self.root = root

    @property
    def n_docs(self):
        return self.config['docs']

    def metric_reader(self, name):
        """The ``read(record)`` function of ``metrics/<name>.py``."""
        return _module(self.root, 'metrics', name).read

    def make_system(self, device='cuda'):
        """The system under test, built by ``systems/<system>.py``'s
        ``make(cell, device)``; the configuration names the system."""
        return _module(self.root, 'systems',
                       self.config['system']).make(self, device)


def _module(root, folder, name):
    path = os.path.join(root, 'benchmark', folder, f'{name}.py')
    if not os.path.exists(path):
        raise SpecError(f'no file {path}')
    spec = importlib.util.spec_from_file_location(
        f'benchmark_{folder}_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for(metrics, cell):
    return [m for m in metrics
            if 'workloads' not in m or cell in m['workloads']]


def load_cell(name, root=ROOT):
    bench = _json(os.path.join(root, 'BENCHMARK.json'))
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise SpecError(f'no workload {name!r} in BENCHMARK.json')
    conf = next((c for c in bench['configs']
                 if c['name'] == entry['config']), None)
    if conf is None:
        raise SpecError(f'no config {entry["config"]!r} in BENCHMARK.json')
    config = _json(os.path.join(root, conf['file']))
    mix = _json(os.path.join(root, 'benchmark', 'traffic',
                             f'{entry["traffic"]}.json'))
    settings = _json(os.path.join(root, 'benchmark', 'cells',
                                  f'{name}.json'))
    for key in ('config', 'traffic'):
        if settings.get(key) != entry[key]:
            raise SpecError(f'cells/{name}.json names {key} '
                            f'{settings.get(key)!r}, BENCHMARK.json '
                            f'{entry[key]!r}')
    return Cell(name, entry, config, mix, settings,
                _for(bench['end_to_end'], name),
                _for(bench['per_layer'], name), root)
