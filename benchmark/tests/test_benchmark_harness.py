"""The harness on the CPU: the generators, the agreement of the plain
reference with the port at a tiny size, cells found by name, and the
modules a run loads."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.harness import spec
from benchmark.harness.runner import run_cell
from benchmark.harness.runner import queue_length
from benchmark.harness.traffic import Generator
from benchmark.reference.crdt import Doc

from benchmark.tests.conftest import ROOT


def _port(cell):
    return cell.make_system('cpu')


def _ticks(cell, seed, n):
    gen = Generator(cell.n_docs, cell.config['document'], cell.mix, seed)
    load = gen.load()
    return load, [gen.tick() for _ in range(n)]


@pytest.mark.parametrize('name', ['lists2k.merge', 'texts128.typing'])
def test_generator_is_deterministic_per_seed(tiny_cell, name):
    cell = tiny_cell(name, docs=16)
    seed = 2**31 + 12345             # more than 32 signed bits hold
    a_load, a = _ticks(cell, seed, 4)
    b_load, b = _ticks(cell, seed, 4)
    assert a_load.changes == b_load.changes
    assert [t.changes for t in a] == [t.changes for t in b]
    _, c = _ticks(cell, seed + 1, 4)
    assert [t.changes for t in a] != [t.changes for t in c]


def test_merge_op_counts(tiny_cell):
    cell = tiny_cell('lists2k.merge', docs=32)
    load, ticks = _ticks(cell, 7, 3)
    assert load.n_ops == 113 * 32
    for t in ticks:
        assert t.n_ops == 99 * 32
        assert t.n_changes == 2 * 32
        # each tick adds 4 cards to every list
        assert all(new == 4 for _, new, _ in t.rows)
    # as run: 2,048 documents, 202,752 ops a tick
    full = spec.load_cell('lists2k.merge')
    assert 99 * full.n_docs == 202752
    assert 113 * full.n_docs == full.config['load_ops']


def test_cards_are_maps(tiny_cell):
    """The README's card list: each card a map with a string title and
    a bool done, linked into the list; the writers set card fields."""
    cell = tiny_cell('lists2k.merge', docs=4)
    load, ticks = _ticks(cell, 9, 2)
    doc = Doc()
    doc.apply(load.changes[0])
    view = doc.view()
    assert set(view) == {'cards', 'meta'} and len(view['cards']) == 22
    for card in view['cards']:
        assert set(card) == {'title', 'done'}
        assert isinstance(card['title'], str) and \
            isinstance(card['done'], bool)
    ops = [op for c in ticks[0].changes[0] for op in c['ops']]
    field_sets = [op for op in ops if op['action'] == 'set'
                  and op['key'] in ('title', 'done')
                  and op['obj'] != ops[0]['obj']]
    assert len([op for op in ops if op['action'] == 'makeMap']) == 4
    assert len(field_sets) >= 2 * 38
    doc.apply(ticks[0].changes[0])
    assert len(doc.view()['cards']) == 22 + 4 - 2


def test_typing_op_counts(tiny_cell):
    cell = tiny_cell('texts128.typing', docs=128)
    cell.mix = dict(cell.mix, docs=dict(cell.mix['docs'], count=32))
    load, ticks = _ticks(cell, 11, 30)
    assert all(len(t.docs) <= 32 for t in ticks)
    mean = sum(t.n_ops for t in ticks) / len(ticks)
    assert 2500 <= mean <= 3500
    # the configuration's own texts: 2,000-10,000 characters, about
    # 2 ops a character (checked on a few documents)
    full = spec.load_cell('texts128.typing')
    gen = Generator(4, full.config['document'], full.mix, 11)
    lengths = [nodes for nodes, _, _ in gen.load().rows]
    assert all(2000 <= n <= 10000 for n in lengths)


@pytest.mark.parametrize('name', ['lists2k.merge', 'texts128.typing'])
def test_reference_agrees_with_the_port(tiny_cell, name):
    cell = tiny_cell(name)
    res, rec = run_cell(cell, 3_000_000_017, 0.5, True, _port,
                        time.perf_counter(), on_card=False)
    assert res['correct'], res['check']
    assert res['attempted'] > 0 and res['failed'] == 0
    assert rec.n_ticks >= 1
    # the span readers find the program's spans
    for m in ('wire_parse_ms', 'admit_stage_ms', 'dispatch_ms',
              'apply_rest_ms', 'patch_read_ms', 'tick_ms_p95'):
        assert cell.metric_reader(m)(rec) is not None, m
    # no device trace on the CPU: the device readers stay silent
    for m in ('rga_roofline', 'edit_stream_roofline', 'device_idle_pct'):
        assert cell.metric_reader(m)(rec) is None, m


def test_zipf_pick_is_skewed_and_distinct(tiny_cell):
    cell = tiny_cell('lists2k.merge', docs=64)
    cell.mix = dict(cell.mix, docs={'pick': 'zipf', 'count': 8, 's': 0.99})
    gen = Generator(cell.n_docs, cell.config['document'], cell.mix, 3)
    gen.load()
    counts = [0] * 64
    for _ in range(40):
        t = gen.tick()
        assert len(t.docs) == 8 == len(set(t.docs))
        assert t.docs == sorted(t.docs)
        for d in t.docs:
            counts[d] += 1
    top = gen._ranking[:4].tolist()
    tail = gen._ranking[-16:].tolist()
    assert sum(counts[d] for d in top) > sum(counts[d] for d in tail)


def test_window_is_the_queue_on_the_wall_clock(tiny_cell):
    """Every queued tick is generated and encoded in set-up; the window
    runs them all and spans the first start to the last end."""
    cell = tiny_cell('texts128.typing', docs=8)
    prepared = []

    def make(c):
        sut = c.make_system('cpu')
        real = sut.prepare

        def prepare(tick, gen):
            prepared.append((tick.index, time.perf_counter()))
            real(tick, gen)
        sut.prepare = prepare
        return sut
    res, rec = run_cell(cell, 12, 0.5, False, make, time.perf_counter(),
                        on_card=False)
    assert res['correct'], res['check']
    assert rec.n_ticks == queue_length(cell, 0.5) == 6
    assert len(prepared) == 1 + 1 + 6          # load, warm-up, queue
    assert max(t for _, t in prepared) < rec.ticks[0]['t0']
    assert rec.window_s == rec.ticks[-1]['t1'] - rec.ticks[0]['t0']
    assert res['ops_per_s'] == pytest.approx(
        sum(t['ops'] for t in rec.ticks) / rec.window_s)


def test_new_cell_mix_system_and_metric_found_by_name(tmp_path):
    """A later PR adds files and BENCHMARK.json entries only: a Zipf mix
    (a data file), a configuration naming a new system, a cell and a
    metric."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(ROOT, 'benchmark'), root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    before = {p: open(p, 'rb').read()
              for p in map(str, (root / 'benchmark').rglob('*.*'))}
    b = root / 'benchmark'
    (b / 'traffic' / 'edits.json').write_text(json.dumps(
        {'docs': {'pick': 'zipf', 'count': 3, 's': 0.99}, 'writers': 1,
         'new_actors': True, 'p_write': 1.0, 'keys': [1, 1],
         'backspace': 0.0, 'jump': 1.0, 'sets': [2, 2], 'deletes': [1, 1],
         'root_sets': {'meta': [0]}}))
    conf = json.load(open(b / 'configs' / 'lists2k.json'))
    conf.update(name='lists64', docs=64, system='plain_hub')
    (b / 'configs' / 'lists64.json').write_text(json.dumps(conf))
    (b / 'systems' / 'plain_hub.py').write_text(
        'from benchmark.harness.reference_system import ReferenceSystem\n'
        '\n\ndef make(cell, device):\n'
        '    return ReferenceSystem(cell.n_docs)\n')
    (b / 'cells' / 'lists64.edits.json').write_text(json.dumps(
        {'config': 'lists64', 'traffic': 'edits', 'warmup_ticks': 1,
         'ticks_per_second': 10, 'check_docs': 64}))
    (b / 'metrics' / 'ticks_seen.py').write_text(
        'def read(rec):\n    return float(rec.n_ticks)\n')
    bench['configs'].append({'name': 'lists64', 'source': 'a test',
                             'file': 'benchmark/configs/lists64.json',
                             'reduced': ['docs'], 'why': 'a test'})
    bench['workloads'].append({'name': 'lists64.edits',
                               'config': 'lists64', 'traffic': 'edits',
                               'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({'name': 'ticks_seen', 'unit': 'ticks',
                               'better': 'higher',
                               'source': 'program_counter',
                               'layer': 'sync surface',
                               'moves': 'ops_per_s',
                               'workloads': ['lists64.edits']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    cell = spec.load_cell('lists64.edits', root=str(root))
    assert [m['name'] for m in cell.per_layer] == ['ticks_seen']
    assert cell.mix['docs']['pick'] == 'zipf'
    res, rec = run_cell(cell, 5, 0.5, False, lambda c: c.make_system(),
                        time.perf_counter(), on_card=False)
    assert res['correct'], res['check']
    assert rec.n_ticks == 5
    assert all(len(t['rows']) == 3 for t in rec.ticks)
    assert cell.metric_reader('ticks_seen')(rec) == rec.n_ticks
    # nothing that was there changed
    for p, data in before.items():
        assert open(p, 'rb').read() == data, p


_PROBE = r'''
import functools, sys
root, repo, stub = sys.argv[1:4]
sys.path[:0] = [root, repo] + ([stub] if stub else [])
import torch
# the run's own code on the CPU: a stand-in for the card's calls
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda i=0: 'stand-in'
torch.cuda.max_memory_allocated = lambda *a: 0
torch.cuda.synchronize = lambda *a: None
torch.cuda.empty_cache = lambda: None
from benchmark.harness import runner, spec
from benchmark.tests.conftest import shrink
load = spec.load_cell
spec.load_cell = lambda name, r=None: shrink(load(name, r), 4)
runner.run_cell = functools.partial(runner.run_cell, on_card=False)
make = spec.Cell.make_system
spec.Cell.make_system = lambda self, device='cuda': make(self, 'cpu')
import benchmark.run as run
rc = run.main(['--workload', 'texts128.typing', '--seed', '1',
               '--seconds', '0.2', '--trace', '1'])
print('RC', rc)
print('LOADED', sorted({n.split('.')[0] for n in sys.modules}))
'''


@pytest.mark.parametrize('with_jax', [False, True])
def test_a_run_loads_no_jax_and_no_reference_package(tmp_path, with_jax):
    """Top-level names compared whole: ``automerge_tpu_torch`` begins
    with ``automerge_tpu`` and is allowed; ``benchmark`` is not
    ``bench``. The check runs after every per-layer reader has run, just
    before the result: a reader that loads ``jax`` (here a stub of that
    name) leaves the run with no result."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(ROOT, 'benchmark'), root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    stub = ''
    if with_jax:
        (tmp_path / 'stub' / 'jax').mkdir(parents=True)
        (tmp_path / 'stub' / 'jax' / '__init__.py').write_text('')
        stub = str(tmp_path / 'stub')
        (root / 'benchmark' / 'metrics' / 'uses_jax.py').write_text(
            'import jax  # noqa: F401\n\n\ndef read(rec):\n'
            '    return 1.0\n')
        bench['per_layer'].append({'name': 'uses_jax', 'unit': 'x',
                                   'better': 'lower',
                                   'source': 'program_counter',
                                   'layer': 'sync surface',
                                   'moves': 'ops_per_s',
                                   'workloads': ['texts128.typing']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, '-c', _PROBE, str(root), ROOT, stub],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    rc = int(lines[-2].split()[1])
    loaded = eval(lines[-1].split(' ', 1)[1])
    results = [x for x in lines[:-2] if x.startswith('{')]
    if with_jax:
        assert rc != 0 and not results
        assert 'jax' in loaded
        assert "forbidden modules loaded: ['jax']" in out.stderr
        return
    assert rc == 0 and len(results) == 1, out.stderr[-3000:]
    line = json.loads(results[0])
    assert list(line)[-1] == 'check' and line['correct']
    assert 'automerge_tpu_torch' in loaded and 'benchmark' in loaded
    for bad in ('jax', 'jaxlib', 'flax', 'automerge_tpu', 'bench'):
        assert bad not in loaded, bad


def test_no_card_no_result():
    """Without a CUDA card a run prints no result and fails."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'lists2k.merge', '--seed', '1', '--seconds', '1', '--trace',
         '0'], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_checkout_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ is no system."""
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'lists2k.merge', '--seed', '1', '--seconds', '1', '--trace',
         '0'], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_a_bool_read_back_as_an_int_is_wrong():
    """``True == 1`` in Python: the comparison tags bools where the
    states are made, so a patch that turns a bool into an int fails."""
    from benchmark.reference.client import ClientView
    from benchmark.reference.crdt import ROOT_ID
    doc = Doc()
    doc.apply([{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'done', 'value': True}]}])
    for value, same in ((1, False), (True, True)):
        client = ClientView()
        client.apply([{'action': 'set', 'type': 'map', 'obj': ROOT_ID,
                       'key': 'done', 'value': value}])
        assert (client.state() == doc.state()) is same
