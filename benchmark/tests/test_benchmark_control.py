"""The comparison has to fail what is wrong: the control (the plain
reference with convergence broken, in the program's place) and each
fault a cell can have, planted under the timed path of a run on the CPU
at a tiny size. The unbroken reference in the program's place passes."""

import subprocess
import sys
import time

import pytest

from benchmark.control import ControlSystem
from benchmark.harness.reference_system import ReferenceSystem
from benchmark.harness.runner import run_cell
from benchmark.harness.faults import FAULTS, FaultySystem

from benchmark.tests.conftest import ROOT

CELLS = ['lists2k.merge', 'texts128.typing']


def _run(cell, system, seed=41, seconds=0.5):
    res, _ = run_cell(cell, seed, seconds, False, system,
                      time.perf_counter(), on_card=False)
    return res


@pytest.mark.parametrize('name', CELLS)
def test_plain_reference_in_place_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name), lambda c: ReferenceSystem(c.n_docs))
    assert res['correct'], res['check']


@pytest.mark.parametrize('seed', [1, 2, 3])
@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(tiny_cell, name, seed):
    res = _run(tiny_cell(name, docs=16), lambda c: ControlSystem(c.n_docs),
               seed=seed)
    assert not res['correct'], res['check']
    assert res['check']['patch_mismatch_docs']['value'] > 0


@pytest.mark.parametrize('fault', FAULTS)
@pytest.mark.parametrize('name', CELLS)
def test_faults_under_the_timed_path_are_not_correct(tiny_cell, name,
                                                     fault):
    def make(c):
        return FaultySystem(c.make_system('cpu'), fault)
    res = _run(tiny_cell(name), make)
    assert not res['correct'], (fault, res['check'])


@pytest.mark.parametrize('name', CELLS)
def test_control_script(tiny_cell, name, monkeypatch):
    """The script the control runs on the card, at a tiny size."""
    from benchmark import control
    from benchmark.harness import spec
    from benchmark.tests.conftest import shrink
    real = spec.load_cell
    monkeypatch.setattr(spec, 'load_cell',
                        lambda n, root=ROOT: shrink(real(n, root), 8))
    control.main(['--workload', name, '--seeds', '5', '--seconds', '0.3'])
    control.main(['--workload', name, '--seeds', '5', '--seconds', '0.3',
                  '--plain'])
    control.main(['--workload', name, '--seeds', '5', '--seconds', '0.3',
                  '--fault', 'unchanged', '--device', 'cpu'])


@pytest.mark.cuda
def test_cells_on_the_card():
    """Each cell once on the card, briefly: a result line, correct."""
    import json
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card')
    for name in CELLS:
        out = subprocess.run(
            [sys.executable, 'benchmark/run.py', '--workload', name,
             '--seed', '7', '--seconds', '1', '--trace', '0'],
            capture_output=True, text=True, cwd=ROOT, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line['correct'], line['check']
