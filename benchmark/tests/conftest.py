"""The benchmark's own tests: the CPU ones run anywhere, the ones marked
``cuda`` skip without a card. Run from the checkout's root:

    python -m pytest benchmark/tests -q
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink(cell, docs):
    """The cell at a size a CPU test holds: ``docs`` documents, texts of
    200-600 characters, a quarter of the texts touched a tick; every
    document checked."""
    cell.config = copy.deepcopy(cell.config)
    cell.config['docs'] = docs
    if cell.config['document']['object'] == 'text':
        cell.config['document']['load']['length'] = [200, 600]
    if cell.mix['docs']['pick'] != 'all':
        cell.mix = dict(cell.mix, docs=dict(cell.mix['docs'],
                                            count=max(1, docs // 4)))
    cell.settings = dict(cell.settings, check_docs=docs, warmup_ticks=1)
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark.harness import spec

    def make(name, docs=8):
        return shrink(spec.load_cell(name), docs)
    return make
