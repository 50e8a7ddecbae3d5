"""The control of the comparison: the plain reference put in the
program's place with one guarantee the configurations state broken, run
through the rest of a benchmark run at the cell's own size. It must come
out not correct. The benchmark's own runs never run it.

The guarantee broken is convergence: siblings of the insertion tree are
kept in arrival order instead of descending ``(elem, actor)``, the step a
faster orderer would be tempted to skip. Two replicas given the same
concurrent inserts in another order would then disagree.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        --seconds 3 [--plain]

``--plain`` runs the unbroken reference instead, which must come out
correct. ``--fault <name>`` runs the program with a fault of
``benchmark/harness/faults.py`` planted under its timed path instead
(on the card, or ``--device cpu``). Prints one line a seed: the seed,
``correct`` and each number compared.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.reference_system import ReferenceSystem  # noqa: E402
from benchmark.reference.crdt import HEAD, Doc, Sequence  # noqa: E402


class ArrivalSequence(Sequence):
    """Siblings in arrival order: a new element goes after its parent's
    whole subtree."""

    def insert(self, parent, eid, elem, actor):
        if parent != HEAD and parent not in self.rank:
            raise ValueError(f'insert after unknown element {parent}')
        self.rank[eid] = (elem, actor)
        self.children[parent].append(eid)
        self.children[eid] = []
        self.parent[eid] = parent
        self.order = None


class ArrivalDoc(Doc):
    sequence_class = ArrivalSequence


class ControlSystem(ReferenceSystem):
    doc_class = ArrivalDoc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--plain', action='store_true')
    ap.add_argument('--fault')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from benchmark.harness import spec
    from benchmark.harness.runner import run_cell
    cell = spec.load_cell(args.workload, ROOT)
    if args.fault:
        from benchmark.harness.faults import FaultySystem

        def make(c):
            return FaultySystem(c.make_system(args.device), args.fault)
    else:
        cls = ReferenceSystem if args.plain else ControlSystem

        def make(c):
            return cls(c.n_docs)
    on_card = bool(args.fault) and args.device != 'cpu'
    for seed in args.seeds:
        res, _ = run_cell(cell, seed, args.seconds, False, make,
                          time.perf_counter(), on_card=on_card)
        print(json.dumps({'seed': seed, 'correct': res['correct'],
                          'ticks': res['ticks'],
                          'check': {k: v['value']
                                    for k, v in res['check'].items()}}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
