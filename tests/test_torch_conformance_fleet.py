"""The JAX package's fleet-simulator suite on the PyTorch port: seeded
schedules, replay determinism, the scorecard and every catalog scenario
held byte for byte to its oracle run (the ``slow`` full-scale cases stay
out of tier-1, as in the reference), re-collected against
``automerge_tpu_torch`` by ``test_torch_conformance_harness.recollect``
in a ``cpu`` and a ``cuda`` lane.
"""

import torch

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_fleetsim',)

harness.recollect(globals(), MODULES)
