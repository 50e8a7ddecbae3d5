"""The JAX package's serving suites on the PyTorch port: the serving
doc set (admission, flow control, eviction and fault-in, durability,
overload chaos, fleet status), the fleet controller, telemetry and
tracing, re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect`` in a ``cpu`` and a
``cuda`` lane. ``test_fleetsim`` runs in
``test_torch_conformance_fleet.py``, so each file stays short.
"""

import torch

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_serving', 'test_control', 'test_telemetry',
           'test_tracing')

harness.recollect(globals(), MODULES)
