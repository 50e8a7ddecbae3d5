"""The JAX package's wire and general-engine suites on the PyTorch port:
the wire codecs (JSON v1, columnar v2 and v3, the native codec), the
wire sync stack, the general backend and the batched materialization,
re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect`` in a ``cpu`` and a
``cuda`` lane.
"""

import torch

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_wire', 'test_wire_v2', 'test_wire_sync',
           'test_general_backend', 'test_general_materialize')

harness.recollect(globals(), MODULES)
