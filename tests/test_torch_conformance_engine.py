"""The JAX package's general-engine suites on the PyTorch port: the
general engine and its blocks, the device-backed integration cases,
the native codec and the editing traces,
re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect`` in a ``cpu`` and a
``cuda`` lane.

``test_traces`` hands numpy planes to ``rga_order``, as a user of the
reference's device functions may: the port's take any array, and a host
array runs the plain version on the host. ``test_stage_cache`` imports
from ``test_sequence_index``, which imports ``jax``: it runs in
``test_torch_conformance_index.py``, on the CPU only.
"""

import torch

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_general', 'test_blocks', 'test_integration_device',
           'test_native', 'test_traces')

harness.recollect(globals(), MODULES)
