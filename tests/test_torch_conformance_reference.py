"""The reference's conformance suite on the PyTorch port: the eleven JAX
test modules that port the reference's own test files (CONFORMANCE.md:
260 reference cases), re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect``, each case in a ``cpu``
lane and a ``cuda`` lane (the card, at the port's default device).

The port's ``init()`` makes device-backed documents, so every ``change``
of these cases goes through the per-doc device backend: the flat-map
kernel for map-only documents, the PyTorch resolve and the narrow RGA
kernel for lists and text.
"""

import torch

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_integration', 'test_integration_ext', 'test_proxies',
           'test_text', 'test_connection', 'test_frontend',
           'test_frontend_concurrency', 'test_backend',
           'test_watchable_uuid', 'test_device_undo',
           'test_device_sequences')

harness.recollect(globals(), MODULES)
