"""The JAX package's device, snapshot, compaction and interop suites on
the PyTorch port: the per-doc device backend, the background-thread
backend, packed snapshots and durability, compaction and eviction, the
reference-save loader, the text block and the cross-engine parity
cases, re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect`` in a ``cpu`` and a
``cuda`` lane.
"""

import pytest
import torch

import automerge_tpu_torch as am
from automerge_tpu_torch import snapshot

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_device_backend', 'test_backend_worker', 'test_snapshot',
           'test_compaction', 'test_interop', 'test_text_block',
           'test_cross_engine')


def _oracle_doc_rejected(self):
    """Overrides ``test_snapshot.py:157``, the one intended divergence:
    there ``am.init`` makes a host-oracle document, here it makes a
    device document by design, so the oracle document is built by name
    and ``save_snapshot`` must refuse it the same way."""
    doc = am.change(am.Frontend.init({'actorId': 'aa',
                                      'backend': am.Backend}),
                    lambda d: d.__setitem__('x', 1))
    with pytest.raises(TypeError, match='device-backed'):
        snapshot.save_snapshot(doc)


harness.recollect(globals(), MODULES, overrides={
    ('test_snapshot', 'TestDeviceSnapshot'): {
        'test_oracle_doc_rejected': _oracle_doc_rejected}})
