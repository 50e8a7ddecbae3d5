"""The JAX package's metrics suite on the PyTorch port: the registry,
histograms, spans and the event bus, the profiler bridge, and the
counters the backends, connections and doc sets bump, re-collected
against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect``.

A case of ``tests/test_metrics.py`` (its profiler bridge) imports and
runs ``jax``, so this file runs where JAX is installed, in the ``cpu``
lane only. Two cases
build their documents with ``A.init`` and read what the host oracle
reports (``conflicts_detected``, the ``apply`` event): in the JAX
package ``init`` makes host-oracle documents, in the port device
documents by design. Each runs unchanged with the facade's
constructors building oracle documents by name
(``test_torch_conformance_harness.oracle_documents``).
"""

import pytest
import torch

import test_torch_conformance_harness as harness

pytest.importorskip('jax', reason='test_metrics runs jax')

torch.set_num_threads(1)

MODULES = ('test_metrics',)


def _on_oracle_documents(name, doc):
    return harness.patched_case('test_metrics', 'TestBackendIntegration',
                                name, harness.oracle_documents, doc)


harness.recollect(globals(), MODULES, overrides={
    ('test_metrics', 'TestBackendIntegration'): {
        'test_conflict_counter': _on_oracle_documents(
            'test_conflict_counter',
            """Overrides ``test_metrics.py:449``: ``conflicts_detected``
            is the host oracle's counter, and the case builds its
            documents with ``A.init`` (``:450-451``), which in the port
            makes device documents by design; the facade builds oracle
            documents by name here."""),
        'test_apply_event_stream': _on_oracle_documents(
            'test_apply_event_stream',
            """Overrides ``test_metrics.py:456``: the ``apply`` event is
            the host oracle's, on an ``A.init`` document (``:459``); the
            same divergence, the same remedy.""")}}, lanes=('cpu',))
