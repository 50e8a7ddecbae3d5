"""The JAX package's sync and transport suites on the PyTorch port: the
general engine behind ``Connection``/``BatchingConnection``, batched and
device doc sets, the wire v3 session codec, the socket transport and
its membership, and the chaos fleets (loopback sockets only),
re-collected against ``automerge_tpu_torch`` by
``test_torch_conformance_harness.recollect`` in a ``cpu`` and a
``cuda`` lane.

Three cases build their documents with ``am.init``/``am.load`` and hand
their states to the host oracle (``Backend.get_missing_changes``), or
expect ``DeviceDocSet.set_doc`` to receive an oracle document: in the
JAX package those make host-oracle documents, in the port device
documents by design. Each runs unchanged with the facade's constructors
building oracle documents by name
(``test_torch_conformance_harness.oracle_documents``).
"""

import torch

import test_torch_conformance_harness as harness

torch.set_num_threads(1)

MODULES = ('test_general_sync', 'test_batched_sync', 'test_wire_v3',
           'test_transport', 'test_chaos', 'test_socket_chaos')


def _on_oracle_documents(module, cls, name, doc):
    return harness.patched_case(module, cls, name,
                                harness.oracle_documents, doc)


harness.recollect(globals(), MODULES, overrides={
    ('test_general_sync', 'TestGeneralDocSetSync'): {
        'test_bidirectional_divergent_copies_merge': _on_oracle_documents(
            'test_general_sync', 'TestGeneralDocSetSync',
            'test_bidirectional_divergent_copies_merge',
            """Overrides ``test_general_sync.py:174``: the case hands the
            states of ``am.init`` documents to the oracle's
            ``Backend.get_missing_changes`` (``:185``, ``:193``); the
            port's ``init`` makes device documents, so the facade builds
            oracle documents by name here."""),
        'test_causally_unready_changes_buffer_across_ticks':
            _on_oracle_documents(
                'test_general_sync', 'TestGeneralDocSetSync',
                'test_causally_unready_changes_buffer_across_ticks',
                """Overrides ``test_general_sync.py:206``: the same
                divergence, the oracle's ``get_missing_changes`` on an
                ``am.init`` document's state (``:212``)."""),
    },
    ('test_batched_sync', 'TestMigrateDoc'): {
        'test_migrate_oracle_doc_to_device': _on_oracle_documents(
            'test_batched_sync', 'TestMigrateDoc',
            'test_migrate_oracle_doc_to_device',
            """Overrides ``test_batched_sync.py:120``: the case migrates
            an oracle document, which it builds with ``am.init``
            (``:122``), and edits a document from ``am.load`` through
            the oracle (``:133-135``); the port's constructors make
            device documents, so the facade builds oracle documents by
            name here."""),
    }})
