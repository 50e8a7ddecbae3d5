"""DeviceDocSet: a DocSet whose apply-changes path runs on the card.

The PyTorch port of ``automerge_tpu/sync/device_doc_set.py``. The
reference's DocSet applies changes one document at a time through the
host backend (`src/doc_set.js:25-33`). A :class:`DeviceDocSet` keeps the
same public surface (get_doc/set_doc/apply_changes/handlers) and adds
:meth:`apply_changes_batch`, which routes the wire changes of MANY
documents through the batched device backend
(:mod:`automerge_tpu_torch.device.backend`) in one device step: the
flat-map resolve kernel for map-only batches, or the fused resolve plus
the RGA kernel over every dirty list/text object of every document.

Device. ``DeviceDocSet(device=None)`` runs on CUDA and raises without a
card; ``device='cpu'`` runs the same path with the kernels' plain
versions. Its documents' frontends hold the backend bound to that device
(``DeviceBackend.for_device``).

Routing. Device-backed documents — any document first seen through this
DocSet — take the device path for all object types (maps, nested maps,
lists, text). A document added via ``set_doc`` with a host-oracle backend
state keeps its oracle backend: the change/patch protocol makes the two
backends interchangeable, so callers never see the difference.
"""

from .. import frontend as Frontend
from ..device import backend as DeviceBackend
from .doc_set import DocSet


class DeviceDocSet(DocSet):
    def __init__(self, kernel=None, options=None, device=None):
        super().__init__()
        from ..device.engine import as_options
        self.options = as_options(options, kernel)
        self.backend = DeviceBackend.for_device(device)
        self.device = self.backend.device
        self._oracle_docs = set()   # doc_ids pinned to the host backend

    # -- routing -----------------------------------------------------------

    def _device_state(self, doc_id):
        doc = self.docs.get(doc_id)
        if doc is None:
            return self.backend.init()
        return Frontend.get_backend_state(doc)

    # -- public surface ----------------------------------------------------

    def apply_changes(self, doc_id, changes):
        return self.apply_changes_batch({doc_id: changes})[doc_id]

    applyChanges = apply_changes

    def apply_changes_batch(self, changes_by_doc):
        """Apply `{doc_id: [change, ...]}` across documents; every
        device-routed document resolves in ONE batched device pass.
        Returns `{doc_id: new_doc}` and fires handlers per document."""
        from ..device import general_backend as _gb
        device_ids, device_states, device_changes = [], [], []
        general_ids = []
        oracle_ids = []
        for doc_id, changes in changes_by_doc.items():
            doc = self.docs.get(doc_id)
            state = Frontend.get_backend_state(doc) if doc is not None else None
            if isinstance(state, _gb.GeneralBackendState):
                # bulk-routed doc (a large ingest): its own fused apply
                general_ids.append(doc_id)
                continue
            on_device = state is None or isinstance(
                state, DeviceBackend.DeviceBackendState)
            if doc_id in self._oracle_docs or not on_device:
                # host-backed doc (e.g. added via set_doc) stays on the oracle
                self._oracle_docs.add(doc_id)
                oracle_ids.append(doc_id)
            else:
                device_ids.append(doc_id)
                device_states.append(self._device_state(doc_id))
                device_changes.append(changes)

        out = {}
        for doc_id in general_ids:
            state, patch = DeviceBackend.apply_changes(
                self._device_state(doc_id), changes_by_doc[doc_id],
                options=self.options)
            doc = self.docs[doc_id]
            patch['state'] = state
            doc = Frontend.apply_patch(doc, patch)
            self.set_doc(doc_id, doc)
            out[doc_id] = doc
        if device_ids:
            new_states, patches = DeviceBackend.apply_changes_batch(
                device_states, device_changes, options=self.options)
            for doc_id, state, patch in zip(device_ids, new_states, patches):
                doc = self.docs.get(doc_id)
                if doc is None:
                    doc = Frontend.init({'backend': self.backend})
                patch['state'] = state
                doc = Frontend.apply_patch(doc, patch)
                self.set_doc(doc_id, doc)
                out[doc_id] = doc

        for doc_id in oracle_ids:
            out[doc_id] = super().apply_changes(doc_id, changes_by_doc[doc_id])
        return out

    applyChangesBatch = apply_changes_batch

    def migrate_doc(self, doc_id):
        """Move an oracle-pinned document (e.g. added via ``set_doc``)
        onto the device backend by replaying its change log — the two
        backends speak the same wire protocol, so the rebuilt document
        is identical and all future changes take the batched device
        path. Requires the full log (raises after a truncated resume)."""
        from .. import backend as Backend
        doc = self.docs.get(doc_id)
        if doc is None:
            raise KeyError(doc_id)
        from ..device import general_backend as _gb
        state = Frontend.get_backend_state(doc)
        if isinstance(state, (DeviceBackend.DeviceBackendState,
                              _gb.GeneralBackendState)):
            self._oracle_docs.discard(doc_id)
            return doc
        changes = Backend.get_missing_changes(state, {})
        new_state, _ = DeviceBackend.apply_changes(
            self.backend.init(), changes)
        new_doc = Frontend.init({'backend': self.backend})
        patch = DeviceBackend.get_patch(new_state)
        patch['state'] = new_state
        new_doc = Frontend.apply_patch(new_doc, patch)
        self._oracle_docs.discard(doc_id)
        self.set_doc(doc_id, new_doc)
        return new_doc

    migrateDoc = migrate_doc
