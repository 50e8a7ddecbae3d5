"""DocSet: a keyed collection of documents with change handlers.

Parity with the reference's ``src/doc_set.js`` (the PyTorch port's copy
of ``automerge_tpu/sync/doc_set.py``). Documents apply one at a time
through their own backend; :class:`~.device_doc_set.DeviceDocSet` adds
the batched device path.
"""

from .. import frontend as Frontend
from .. import backend as Backend


def backend_of(doc):
    """The backend module a document was initialized with (oracle or
    device — both expose the same change/patch protocol surface)."""
    return doc._options.get('backend') or Backend


class DocSet:
    def __init__(self):
        self.docs = {}
        self.handlers = []

    @property
    def doc_ids(self):
        return list(self.docs.keys())

    docIds = doc_ids

    def get_doc(self, doc_id):
        return self.docs.get(doc_id)

    getDoc = get_doc

    def set_doc(self, doc_id, doc):
        self.docs = dict(self.docs)
        self.docs[doc_id] = doc
        for handler in list(self.handlers):
            handler(doc_id, doc)

    setDoc = set_doc

    def apply_changes(self, doc_id, changes):
        doc = self.docs.get(doc_id)
        if doc is None:
            doc = Frontend.init({'backend': Backend})
        # dispatch on the document's own backend: a device-backed doc
        # (e.g. loaded from a packed snapshot) stays device-backed
        backend = backend_of(doc)
        old_state = Frontend.get_backend_state(doc)
        new_state, patch = backend.apply_changes(old_state, changes)
        patch['state'] = new_state
        doc = Frontend.apply_patch(doc, patch)
        self.set_doc(doc_id, doc)
        return doc

    applyChanges = apply_changes

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers = self.handlers + [handler]

    registerHandler = register_handler

    def unregister_handler(self, handler):
        self.handlers = [h for h in self.handlers if h != handler]

    unregisterHandler = unregister_handler
