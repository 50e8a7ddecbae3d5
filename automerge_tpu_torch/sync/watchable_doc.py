"""WatchableDoc: observable wrapper for a single document.

Parity with the reference's ``src/watchable_doc.js``.

The PyTorch port's copy of ``automerge_tpu/sync/watchable_doc.py``.
"""

from .. import frontend as Frontend
from .. import backend as Backend


class WatchableDoc:
    def __init__(self, doc):
        if doc is None:
            raise ValueError('doc argument is required')
        self.doc = doc
        self.handlers = []

    def get(self):
        return self.doc

    def set(self, doc):
        self.doc = doc
        for handler in list(self.handlers):
            handler(doc)

    def apply_changes(self, changes):
        old_state = Frontend.get_backend_state(self.doc)
        new_state, patch = Backend.apply_changes(old_state, changes)
        patch['state'] = new_state
        new_doc = Frontend.apply_patch(self.doc, patch)
        self.set(new_doc)
        return new_doc

    applyChanges = apply_changes

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers = self.handlers + [handler]

    registerHandler = register_handler

    def unregister_handler(self, handler):
        self.handlers = [h for h in self.handlers if h != handler]

    unregisterHandler = unregister_handler
