"""WatchableDoc: observable wrapper for a single document.

Parity with the reference's ``src/watchable_doc.js``.

The PyTorch port's copy of ``automerge_tpu/sync/watchable_doc.py``.
"""

from .. import frontend as Frontend
from .. import backend as Backend
from ..backend import BackendState
from ..device import backend as DeviceBackend
from ..device.general_backend import GeneralBackendState


def backend_of_state(state):
    """The backend that owns ``state``: the host oracle for an oracle
    state, else the device backend bound to the device the state records
    (a bulk-routed state records its store's). Any other state raises."""
    if isinstance(state, BackendState):
        return Backend
    if isinstance(state, DeviceBackend.DeviceBackendState):
        return DeviceBackend.for_device(state.device)
    if isinstance(state, GeneralBackendState):
        return DeviceBackend.for_device(state.store.device)
    raise TypeError(f'no backend owns a {type(state).__name__} state')


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
        new_state, patch = backend_of_state(old_state).apply_changes(
            old_state, changes)
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
