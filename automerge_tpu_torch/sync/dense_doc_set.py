"""DenseDocSet: a Connection-compatible DocSet over the dense HBM store.

The reference DocSet holds materialized JS documents and applies changes
one document at a time (src/doc_set.js:25-33). For fleets of flat map
documents this framework's fastest representation is the
:class:`~automerge_tpu_torch.device.dense_store.DenseMapStore` — the whole
DocSet resident in device memory, one scatter-max dispatch per change
batch. This module speaks the DocSet surface the sync layer needs
(``get_doc``/``set_doc``/``apply_changes``/``apply_changes_batch``/
handlers) on top of that store, so a :class:`~.connection.Connection`
(or :class:`~.connection.BatchingConnection`, which turns a whole
network tick into ONE device call) replicates against it unchanged —
same messages, same clocks, same protocol.

Documents hand out as lightweight :class:`DenseDocHandle` objects:
enough backend surface for the Connection protocol (``clock``,
``get_missing_changes``) with ``__getitem__``/``materialize`` pulling
the JSON view from the device planes on demand.

The PyTorch port's copy of ``automerge_tpu/sync/dense_doc_set.py``: the
store lives on ``device`` (the card unless ``'cpu'`` is asked for).
"""

from .. import frontend as Frontend
from ..device import blocks as _blocks
from ..device.dense_store import DenseMapStore


class _DenseBackendShim:
    """The backend-module surface Connection resolves via
    `doc._options['backend']` (connection.py _backend_of)."""

    @staticmethod
    def get_missing_changes(state, have_deps):
        return state.doc_set.store.host.get_missing_changes(
            state.index, have_deps)

    getMissingChanges = get_missing_changes


class _DenseState:
    """Backend-state stand-in for one dense-store document."""

    __slots__ = ('doc_set', 'index')

    def __init__(self, doc_set, index):
        self.doc_set = doc_set
        self.index = index

    @property
    def clock(self):
        return self.doc_set.store.host.clock_of(self.index)


class DenseDocHandle:
    """Lazy view of one document in a DenseDocSet."""

    def __init__(self, doc_set, doc_id, index):
        self._doc_set = doc_set
        self._doc_id = doc_id
        self._index = index
        self._state = {'backendState': _DenseState(doc_set, index)}
        self._options = {'backend': _DenseBackendShim}

    def materialize(self):
        return self._doc_set.materialize(self._doc_id)

    def __getitem__(self, key):
        return self.materialize()[key]

    def __contains__(self, key):
        return key in self.materialize()

    def items(self):
        return self.materialize().items()

    def keys(self):
        return self.materialize().keys()


class DenseDocSet:
    """A DocSet whose documents live in one dense device store.

    ``capacity`` documents at most (dense addressing); document ids map
    to store rows on first touch. Flat root-map documents only — the
    store's own scope; richer documents take
    :class:`~.device_doc_set.DeviceDocSet`. ``device`` — the store's
    device (None is the card, raising without one).
    """

    def __init__(self, capacity, key_capacity=64, actor_capacity=32,
                 options=None, mesh=None, device=None):
        self.capacity = capacity
        self.store = DenseMapStore(capacity, key_capacity=key_capacity,
                                   actor_capacity=actor_capacity,
                                   options=options, mesh=mesh,
                                   device=device)
        self.ids = []                  # row -> doc_id
        self.id_of = {}                # doc_id -> row
        self.handlers = []
        self._handles = {}

    # -- DocSet surface ------------------------------------------------------

    @property
    def doc_ids(self):
        return list(self.ids)

    docIds = doc_ids

    def _row(self, doc_id, create=False):
        row = self.id_of.get(doc_id)
        if row is None and create:
            if len(self.ids) >= self.capacity:
                raise ValueError(
                    f'{len(self.ids) + 1} documents exceed the dense '
                    f'capacity {self.capacity}')
            row = len(self.ids)
            self.id_of[doc_id] = row
            self.ids.append(doc_id)
        return row

    def get_doc(self, doc_id):
        row = self.id_of.get(doc_id)
        if row is None:
            return None
        handle = self._handles.get(doc_id)
        if handle is None:
            handle = self._handles[doc_id] = DenseDocHandle(
                self, doc_id, row)
        return handle

    getDoc = get_doc

    def set_doc(self, doc_id, doc):
        """Adopt a frontend document by replaying its change log into
        the dense store (flat map documents only)."""
        if isinstance(doc, DenseDocHandle):
            if doc._doc_set is self:
                return doc
            raise ValueError('handle belongs to a different DenseDocSet')
        from .. import backend as Backend
        state = Frontend.get_backend_state(doc)
        changes = Backend.get_missing_changes(state, {})
        return self.apply_changes(doc_id, changes)

    setDoc = set_doc

    def apply_changes(self, doc_id, changes):
        return self.apply_changes_batch({doc_id: changes})[doc_id]

    applyChanges = apply_changes

    def apply_changes_batch(self, changes_by_doc):
        """ONE device dispatch for the whole batch; handlers fire per
        changed document afterwards."""
        rows = {self._row(doc_id, create=True): changes
                for doc_id, changes in changes_by_doc.items()}
        # size to the touched prefix, not the store capacity — a sparse
        # tick must not pay O(capacity) host work
        per_doc = [[] for _ in range(max(rows, default=-1) + 1)]
        for row, changes in rows.items():
            per_doc[row] = list(changes)
        block = _blocks.ChangeBlock.from_changes(per_doc,
                                                 n_docs=self.capacity)
        self.store.apply_block(block)
        out = {}
        for doc_id in changes_by_doc:
            doc = self.get_doc(doc_id)
            out[doc_id] = doc
            for handler in list(self.handlers):
                handler(doc_id, doc)
        return out

    applyChangesBatch = apply_changes_batch

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers = self.handlers + [handler]

    registerHandler = register_handler

    def unregister_handler(self, handler):
        self.handlers = [h for h in self.handlers if h != handler]

    unregisterHandler = unregister_handler

    # -- materialization -----------------------------------------------------

    def materialize(self, doc_id):
        """{key: winner value} for one document, straight from the
        device planes."""
        row = self.id_of.get(doc_id)
        if row is None:
            raise KeyError(doc_id)
        import numpy as np
        K = self.store.key_capacity
        populated = np.zeros(self.store.n_fields, bool)
        populated[row * K:(row + 1) * K] = (
            self.store.eseq[row * K:(row + 1) * K] != 0).any(dim=1) \
            .cpu().numpy()
        patch = self.store._extract(populated)
        out = {}
        for diff in patch.diffs(row):
            if diff['action'] == 'set':
                out[diff['key']] = diff['value']
        return out
