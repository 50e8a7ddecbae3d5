"""The system ``general_wire``: ``automerge_tpu_torch``'s ``GeneralDocSet``
as a collab hub runs it. Each tick's changes reach it as one columnar v3
(``AMW3``) wire container; it applies them with ``apply_wire`` and the
hub reads the patch of every document the tick touched.

A system module under ``benchmark/systems/`` exposes ``make(cell,
device)``, which returns an object with these calls: ``prepare(tick,
gen)`` (the clients' side, in set-up: encode the changes), ``apply(tick)``
and ``read(tick, docs=None)`` (the timed tick), ``sync()``, then, once
the window has closed, ``clock(d)`` and ``view(d)`` for the comparison,
and ``close()``. A configuration names its system by the module's name.
"""


def make(cell, device='cuda'):
    return System(cell.n_docs, cell.config['document']['object'],
                  device=device)


class System:
    def __init__(self, n_docs, kind, device='cuda'):
        import torch
        from automerge_tpu_torch.device import general
        from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet
        self._torch = torch
        self.device = device
        self.ds = GeneralDocSet(n_docs, device=device)
        # the clients' encoder: the program's own change encoder and
        # wire codec on an empty host store; the sequence objects made
        # at load time are named to it, as a client's replica knows them
        self._encoder = general.init_store(n_docs, device='cpu')
        self._obj_type = general._MAKE_TYPE[
            general._GEN_ACTION_NAMES['make' + kind.capitalize()]]
        self.ids = [f'doc-{d}' for d in range(n_docs)]

    def prepare(self, tick, gen):
        from automerge_tpu_torch import wire
        extra = None
        if tick.index >= 0:
            # (map objects need no entry: their keys are strings)
            extra = {(i, gen.docs[d].obj): self._obj_type
                     for i, d in enumerate(tick.docs)}
        block = self._encoder.encode_changes(tick.changes,
                                             extra_types=extra)
        rows = list(range(block.n_changes))
        spans, tab = wire.assemble_columnar_spans(
            wire.encode_change_rows_columnar_v3(block, rows))
        per_doc = [[] for _ in range(block.n_docs)]
        for c, span in zip(block.doc.tolist(), spans):
            per_doc[c].append((0, span))
        tick.data = wire.build_columnar_container([tab], per_doc, version=3)
        tick.changes = None

    def apply(self, tick):
        self.ds.apply_wire(tick.data, doc_ids=[self.ids[d]
                                               for d in tick.docs])

    def read(self, tick, docs=None):
        """The diffs of every document of the tick (or of ``docs``)."""
        patch = self.ds.last_patch
        id_of = self.ds.id_of
        return [patch.diffs(id_of[self.ids[d]])
                for d in (tick.docs if docs is None else docs)]

    def sync(self):
        if self.device != 'cpu':
            self._torch.cuda.synchronize()

    def clock(self, d):
        return self.ds.clock_of_id(self.ids[d])

    def view(self, d):
        return self.ds.materialize(self.ids[d])

    def close(self):
        self.ds = None
        self._encoder = None
        if self.device != 'cpu':
            self._torch.cuda.synchronize()
            self._torch.cuda.empty_cache()
