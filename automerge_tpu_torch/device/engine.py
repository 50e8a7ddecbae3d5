"""Batched document-store engine: many documents, one device program.

`applyChanges` batched across every document in a DocSet (the PyTorch
port of ``automerge_tpu/device/engine.py``). The host packs change
batches into dense arrays (:mod:`.packing`), one device pass resolves
every field of every document (:mod:`.merge`, a leading document axis
written out), and the winners map back to JSON values.

For workloads the oracle backend walks op-by-op (O(total ops) of Python/JS
dict churn), this path does two segment reductions and a couple of gathers
over the whole batch — the per-op cost is a few HBM-bandwidth-bound array
lanes, which is what makes million-op merges per chip feasible.
"""

import numpy as np
import torch

from ..config import DEFAULT as DEFAULT_OPTIONS, resolve_device
from ..utils.metrics import metrics
from . import cuda_merge
from . import merge as merge_kernel
from . import packing


def as_options(options=None, kernel=None):
    """Normalize (options, legacy kernel kwarg) into one Options."""
    if options is None:
        options = DEFAULT_OPTIONS
    if kernel is not None and kernel != options.kernel:
        options = options.with_(kernel=kernel)
    return options


def pick_resolve_kernel(kernel='auto'):
    """Select the field-resolution kernel implementation. The choice
    is made per call, on the device of the tensors it is given:

    'auto' / 'pallas' — on CUDA tensors, the hand-written flat-map
                        kernel (``cuda_merge.resolve_cuda``,
                        ``csrc/flatmap_resolve.cu``; a build or launch
                        failure raises). On CPU tensors, its plain
                        version, which is the PyTorch segment resolve
                        below.
    'xla'             — the PyTorch segment-reduction resolve
                        (merge.py) on every device: the explicit choice
                        of the plain tensor program, as in the JAX
                        package.

    The JAX package's shape thresholds for 'auto' (``_pallas_wins``)
    were measured on a TPU and are not carried over: on the card 'auto'
    always takes the kernel.
    """
    if kernel in ('auto', 'pallas'):
        return cuda_merge.dispatch_resolve
    return merge_kernel.resolve_assignments_batch


class DocStore:
    """A batch of documents resolved on device.

    Round-1 scope: flat map documents (the DocSet batch-merge workload,
    BASELINE config 5). Nested object graphs and sequences run through the
    oracle backend or the sequence kernel respectively.
    """

    def __init__(self):
        self.resolved = []    # per doc: {(obj, key): {'value','action','conflicts'}}

    @classmethod
    def from_changes(cls, docs_changes):
        store = cls()
        store.resolved = batch_merge_docs(docs_changes)
        return store

    def materialize(self, doc_index, obj_id):
        """Plain {key: value} for one (flat) object of one document."""
        return {key: field['value']
                for (obj, key), field in self.resolved[doc_index].items()
                if obj == obj_id and field['action'] == 'set'}


def unpack_resolved(packed, surviving_row, winner_row):
    """Turn one document's kernel outputs back into JSON field state.

    Shared by the single-chip and sharded engines so the two can never
    diverge. O(N + S) per document: survivors are grouped by segment in one
    pass instead of rescanning the op array per field.
    """
    n_real = len(packed.op_meta)
    by_seg = {}
    for j in np.flatnonzero(surviving_row[:n_real]):
        by_seg.setdefault(int(packed.seg_id[j]), []).append(j)

    doc_fields = {}
    for s, field in enumerate(packed.segments):
        w = winner_row[s]
        if w < 0 or not surviving_row[w]:
            doc_fields[field] = {'action': 'remove', 'value': None,
                                 'conflicts': None}
            continue
        action, value = packed.op_meta[w]
        conflicts = None
        survivors = by_seg.get(s, [])
        if len(survivors) > 1:
            losers = sorted((j for j in survivors if j != w),
                            key=lambda j: packed.actor_names[packed.actor[j]],
                            reverse=True)
            conflicts = {packed.actor_names[packed.actor[j]]: packed.op_meta[j][1]
                         for j in losers}
        doc_fields[field] = {'action': 'set', 'value': value,
                             'conflicts': conflicts, 'link': action == 'link'}
    return doc_fields


def batch_merge_docs(docs_changes, return_timing=False, kernel=None,
                     options=None, device=None):
    """Merge a batch of change lists, one per document, on device.

    Args:
      docs_changes: list over documents; each entry is a list of changes
        (causally self-contained per document).
      return_timing: also return a dict of phase timings.
      options: :class:`~automerge_tpu_torch.config.Options` (kernel
        choice and padding policy); `kernel` remains as a shorthand
        override.
      device: where the resolve runs (None: CUDA; raises without a
        card unless ``'cpu'`` is asked for).

    Returns:
      per-doc dict {(obj, key): {'action': 'set'|'remove', 'value', 'conflicts'}}
      matching exactly what the oracle's field state would be.
    """
    import time
    opts = as_options(options, kernel)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    packed = [packing.pack_assignments(changes) for changes in docs_changes]
    seg_id, actor, seq, clock, is_del, valid, n_pad = packing.pad_and_stack(
        packed, n_ops=opts.op_pad, n_actors=opts.actor_pad,
        index_dtype=opts.index_dtype, clock_dtype=opts.clock_dtype)
    n_segs = opts.pad_segments(max((p.n_segments for p in packed), default=1))
    t1 = time.perf_counter()

    resolve = pick_resolve_kernel(opts.kernel)
    from . import profiler as _profiler
    _profiler.note_dispatch(
        'engine.resolve',
        (getattr(resolve, '__name__', 'resolve'), seg_id.shape,
         clock.shape, str(seg_id.dtype), str(clock.dtype), n_segs),
        rows=seg_id.shape[0])
    out = resolve(*(torch.as_tensor(a).to(dev)
                    for a in (seg_id, actor, seq, clock, is_del, valid)),
                  num_segments=n_segs)
    surviving = out['surviving'].cpu().numpy()
    winner = out['winner'].cpu().numpy()
    t2 = time.perf_counter()

    results = [unpack_resolved(p, surviving[i], winner[i])
               for i, p in enumerate(packed)]
    t3 = time.perf_counter()

    real_ops = int(valid.sum())
    metrics.bump('device_batches')
    metrics.bump('device_ops', real_ops)
    metrics.set_gauge('device_batch_occupancy',
                      real_ops / max(valid.size, 1))
    if metrics.active:
        metrics.emit('device_batch', docs=len(packed), ops=real_ops,
                     padded_ops=int(valid.size), pack_s=t1 - t0,
                     device_s=t2 - t1, unpack_s=t3 - t2)

    if return_timing:
        return results, {'pack': t1 - t0, 'device': t2 - t1, 'unpack': t3 - t2}
    return results
