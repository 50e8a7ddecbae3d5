"""Sharded batched DocSet engine: the multi-device applyChanges step.

One step resolves every document in a DocSet; the document axis is
partitioned across the mesh, each shard resolves its own documents with
the same resolve as the single-device path, and global statistics (ops
applied, conflicts detected — the observability counters of §5) reduce
with :func:`~.mesh.psum`.

The PyTorch port's copy of ``automerge_tpu/parallel/docset_engine.py``.
Each shard's rows go through :func:`~..device.engine.pick_resolve_kernel`
on that shard's device: on a CUDA shard the hand-written flat-map
kernel (``cuda_merge.dispatch_resolve``), on the CPU its plain version.
"""

import numpy as np
import torch

from ..device import packing
from .mesh import psum, shard_docs

_I32 = torch.int32


def _merge_step(seg_id, actor, seq, clock, is_del, valid, num_segments,
                resolve):
    """Per-shard body: resolve the shard's docs; returns its outputs and
    its three int32 stat partials."""
    out = resolve(seg_id, actor, seq, clock, is_del, valid,
                  num_segments=num_segments)
    d, n = seg_id.shape
    S = num_segments
    # per-doc surviving counts per segment; ids outside [0, S) land in a
    # sink slot, dropped as jax.ops.segment_sum drops them
    seg = seg_id.to(torch.int64)
    tgt = torch.where((seg >= 0) & (seg < S), seg, S)
    counts = torch.zeros((d, S + 1), dtype=_I32, device=seg.device)
    counts.scatter_add_(1, tgt, out['surviving'].to(_I32))
    counts = counts[:, :S]
    stats = (valid.sum(dtype=_I32), out['surviving'].sum(dtype=_I32),
             (counts > 1).sum(dtype=_I32))
    return out, stats


def sharded_merge_step(mesh, seg_id, actor, seq, clock, is_del, valid, *,
                       num_segments, kernel='auto'):
    """Run one batched merge step with the doc axis sharded over `mesh`.

    Each argument is a list of per-shard tensors (:func:`~.mesh.
    shard_docs`), shard ``s`` on mesh entry ``s``'s device. Returns
    (kernel outputs as per-shard lists, stats as int32 scalars — each
    the :func:`~.mesh.psum` of the shards' partials)."""
    from ..device.engine import pick_resolve_kernel
    resolve = pick_resolve_kernel(kernel)
    outs, partials = [], []
    for args in zip(seg_id, actor, seq, clock, is_del, valid):
        out, stats = _merge_step(*args, num_segments, resolve)
        outs.append(out)
        partials.append(stats)
    out = {k: [o[k] for o in outs]
           for k in ('surviving', 'winner', 'seg_max_actor')}
    names = ('ops_applied', 'ops_surviving', 'conflicts')
    stats = {name: psum([p[i] for p in partials])[0]
             for i, name in enumerate(names)}
    return out, stats


class ShardedDocSetEngine:
    """Batched merges for a whole DocSet across a device mesh.

    The device-count divisibility constraint is handled by padding the doc
    axis; padded docs carry valid=False ops and resolve to nothing.
    """

    def __init__(self, mesh=None, options=None, device=None):
        from ..device.engine import as_options
        self.options = as_options(options)
        if self.options.kernel == 'pallas':
            # the sharded body runs the shard's default resolve; failing
            # beats silently benchmarking the wrong kernel
            raise ValueError('ShardedDocSetEngine runs the XLA resolve '
                             'kernel; kernel="pallas" is single-chip only')
        if mesh is None:
            mesh = self.options.make_mesh(device=device)
        self.mesh = mesh

    def apply_changes_batch(self, docs_changes):
        """docs_changes: list (per doc) of change lists. Returns the same
        per-doc resolved field maps as
        :func:`automerge_tpu_torch.device.engine.batch_merge_docs`,
        computed with the doc axis sharded over this engine's mesh."""
        n_dev = self.mesh.devices.size
        packed = [packing.pack_assignments(c) for c in docs_changes]
        d_real = len(packed)
        d_pad = -(-d_real // n_dev) * n_dev
        arrays = packing.pad_and_stack(
            packed, n_ops=self.options.op_pad,
            n_actors=self.options.actor_pad,
            index_dtype=self.options.index_dtype,
            clock_dtype=self.options.clock_dtype)
        seg_id, actor, seq, clock, is_del, valid, n_pad = arrays
        if d_pad != d_real:
            def pad_docs(a):
                widths = [(0, d_pad - d_real)] + [(0, 0)] * (a.ndim - 1)
                return np.pad(a, widths)
            seg_id, actor, seq, clock, is_del, valid = map(
                pad_docs, (seg_id, actor, seq, clock, is_del, valid))

        arrays = shard_docs(self.mesh, seg_id, actor, seq, clock, is_del,
                            valid)
        n_segs = self.options.pad_segments(
            max((p.n_segments for p in packed), default=1))
        out, stats = sharded_merge_step(self.mesh, *arrays,
                                        num_segments=n_segs,
                                        kernel=self.options.kernel)
        surviving = np.concatenate([t.cpu().numpy()
                                    for t in out['surviving']])
        winner = np.concatenate([t.cpu().numpy() for t in out['winner']])

        from ..device.engine import unpack_resolved
        results = [unpack_resolved(p, surviving[i], winner[i])
                   for i, p in enumerate(packed)]
        return results, {k: int(v) for k, v in stats.items()}
