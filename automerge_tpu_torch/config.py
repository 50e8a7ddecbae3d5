"""Framework configuration: one small Options dataclass.

The reference keeps configuration minimal — `init(options)` takes
`actorId`/`deferActorId`/`backend` (frontend/index.js:197-221) and that is
the whole flag surface. This framework mirrors that restraint: everything
device-related (mesh shape, batch padding, dtype widths, actor-table
capacity, kernel choice) lives in ONE dataclass threaded through the
engines, instead of scattered kwargs.

Padding fields bucket every device axis: a fixed `op_pad` / `actor_pad`
pins one shape across batches; `None` means "next bucket of what the
batch needs" (the JAX package buckets to share its jit cache; the port
keeps the same buckets so both packages stage byte-identical planes).

:func:`resolve_device` is the one place an entry point turns its
``device`` argument into a ``torch.device``: ``None`` means CUDA, and a
CUDA request without a visible card raises instead of carrying on on the
CPU. :func:`as_tensor` is the one place a device function turns an array
argument into a tensor.
"""

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device`` argument:
    ``None`` means ``'cuda'``. Raises when CUDA is asked for (or
    defaulted to) and no card is available — the port never falls back
    to the CPU unless the caller passes ``device='cpu'``."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'automerge_tpu_torch: CUDA is not available; pass '
            "device='cpu' to run on the host")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev


def as_tensor(a):
    """``a`` as a tensor: a tensor as it is (on its own device), any
    other array (numpy, or anything with ``__array__``) on the host, as
    the reference's device functions take any array. A read-only or
    reversed array is copied: a tensor may be written, and has no
    negative strides."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable or min(a.strides, default=0) < 0:
        a = a.copy()
    return torch.from_numpy(a)


@dataclass(frozen=True)
class Options:
    """Device/engine configuration.

    Attributes:
      kernel: flat-map field-resolution kernel. On a CUDA device 'auto'
        and 'pallas' launch the hand-written flat-map kernel
        (device/cuda_merge.py, csrc/flatmap_resolve.cu) and 'xla' runs
        the PyTorch segment resolve (device/merge.py); on the CPU all
        three run that PyTorch resolve, which is the kernel's plain
        version.
      n_devices: mesh size for sharded engines (None = every device).
      op_pad: fixed op-axis padding per document batch (None = next pow2).
      seg_pad: fixed segment (field) capacity (None = next pow2).
      node_pad: fixed sequence-tree node capacity for the RGA ordering
        pass (None = next pow2 of the largest dirty tree).
      actor_pad: actor-table capacity — clocks are dense [actor_pad]
        vectors on device (None = next pow2 of the batch's actor count).
      clock_dtype / index_dtype: device array widths for clocks/seq
        counters and segment/actor/node indexes. int32 everywhere by
        default: TPU VPU lanes are 32-bit and none of the CRDT counters
        (seq numbers, list indexes) approach 2^31.
    """

    kernel: str = 'auto'
    # bulk-ingestion routing: DeviceBackend.apply_changes on a FRESH
    # document routes batches of at least this many ops through the
    # general bulk engine (one fused block apply) instead of the
    # per-change staging loop. Threshold from the measured crossover on
    # the config-2 interactive benchmark (~20k-op merges: per-doc
    # ~0.29s, bulk ~0.15s; sub-1k batches favor per-doc staging).
    # None disables routing.
    bulk_route_min_ops: Optional[int] = 3000
    n_devices: Optional[int] = None
    op_pad: Optional[int] = None
    seg_pad: Optional[int] = None
    actor_pad: Optional[int] = None
    node_pad: Optional[int] = None
    clock_dtype: np.dtype = np.dtype(np.int32)
    index_dtype: np.dtype = np.dtype(np.int32)

    def __post_init__(self):
        if self.kernel not in ('auto', 'xla', 'pallas'):
            raise ValueError(f'unknown kernel {self.kernel!r}')
        for name in ('n_devices', 'op_pad', 'seg_pad', 'actor_pad',
                     'node_pad'):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f'{name} must be >= 1, got {v}')
        # bit-packed flag planes split at n >> 3 bytes and reshape(-1, 8):
        # a pad that is not a multiple of 8 would fail opaquely inside the
        # jitted program, so reject it at construction
        for name in ('op_pad', 'node_pad'):
            v = getattr(self, name)
            if v is not None and v % 8:
                raise ValueError(
                    f'{name} must be a multiple of 8 (bit-packed flag '
                    f'planes), got {v}')

    def pad_ops(self, n):
        """Op-axis size for a batch needing `n` rows."""
        return self._pad(self.op_pad, n, 'op_pad')

    def pad_segments(self, n):
        return self._pad(self.seg_pad, n, 'seg_pad')

    def pad_actors(self, n):
        return self._pad(self.actor_pad, n, 'actor_pad')

    def pad_nodes(self, n):
        return self._pad(self.node_pad, n, 'node_pad')

    @staticmethod
    def _pad(fixed, n, name):
        """Bucket `n` up to the next {2^k, 3*2^(k-1)} size (half-step
        buckets: at most 2 compiled shapes per octave, and never more
        than 33% padding waste — a plain pow2 wastes up to 100%, which
        is real wire bytes on a slow host<->device link)."""
        if fixed is not None:
            if n > fixed:
                raise ValueError(
                    f'batch needs {n} but {name} is fixed at {fixed}')
            return fixed
        n = max(n, 1)
        p = 1
        while p < n:
            p <<= 1
        half = (p >> 1) + (p >> 2)       # 3 * 2^(k-2), multiple of 8 for p>=32
        if n <= half and half % 8 == 0:
            return half
        return p

    def make_mesh(self, device=None):
        """Document-axis mesh of `n_devices` (parallel.mesh.make_mesh)
        over the visible cards, or logical CPU entries for
        ``device='cpu'``."""
        from .parallel.mesh import make_mesh
        return make_mesh(n_devices=self.n_devices, device=device)

    def make_peer_mesh(self, device=None):
        """Peer-axis mesh for replica sync (parallel.ici_sync)."""
        from .parallel.ici_sync import make_peer_mesh
        return make_peer_mesh(n_peers=self.n_devices, device=device)

    def with_(self, **kw):
        """Functional update (the dataclass is frozen)."""
        return replace(self, **kw)


DEFAULT = Options()
