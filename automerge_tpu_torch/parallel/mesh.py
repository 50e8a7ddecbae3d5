"""Mesh construction, doc-axis sharding helpers and the collectives.

The PyTorch port's copy of ``automerge_tpu/parallel/mesh.py``. The
reference is single-controller: one process drives every device of a
``jax.sharding.Mesh`` through ``shard_map``. The port keeps that shape
without ``torch.distributed``: a :class:`Mesh` is an ordered list of
``torch.device`` entries (an entry may repeat, the counterpart of the
forced host devices the JAX tests run on), a ``shard_map`` body becomes
a loop over the shards with each shard's tensors on its own entry's
device, and each collective (:func:`psum`, :func:`pmax`,
:func:`all_gather`, :func:`ppermute`) is one function over the list of
per-shard tensors that returns a list. Data moves by device-to-device
copies (``Tensor.to``), which cost nothing when both ends are the same
device.
"""

from dataclasses import dataclass
from functools import reduce

import numpy as np
import torch

from ..config import as_tensor, resolve_device

DOC_AXIS = 'docs'


class _DeviceList(tuple):
    """The mesh's devices in mesh order; ``size`` as on the reference's
    device array."""

    @property
    def size(self):
        return len(self)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (one ``torch.device`` per entry, in mesh
    order; repeats allowed) and the axis name."""

    devices: tuple
    axis_names: tuple = (DOC_AXIS,)

    def __post_init__(self):
        object.__setattr__(self, 'devices', _DeviceList(
            torch.device(d) for d in self.devices))


def _mesh_devices(n_devices, device):
    """The entries of a default mesh: the visible cards (the first
    ``n_devices`` of them), or ``n_devices`` logical CPU entries (one
    when not given) for ``device='cpu'``."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return [dev] * (1 if n_devices is None else n_devices)
    cards = [torch.device('cuda', i)
             for i in range(torch.cuda.device_count())]
    return cards if n_devices is None else cards[:n_devices]


def make_mesh(n_devices=None, axis=DOC_AXIS, devices=None, device=None):
    """A 1-D mesh over the visible cards (``device=None``: every card,
    raising without one), over ``n_devices`` logical CPU entries
    (``device='cpu'``), or over an explicit ``devices`` list, which may
    name one device several times.

    Documents are embarrassingly parallel (independent CRDT replicas), so a
    single mesh axis suffices for the doc dimension; collectives are only
    needed for global statistics and cross-doc rebalancing.
    """
    if devices is None:
        devices = _mesh_devices(n_devices, device)
    return Mesh(tuple(devices), (axis,))


def doc_sharding(mesh, n_rows):
    """The ONE place the doc-major placement is computed: ``[(lo, hi)]``
    row ranges, one per mesh entry, splitting a leading axis of
    ``n_rows`` into equal whole chunks (the dense store's planes,
    :func:`shard_docs` and the sharded engines all route through it, so
    doc-locality cannot drift between call sites). Raises when the
    rows do not divide over the mesh."""
    n_dev = mesh.devices.size
    if n_dev == 0 or n_rows % n_dev:
        raise ValueError(f'{n_rows} rows do not divide over {n_dev} '
                         f'devices')
    per = n_rows // n_dev
    return [(s * per, (s + 1) * per) for s in range(n_dev)]


class Shards(list):
    """Per-shard tensors in mesh order: entry ``s`` is shard ``s``'s
    local block, on mesh entry ``s``'s device. ``np.asarray`` reads it
    as the reference's sharded global array reads: the blocks
    concatenated along their leading axis, on the host."""

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([t.detach().cpu().numpy() for t in self])
        return out if dtype is None else out.astype(dtype)


def shard_docs(mesh, *arrays, axis=DOC_AXIS):
    """Split arrays (numpy or tensors) along their leading (document)
    axis over the mesh: for each array, the :class:`Shards` list of
    per-shard tensors, shard ``s`` on entry ``s``'s device."""
    placed = []
    for a in arrays:
        t = as_tensor(a)
        placed.append(Shards(
            t[lo:hi].to(dev) for (lo, hi), dev in
            zip(doc_sharding(mesh, t.shape[0]), mesh.devices)))
    return tuple(placed) if len(placed) != 1 else placed[0]


def shard_device(mesh, shard, n_shards=None):
    """The device owning logical shard ``shard`` of an ``n_shards``-way
    doc partition over ``mesh`` (round-robin when there are more shards
    than devices). Returns None for an empty mesh."""
    devices = mesh.devices
    if devices.size == 0:
        return None
    return devices[shard % devices.size]


# -- collectives over per-shard lists ----------------------------------------


def _replicate(value, like):
    """``value`` copied onto the device of every tensor in ``like``."""
    return [value.to(x.device) for x in like]


def psum(xs):
    """Elementwise sum over the shards, replicated on each (the dtype
    stays the shards' dtype: an int32 sum wraps as the reference's
    does)."""
    home = xs[0].device
    return _replicate(reduce(torch.add, (x.to(home) for x in xs)), xs)


def pmax(xs):
    """Elementwise maximum over the shards, replicated on each."""
    home = xs[0].device
    return _replicate(reduce(torch.maximum, (x.to(home) for x in xs)), xs)


def all_gather(xs, tiled=False):
    """Every shard's tensor on every shard: stacked along a new leading
    axis ([P, ...]), or concatenated along axis 0 when ``tiled``."""
    home = xs[0].device
    parts = [x.to(home) for x in xs]
    return _replicate(torch.cat(parts) if tiled else torch.stack(parts), xs)


def ppermute(xs, perm):
    """Send shard ``src``'s tensor to shard ``dst`` for each ``(src,
    dst)`` pair of ``perm``; a shard that receives nothing gets zeros,
    as ``lax.ppermute`` gives."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out
