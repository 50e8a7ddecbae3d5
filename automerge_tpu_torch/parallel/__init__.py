"""Distributed layer: document sharding over a device mesh.

The reference scales by replicating documents over a network of peers
(`src/connection.js`); within one host this framework instead shards the
*document axis* of a DocSet over a mesh of devices:

* **dp (documents)** — independent docs partitioned across the mesh;
  each entry resolves its shard with the same step, global statistics
  via :func:`~.mesh.psum`.
* **peer sync on the mesh** — mesh replicas of one document converge by
  collective (`ici_sync`): clock advertisement = ``pmax``, change
  shipping = ``all_gather`` (or ``ppermute`` ring gossip), convergent
  apply = the merge kernel on the union.
* **between hosts** the Connection wire protocol is unchanged:
  vector-clock advertisement + change shipping, with the host feeding
  device batches.

The PyTorch port's copy of ``automerge_tpu/parallel``. It stays
single-controller, as the reference is: a mesh is an ordered list of
``torch.device`` entries driven by one process (no
``torch.distributed``), each collective one function over the list of
per-shard tensors (:mod:`.mesh`).
"""

from .mesh import make_mesh, shard_docs
from .docset_engine import sharded_merge_step, ShardedDocSetEngine
from .ici_sync import (make_peer_mesh, shard_peers, sync_step,
                       ring_sync_step)

__all__ = ['make_mesh', 'shard_docs', 'sharded_merge_step',
           'ShardedDocSetEngine', 'make_peer_mesh', 'shard_peers',
           'sync_step', 'ring_sync_step']
