"""Dense vector-clock functions.

Host clocks are ``dict[actor, seq]``; on device a clock is a dense
``int32[n_actors]`` tensor (index = interned actor rank). These are the
batched equivalents of `src/common.js:14-18` (lessOrEqual),
`op_set.js:20-27` (causallyReady) and `src/connection.js:9-12`
(clockUnion), vectorized over documents/changes. The PyTorch port's copy
of ``automerge_tpu/device/clock.py``: plain tensor ops on whatever device
the inputs live on (no kernel). Like the reference's, each takes any
array: numpy arrays and other non-tensors run on the host
(:func:`~automerge_tpu_torch.config.as_tensor`).
"""

import torch

from ..config import as_tensor


def less_or_equal(clock1, clock2):
    """Elementwise vector-clock partial order; broadcasts over leading axes."""
    clock1, clock2 = as_tensor(clock1), as_tensor(clock2)
    return torch.all(clock1 <= clock2, dim=-1)


def union(clock1, clock2):
    """Pointwise max (clock merge)."""
    clock1, clock2 = as_tensor(clock1), as_tensor(clock2)
    return torch.maximum(clock1, clock2)


def causally_ready(doc_clock, change_deps, change_actor, change_seq):
    """Readiness of a batch of changes against a document clock.

    doc_clock:    int32[A]         current applied clock
    change_deps:  int32[C, A]      each change's declared deps (dense)
    change_actor: int32[C]         originating actor rank
    change_seq:   int32[C]

    A change is ready when every dep is satisfied and its own predecessor
    (seq-1 from the same actor) has been applied (op_set.js:20-27).
    """
    doc_clock, change_deps, change_actor, change_seq = map(
        as_tensor, (doc_clock, change_deps, change_actor, change_seq))
    deps_ok = torch.all(change_deps <= doc_clock[None, :], dim=-1)
    own_ok = doc_clock[change_actor.long()] >= change_seq - 1
    return deps_ok & own_ok


def advance(doc_clock, change_actor, change_seq, ready):
    """New document clock after applying the ready subset of changes
    (actor ranks outside ``[0, A)`` are dropped, as a segment max
    drops them)."""
    doc_clock, change_actor, change_seq, ready = map(
        as_tensor, (doc_clock, change_actor, change_seq, ready))
    seqs = torch.where(ready, change_seq, torch.zeros_like(change_seq))
    actor = change_actor.long()
    keep = (actor >= 0) & (actor < doc_clock.shape[0])
    return doc_clock.scatter_reduce(0, actor[keep],
                                    seqs[keep].to(doc_clock.dtype),
                                    reduce='amax', include_self=True)
