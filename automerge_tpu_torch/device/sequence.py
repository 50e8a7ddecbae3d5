"""RGA sequence ordering: sort + pointer doubling (PyTorch).

The port of ``automerge_tpu/device/sequence.py``. The document order of
list/text elements is the depth-first traversal of the insertion tree
where each node's children sort Lamport-descending by (elem, actor)
(op_set.js:371-390). All n positions come out of O(log n) parallel
rounds:

1. **Sort** nodes by (parent, elem desc, actor desc) — a stable sort per
   key, last key first (``jnp.lexsort`` is stable; so is this).
2. **Thread the tree**: first-child and next-sibling links fall out of
   the sorted order; the DFS successor is ``first_child`` if present,
   else the next sibling of the nearest ancestor that has one, found by
   pointer doubling over parent links.
3. **List-rank** the successor chain with pointer doubling.
4. **Visibility scan**: a prefix sum over tombstone flags maps tree
   positions to user-visible list indexes.

On CPU tensors :func:`_rga_order_batched` runs the plain version
:func:`_rga_order_plain`: a PyTorch stable sort per key
(:func:`_child_sort`), then :func:`_order_from_sorted_plain` — direct
batched ``torch.gather`` pointer doubling, integer-exact and the same
values as every JAX variant (the JAX package routes small trees
through one-hot MXU matmuls because the TPU has no fast gather).
Scatters the reference drops land in a sink column that is sliced off,
and every output is int32. On CUDA tensors it launches a hand-written
RGA kernel (:mod:`.cuda_sequence`, ``csrc/rga_order.cu``, the port of
``pallas_sequence.py``): rows up to ``cuda_sequence.M_NARROW`` nodes
take the narrow kernel, which does all four steps, the sort included,
from the raw planes; wider rows the wide kernel, one block per row, the
sort included too (a radix sort in shared memory) — but a few long rows
(``cuda_sequence.variant``'s ``'wide-grid'``), which take the PyTorch
sort and then the grid kernel for steps 2-4 over every SM.

Node 0 is the virtual ``'_head'`` element; padding slots carry
``valid=False`` and sort to the end.

The delta orderer behind the incremental index update
(:func:`_rga_delta_order_batched`) orders one tick's new nodes among
themselves: the same steps 1-3 with the anchor (the old tree position of
a delta root's real parent) as one more sort key. Its plain version is
:func:`_rga_delta_order_plain`; on CUDA tensors it launches the RGA
kernel's delta mode: narrow or subwarp planes up to
``cuda_sequence.M_NARROW`` nodes, the wide kernel past it (or, for a few
long rows, the PyTorch sort and the grid kernel).
"""

import torch

from . import cuda_sequence
from ..config import as_tensor

_I32 = torch.int32


def _ceil_log2(n):
    bits = 0
    while (1 << bits) < n:
        bits += 1
    return max(bits, 1)


def _stable_lexsort(keys):
    """Row-wise ``jnp.lexsort(keys)`` over [K, n] planes: the LAST key
    is primary; ties keep their index order. One stable sort per key,
    applied from the first (least significant) key to the last."""
    order = None
    for k in keys:
        k_cur = k if order is None else torch.gather(k, 1, order)
        _, o = torch.sort(k_cur, dim=1, stable=True)
        order = o if order is None else torch.gather(order, 1, o)
    return order


def _thread_and_rank(parent, parent_adj, order, valid):
    """Tree threading + list ranking over [K, n] planes (steps 2-3 of
    `_rga_order`): from a child-sorted ``order``, derive first-child /
    next-sibling links, resolve each node's DFS successor by
    pointer-doubling the ancestor climb, then list-rank the successor
    chain. Returns int32[K, n] ``tree_pos`` (head = 0, then
    1..chain_len; padding carries garbage)."""
    K, n = parent.shape
    dev = parent.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :] \
        .expand(K, n)
    rounds = _ceil_log2(n) + 1
    p_sorted = torch.gather(parent_adj, 1, order)

    # --- thread the tree ----------------------------------------------------
    is_seg_start = torch.ones((K, n), dtype=torch.bool, device=dev)
    is_seg_start[:, 1:] = p_sorted[:, 1:] != p_sorted[:, :-1]
    # first_child[p] = first sorted node whose parent is p (-1 if none);
    # column n is the sink the reference's mode='drop' slot maps to
    first_child = torch.full((K, n + 1), -1, dtype=torch.int64, device=dev)
    first_child.scatter_(
        1, torch.where(is_seg_start, p_sorted, torch.full_like(p_sorted, n)),
        torch.where(is_seg_start, order, torch.full_like(order, -1)))
    first_child = first_child[:, :n]
    # next_sibling[node] = next sorted node under the same parent
    same_parent_next = torch.zeros((K, n), dtype=torch.bool, device=dev)
    same_parent_next[:, :-1] = p_sorted[:, 1:] == p_sorted[:, :-1]
    nxt_in_sort = torch.full((K, n), -1, dtype=torch.int64, device=dev)
    nxt_in_sort[:, :-1] = order[:, 1:]
    next_sibling = torch.full((K, n), -1, dtype=torch.int64, device=dev)
    next_sibling.scatter_(1, order, torch.where(
        same_parent_next, nxt_in_sort, torch.full_like(nxt_in_sort, -1)))
    # head and padding share a sort bucket: sever any accidental link so
    # the last list element's chain terminates instead of entering padding
    next_sibling[:, 0] = -1

    # nearest ancestor-or-self with a next sibling (head ends the climb);
    # parents index the plane, clamped as the reference's gather clamps
    has_sib = next_sibling >= 0
    is_head = idx == 0
    climb = torch.where(has_sib | is_head, idx,
                        parent.to(torch.int64).clamp(0, n - 1))
    for _ in range(rounds):
        climb = torch.gather(climb, 1, climb)
    up = torch.where(torch.gather(has_sib, 1, climb),
                     torch.gather(next_sibling, 1, climb),
                     torch.full_like(climb, -1))

    succ = torch.where(first_child >= 0, first_child, up)
    succ = torch.where(valid, succ, torch.full_like(succ, -1))

    # --- list-rank the successor chain (pointer doubling) -------------------
    # (n+1)-slot space where slot n is the chain terminator
    nxt = torch.full((K, n + 1), n, dtype=torch.int64, device=dev)
    nxt[:, :n] = torch.where(succ >= 0, succ, torch.full_like(succ, n))
    dist = torch.ones((K, n + 1), dtype=torch.int64, device=dev)
    dist[:, n] = 0
    for _ in range(rounds):
        dist = dist + torch.gather(dist, 1, nxt)
        nxt = torch.gather(nxt, 1, nxt)
    dist = dist[:, :n]                 # steps from node to end of chain
    return (dist[:, :1] - dist).to(_I32)


def _order_from_sorted_plain(order, parent_adj, parent, visible, valid):
    """Steps 2-4 of the RGA order over [K, n] planes, from the stable
    child sort ``order`` and the sort key ``parent_adj`` (head and
    padding bucketed at n): thread + list-rank (`_thread_and_rank`),
    then the visibility scan. The plain version of the wide CUDA kernel.
    Returns the dict of `_rga_order_batched`."""
    K, n = parent.shape
    dev = parent.device
    visible = visible.to(torch.bool)
    valid = valid.to(torch.bool)
    idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :] \
        .expand(K, n)
    tree_pos = _thread_and_rank(parent.to(torch.int64),
                                parent_adj.to(torch.int64),
                                order.to(torch.int64), valid)

    # --- 4. visibility scan -------------------------------------------------
    tp = tree_pos.to(torch.int64)
    on_chain = valid & (tp > 0)        # head and padding excluded
    # chain positions are unique; off-chain rows write 0 at position 0
    # in the reference — route them to the sink and set that cell last
    node_at_pos = torch.full((K, n + 1), n - 1, dtype=torch.int64,
                             device=dev)
    node_at_pos.scatter_(1, torch.where(on_chain, tp,
                                        torch.full_like(tp, n)), idx)
    node_at_pos = node_at_pos[:, :n]
    node_at_pos[:, 0] = torch.where((~on_chain).any(dim=1),
                                    torch.zeros_like(node_at_pos[:, 0]),
                                    node_at_pos[:, 0])
    vis_ordered = torch.gather(on_chain, 1, node_at_pos) & \
        torch.gather(visible, 1, node_at_pos)
    vo = vis_ordered.to(_I32)
    vis_rank_ordered = torch.cumsum(vo, dim=1, dtype=_I32) - vo
    vis_index = torch.gather(vis_rank_ordered, 1, tp.clamp(0, n - 1))
    vis_index = torch.where(visible & on_chain, vis_index,
                            torch.full_like(vis_index, -1))
    length = (visible & on_chain).sum(dim=1, dtype=_I32)
    return {'tree_pos': tree_pos, 'vis_index': vis_index,
            'node_at_pos': node_at_pos.to(_I32), 'length': length}


def _child_sort(parent, elem, actor, valid, anchor=None):
    """Step 1 over [K, n] planes: the stable sort of the children into
    (parent asc, elem desc, actor desc) — with ``anchor`` (the delta
    orderer), (parent asc, anchor asc, elem desc, actor desc), where the
    anchor counts for children of node 0 only. Returns int64 ``(order,
    parent_adj, parent)``; ``parent_adj`` is the sort's parent key, with
    the head and the padding bucketed at n."""
    K, n = parent.shape
    idx = torch.arange(n, dtype=torch.int64, device=parent.device)[None, :] \
        .expand(K, n)
    parent = parent.to(torch.int64)
    # the head (node 0) is nobody's child: bucket it with the padding so
    # it never receives sibling links of its own
    parent_adj = torch.where(valid.to(torch.bool) & (idx != 0), parent,
                             torch.full_like(parent, n))
    keys = [-actor.to(torch.int64), -elem.to(torch.int64)]
    if anchor is not None:
        keys.append(torch.where(parent_adj == 0, anchor.to(torch.int64),
                                torch.zeros_like(parent_adj)))
    order = _stable_lexsort((*keys, parent_adj))
    return order, parent_adj, parent


def _rga_order_plain(parent, elem, actor, visible, valid):
    """The plain RGA order over [K, m] job planes: the child sort, then
    steps 2-4. The plain version of the narrow CUDA kernel, and the CPU
    path of `_rga_order_batched`."""
    order, parent_adj, parent64 = _child_sort(parent, elem, actor, valid)
    return _order_from_sorted_plain(order, parent_adj, parent64, visible,
                                    valid)


def _rga_order_batched(parent, elem, actor, visible, valid):
    """Batched RGA over [K, m] job planes (parent/elem/actor int32,
    visible/valid bool). Returns {'tree_pos', 'vis_index',
    'node_at_pos': int32[K, m], 'length': int32[K]} — equal to the JAX
    `_rga_order_batched` on every row (tree_pos on valid rows).

    CUDA planes always go through a kernel (inputs cast to its
    int32/bool, contiguous; a build or launch failure raises): the
    narrow one straight from these planes up to
    ``cuda_sequence.M_NARROW`` nodes, past it the variant
    ``cuda_sequence.variant(K, m)`` names — the wide kernel, also
    straight from these planes, or for ``'wide-grid'`` the PyTorch child
    sort and the grid kernel. CPU
    planes take `_rga_order_plain`, and so do numpy arrays or any
    other array (:func:`~automerge_tpu_torch.config.as_tensor` puts
    them on the host)."""
    parent, elem, actor, visible, valid = map(
        as_tensor, (parent, elem, actor, visible, valid))
    if parent.device.type != 'cuda':
        return _rga_order_plain(parent, elem, actor, visible, valid)
    m = parent.shape[1]
    rounds = _ceil_log2(m) + 1
    flags = (visible.to(torch.bool).contiguous(),
             valid.to(torch.bool).contiguous())
    raw = [t.to(_I32).contiguous() for t in (parent, elem, actor)]
    if m <= cuda_sequence.M_NARROW:
        return cuda_sequence.rga_order_cuda(*raw, *flags, rounds=rounds)
    if cuda_sequence.variant(*parent.shape) != 'wide-grid':
        return cuda_sequence.rga_wide_cuda(*raw, *flags, rounds=rounds)
    order, parent_adj, parent = _child_sort(parent, elem, actor, valid)
    return cuda_sequence.order_from_sorted_cuda(
        *(t.to(_I32).contiguous() for t in (order, parent_adj, parent)),
        *flags, rounds=rounds)


def _rga_delta_order_plain(parent, anchor, elem, actor, valid):
    """DFS order of one tick's delta forest over [K, n] planes — the
    small companion of the RGA order behind the incremental index update
    (``general._fused_general_incr``): the tick's new nodes order among
    THEMSELVES here, then splice into the persistent index with one
    prefix-sum merge.

    Slot 0 is a virtual head standing in for the ENTIRE existing tree; a
    delta node whose parent existed before this tick (a delta root) is a
    child of that head and carries the OLD tree position of its real
    parent as ``anchor``. Children of the head sort by (anchor asc, elem
    desc, actor desc), children of delta nodes by the ordinary RGA key.
    Valid only under the front-insert precondition the caller checks on
    the host. Returns int32 ``tree_pos`` [K, n]: 0 for the head, 1..count
    for delta nodes in their final relative order (padding rows carry
    garbage). The plain version of the kernel's delta mode."""
    order, parent_adj, parent64 = _child_sort(parent, elem, actor, valid,
                                              anchor)
    return _thread_and_rank(parent64, parent_adj, order,
                            valid.to(torch.bool))


def _rga_delta_order_batched(parent, anchor, elem, actor, valid):
    """Batched delta ordering over [K, n] planes (parent, anchor, elem,
    actor int32; valid bool). Returns int32 ``tree_pos`` [K, n], equal to
    the JAX `_rga_delta_order_batched` on every valid row.

    CUDA planes always go through a kernel (a build or launch failure
    raises): the RGA kernel's delta mode, in the variant
    ``cuda_sequence.delta_variant(K, m)`` names — subwarp up to
    ``cuda_sequence.M_SUBWARP`` nodes, narrow up to
    ``cuda_sequence.M_NARROW``, past it the wide kernel with the anchor
    plane, or for ``'wide-grid'`` the PyTorch child sort with the anchor
    key and the grid kernel. CPU planes and other arrays take
    `_rga_delta_order_plain`."""
    parent, anchor, elem, actor, valid = map(
        as_tensor, (parent, anchor, elem, actor, valid))
    if parent.device.type != 'cuda':
        return _rga_delta_order_plain(parent, anchor, elem, actor, valid)
    m = parent.shape[1]
    rounds = _ceil_log2(m) + 1
    valid = valid.to(torch.bool).contiguous()
    v = cuda_sequence.delta_variant(*parent.shape)
    if v in ('narrow', 'subwarp'):
        return cuda_sequence.rga_delta_cuda(
            *(t.to(_I32).contiguous() for t in (parent, anchor, elem,
                                                 actor)),
            valid, rounds=rounds)
    if v != 'wide-grid':
        return cuda_sequence.rga_wide_cuda(
            *(t.to(_I32).contiguous() for t in (parent, elem, actor)),
            None, valid, rounds=rounds,
            anchor=anchor.to(_I32).contiguous())
    order, parent_adj, parent = _child_sort(parent, elem, actor, valid,
                                            anchor)
    return cuda_sequence.order_from_sorted_cuda(
        *(t.to(_I32).contiguous() for t in (order, parent_adj, parent)),
        valid, valid, rounds=rounds)['tree_pos']


def _rga_order(parent, elem, actor, visible, valid):
    """One insertion tree ([n] planes): `_rga_order_batched` on a batch
    of one."""
    parent, elem, actor, visible, valid = map(
        as_tensor, (parent, elem, actor, visible, valid))
    out = _rga_order_batched(parent[None], elem[None], actor[None],
                             visible[None], valid[None])
    return {'tree_pos': out['tree_pos'][0], 'vis_index': out['vis_index'][0],
            'node_at_pos': out['node_at_pos'][0],
            'length': out['length'][0]}


def rga_order(parent, elem, actor, visible, valid):
    """Total document order of an insertion tree.

    Args:
      parent:  int32[n] parent node index per node (node 0 = '_head')
      elem:    int32[n] Lamport counter per node
      actor:   int32[n] actor rank per node
      visible: bool[n]  node currently has a value (not a tombstone)
      valid:   bool[n]  padding mask (node 0 must be valid)

    Returns dict of tree_pos, vis_index, node_at_pos (int32[n]) and
    length (int32).
    """
    return _rga_order(parent, elem, actor, visible, valid)


def rga_order_batch(parent, elem, actor, visible, valid):
    """Batched ordering over a leading document axis."""
    return _rga_order_batched(parent, elem, actor, visible, valid)
