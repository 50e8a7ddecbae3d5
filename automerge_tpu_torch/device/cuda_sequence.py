"""RGA ordering on the card: the hand-written CUDA kernel
(``csrc/rga_order.cu``) behind ``sequence._rga_order_batched``.

The port of ``automerge_tpu/device/pallas_sequence.py``. The child
sort (parent ascending, elem and actor descending) stays a PyTorch
stable sort, as it stays in XLA outside the Pallas kernel; from the
sorted permutation the kernel threads the insertion tree, climbs to
each node's nearest ancestor with a sibling, list-ranks the successor
chain and runs the visibility scan, one thread block per job row.

Two implementations, bit-identical by construction:

* ``sequence._order_from_sorted_plain`` — the plain PyTorch version
  (batched gathers and scatters into sink slots). It is the
  specification, the CPU path of ``sequence._order_from_sorted``, and
  what ``chip_smoke.py`` holds the kernel against on the card.
* :func:`order_from_sorted_cuda` — the CUDA kernel, built with nvcc for
  ``sm_90a`` on first use into ``_build/`` and bound with ctypes. It
  replaces ``_make_kernel`` / ``_rga_pallas_padded`` /
  ``rga_order_batch_pallas`` (``pallas_sequence.py`` :63-208), whose
  one-hot MXU matmuls existed only because the TPU lacks a fast
  gather. Unlike the TPU kernel it also emits ``tree_pos`` and
  ``node_at_pos``, which the general engine's rebuild writes back.

``sequence._order_from_sorted`` launches the kernel for every CUDA
tensor (raising if the build or the launch fails — there is no
fallback) and runs the plain version only for tensors on the CPU.
"""

import ctypes

import torch

from . import cuda_build

_I32 = torch.int32

# launches of the CUDA kernel since the last reset (one per launch, in
# order_from_sorted_cuda only) — the proof that a run went through it
launches = 0

# order, parent_adj, parent, visible, valid, tree_pos, vis_index,
# node_at_pos, length, scratch, K, m, rounds, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def reset_launches():
    global launches
    launches = 0


def uses_global_scratch(m):
    """Whether a launch at width ``m`` works on a global-memory scratch
    (its four planes of m+1 words exceed the shared-memory cap)."""
    fn = cuda_build.load('rga_order', 'rga_order_uses_smem', [ctypes.c_int])
    return not fn(m)


def order_from_sorted_cuda(order, parent_adj, parent, visible, valid,
                           rounds):
    """Launch the RGA kernel on contiguous CUDA [K, m] planes: int32
    ``order`` (the stable child sort), ``parent_adj`` (head and padding
    at m) and ``parent``, bool ``visible``/``valid``. ``rounds`` is the
    doubling round count. Returns the plain version's dict of int32
    ``tree_pos``, ``vis_index``, ``node_at_pos`` [K, m] and ``length``
    [K].

    Bound: per call the kernel must read ``K*m*14`` bytes and write
    ``K*m*12 + K*4`` bytes; its O(K*m*log m) pointer-doubling loads stay
    in shared memory up to m = 12,799 — memory- and launch-bound at the
    main path's widths."""
    global launches
    K, m = order.shape
    dev = order.device
    if dev.type != 'cuda':
        raise ValueError('order_from_sorted_cuda needs CUDA tensors')
    if m < 1 or rounds < 1:
        raise ValueError(f'bad RGA shape m={m} rounds={rounds}')
    for t, name in ((order, 'order'), (parent_adj, 'parent_adj'),
                    (parent, 'parent')):
        cuda_build.check(t, name, _I32, (K, m), dev)
    cuda_build.check(visible, 'visible', torch.bool, (K, m), dev)
    cuda_build.check(valid, 'valid', torch.bool, (K, m), dev)
    out = {'tree_pos': torch.empty((K, m), dtype=_I32, device=dev),
           'vis_index': torch.empty((K, m), dtype=_I32, device=dev),
           'node_at_pos': torch.empty((K, m), dtype=_I32, device=dev),
           'length': torch.empty((K,), dtype=_I32, device=dev)}
    if K == 0:                  # no job rows: nothing to launch
        return out
    fn = cuda_build.load('rga_order', 'rga_order_launch', _ARGTYPES)
    scratch = torch.empty((K, 4 * (m + 1)), dtype=_I32, device=dev) \
        if uses_global_scratch(m) else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(order.data_ptr(), parent_adj.data_ptr(), parent.data_ptr(),
                 visible.data_ptr(), valid.data_ptr(),
                 out['tree_pos'].data_ptr(), out['vis_index'].data_ptr(),
                 out['node_at_pos'].data_ptr(), out['length'].data_ptr(),
                 0 if scratch is None else scratch.data_ptr(), K, m, rounds,
                 stream)
    if err != 0:
        raise RuntimeError(f'rga_order kernel launch failed: CUDA error '
                           f'{err}')
    launches += 1
    return out
