"""Flat-map field resolution on the card: the hand-written CUDA kernel
(``csrc/flatmap_resolve.cu``) behind ``engine.pick_resolve_kernel``.

The port of ``automerge_tpu/device/pallas_merge.py``. Every assignment
op of every document in a batch is resolved at once: op *i* is
superseded when some op of its field has a clock entry for *i*'s actor
at or past *i*'s seq; deletes and padding never survive; each field's
winner is the surviving op with the highest actor rank, the lowest op
index on ties.

Two implementations, bit-identical by construction:

* ``merge.resolve_assignments_batch`` — the plain PyTorch version
  (segment maxima by ``scatter_reduce`` over ``S + 1`` slots per
  document, slot ``S`` the sink of out-of-range segment ids). It is the
  specification, the CPU path of :func:`dispatch_resolve`, and what
  ``chip_smoke.py`` holds the kernel against on the card.
* :func:`resolve_cuda` — the CUDA kernel, built with nvcc for
  ``sm_90a`` on first use into ``_build/`` and bound with ctypes. It
  replaces ``_make_kernel`` / ``_resolve_pallas_padded`` /
  ``resolve_assignments_batch_pallas`` (``pallas_merge.py`` :42-193):
  where the TPU kernel compares all op pairs of a document in tiles and
  gathers clocks with one-hot MXU matmuls, one thread block per
  document here keeps the plain version's slot maxima in shared memory
  and updates them with atomic maxima, O(N * A) per document.

:func:`dispatch_resolve` launches the kernel for every CUDA tensor
(raising if the build or the launch fails — there is no fallback) and
runs the plain version only for tensors on the CPU.
"""

import ctypes

import torch

from . import cuda_build
from . import merge as _merge

_I32 = torch.int32

# launches of the CUDA kernel since the last reset (one per launch, in
# resolve_cuda only) — the proof that a run went through the kernel
launches = 0

# seg_id, actor, seq, clock, is_del, valid, surviving, winner,
# seg_max_actor, scratch, D, N, S, A, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def reset_launches():
    global launches
    launches = 0


def resolve_cuda(seg_id, actor, seq, clock, is_del, valid, *,
                 num_segments):
    """Launch the flat-map kernel on CUDA tensors: int32 ``seg_id``,
    ``actor``, ``seq`` [D, N], int32 ``clock`` [D, N, A], bool
    ``is_del``/``valid`` [D, N], all contiguous. Returns the plain
    version's dict: ``surviving`` bool [D, N], ``winner`` and
    ``seg_max_actor`` int32 [D, S] (empty segments -1 / INT32_MIN).

    Bound: per call the kernel must read ``D*N*(14 + 4*A)`` bytes and
    write ``D*N + 8*D*S`` bytes, with O(D*N*A) integer maxima — bound by
    memory traffic."""
    global launches
    D, N = seg_id.shape
    dev = seg_id.device
    if dev.type != 'cuda':
        raise ValueError('resolve_cuda needs CUDA tensors')
    S = int(num_segments)
    A = clock.shape[2] if clock.dim() == 3 else -1
    if S < 1 or N < 1 or A < 1:
        raise ValueError(f'bad flat-map shape D={D} N={N} S={S} '
                         f'clock {tuple(clock.shape)}')
    for t, name in ((seg_id, 'seg_id'), (actor, 'actor'), (seq, 'seq')):
        cuda_build.check(t, name, _I32, (D, N), dev)
    cuda_build.check(clock, 'clock', _I32, (D, N, A), dev)
    cuda_build.check(is_del, 'is_del', torch.bool, (D, N), dev)
    cuda_build.check(valid, 'valid', torch.bool, (D, N), dev)
    surviving = torch.empty((D, N), dtype=torch.bool, device=dev)
    winner = torch.empty((D, S), dtype=_I32, device=dev)
    seg_max_actor = torch.empty((D, S), dtype=_I32, device=dev)
    out = {'surviving': surviving, 'winner': winner,
           'seg_max_actor': seg_max_actor}
    if D == 0:                  # no documents: nothing to launch
        return out
    fn = cuda_build.load('flatmap_resolve', 'flatmap_resolve_launch',
                         _ARGTYPES)
    uses_smem = cuda_build.load('flatmap_resolve',
                                'flatmap_resolve_uses_smem',
                                [ctypes.c_int, ctypes.c_int])
    scratch = None if uses_smem(S, A) else \
        torch.empty((D, (S + 1) * (A + 2)), dtype=_I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(seg_id.data_ptr(), actor.data_ptr(), seq.data_ptr(),
                 clock.data_ptr(), is_del.data_ptr(), valid.data_ptr(),
                 surviving.data_ptr(), winner.data_ptr(),
                 seg_max_actor.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 D, N, S, A, stream)
    if err != 0:
        raise RuntimeError(f'flatmap_resolve kernel launch failed: CUDA '
                           f'error {err}')
    launches += 1
    return out


def dispatch_resolve(seg_id, actor, seq, clock, is_del, valid, *,
                     num_segments):
    """Resolve a [D, N] batch of assignment ops (the signature of
    ``merge.resolve_assignments_batch``): CUDA tensors always go through
    the kernel (inputs cast to the kernel's int32/bool, contiguous);
    CPU tensors take the plain version."""
    if seg_id.device.type == 'cuda':
        return resolve_cuda(
            *(t.to(_I32).contiguous() for t in (seg_id, actor, seq, clock)),
            is_del.to(torch.bool).contiguous(),
            valid.to(torch.bool).contiguous(), num_segments=num_segments)
    return _merge.resolve_assignments_batch(seg_id, actor, seq, clock,
                                            is_del, valid,
                                            num_segments=num_segments)
