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
  gathers clocks with one-hot MXU matmuls, the kernel keeps the plain
  version's slot maxima in shared memory and updates them with atomic
  maxima, O(N * A) per document. Documents whose slots fit a warp's
  share of shared memory take one warp each (8 to a CTA): the warp
  reads each op once into its shared slice, streams the clock block
  coalesced, and elects each field's winner with one 64-bit atomic
  maximum per op. The rest take one thread block each (in a global
  scratch past the shared-memory cap). A batch of one or a few long
  documents (replica sync's union) takes the split variant: each
  document's ops cut into tiles over every SM, the slots in a global
  scratch in the L2, four phases behind grid barriers in one
  cooperative launch. :func:`variant` says which a shape takes.

:func:`dispatch_resolve` launches the kernel for every CUDA tensor
(raising if the build or the launch fails — there is no fallback) and
runs the plain version only for tensors on the CPU.
"""

import ctypes

import torch

from . import cuda_build, cuda_grid
from . import merge as _merge

_I32 = torch.int32

# the warp variant takes a shape when one warp's slice fits a CTA's
# shared memory and its clock stream moves 16-byte vectors (A % 4 == 0)
# or it has at most N_WARP_SCALAR ops; the block variant takes the rest
# (the crossovers at the callers' padding buckets, measured on an H100:
# PERF.md)
N_WARP_SCALAR = 512

# a batch of at most this many documents of N ops, N up to the band's
# bound (pairs of a bound, None for the open last band, and a document
# count), takes the split variant when the caller names D: the crossover
# table measured on an H100 (tools/torch_kernel_ab.py --split, PERF.md)
# at N from 512 to 65,536, D from 1 to 528, S in {32, 4,096} and A in
# {8, 16} — each band the most documents at which the split variant won
# at all four (S, A); below 512 ops it was not measured
SPLIT_BANDS = ((511, 0), (1024, 64), (4096, 264), (None, 528))
# the most slots (documents times segments) a split launch indexes: its
# stash code keeps the slot in 28 bits (csrc/flatmap_resolve.cu)
SPLIT_MAX_SLOTS = (1 << 28) - 1

# launches of the CUDA kernel since the last reset by (mode, variant):
# mode 'resolve' (the kernel's one mode), variant as :func:`variant`
# names it; counted in resolve_cuda where the kernel launches and
# nowhere else — the proof that a run went through it
launches = {}
# the variant of the latest launch ('warp', 'block', 'block-global' or
# 'split')
last_variant = None

# variant codes of the kernel's C entry point
_VARIANTS = {'warp': 0, 'block': 1, 'block-global': 2, 'split': 3}

# variant, seg_id, actor, seq, clock, is_del, valid, surviving, winner,
# seg_max_actor, scratch, D, N, S, A, stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def reset_launches():
    global last_variant
    last_variant = None
    launches.clear()


def warp_slice_bytes(N, S, A):
    """Shared-memory bytes of one warp of the warp variant: S int64
    winner keys and S*A clock maxima (each padded to 16 bytes), then the
    stash of three int32 words per op for N rounded up to 4."""
    def r16(b):
        return (b + 15) // 16 * 16
    return r16(8 * S) + r16(4 * S * A) + 12 * ((N + 3) // 4 * 4)


def split_scratch_words(D, S, A):
    """int32 words of the split variant's scratch: ``D*S`` int64 winner
    keys, then ``D*S*A`` clock maxima."""
    return D * S * (A + 2)


def split_fits(D, N, S):
    """Whether one split launch takes ``D`` documents of ``N`` ops and
    ``S`` segments: its ops within one grid launch's slots
    (``cuda_grid.GRID_MAX_SLOTS``), its document slots within
    :data:`SPLIT_MAX_SLOTS`."""
    return D * N <= cuda_grid.GRID_MAX_SLOTS and D * S <= SPLIT_MAX_SLOTS


def variant(N, S, A, force=None, D=None):
    """The kernel variant a launch of ``N`` ops per document, ``S``
    segments and ``A`` actors takes: ``'split'`` (each document over
    many CTAs) when the caller names the document count ``D`` and
    :data:`SPLIT_BANDS` sends ``D`` documents of ``N`` ops to it (and
    :func:`split_fits`); else ``'warp'`` (one warp per document)
    when :func:`warp_slice_bytes` fits a CTA and ``A % 4 == 0 or N <=
    N_WARP_SCALAR``, else ``'block'`` (one thread block per document),
    ``'block-global'``
    when the block's ``(S+1)*(A+2)`` slot words exceed the shared-memory
    cap. ``D=None`` gives the answer without the split variant.
    ``force`` ('warp', 'block' or 'split') overrides
    the bounds; a forced warp whose slice cannot fit a CTA, or a forced
    split without ``D`` or past :func:`split_fits`, raises."""
    if force not in (None, 'warp', 'block', 'split'):
        raise ValueError(f'unknown flat-map variant {force!r}')
    if force == 'split':
        if D is None or not split_fits(D, N, S):
            raise ValueError(f'the split variant cannot take D={D} N={N} '
                             f'S={S}')
        return force
    if force is None and D is not None and split_fits(D, N, S) and \
            D <= cuda_grid.band_rows(SPLIT_BANDS, N):
        return 'split'
    fits = warp_slice_bytes(N, S, A) <= cuda_build.SMEM_LIMIT
    v = force or ('warp' if fits and (A % 4 == 0 or N <= N_WARP_SCALAR)
                  else 'block')
    if v == 'warp' and not fits:
        raise ValueError(f'the warp variant cannot hold N={N} S={S} A={A} '
                         f'({warp_slice_bytes(N, S, A)} bytes a warp)')
    if v == 'block' and (S + 1) * (A + 2) * 4 > cuda_build.SMEM_LIMIT:
        v = 'block-global'
    return v


def resolve_cuda(seg_id, actor, seq, clock, is_del, valid, *,
                 num_segments, force=None):
    """Launch the flat-map kernel on CUDA tensors: int32 ``seg_id``,
    ``actor``, ``seq`` [D, N], int32 ``clock`` [D, N, A], bool
    ``is_del``/``valid`` [D, N], all contiguous. Returns the plain
    version's dict: ``surviving`` bool [D, N], ``winner`` and
    ``seg_max_actor`` int32 [D, S] (empty segments -1 / INT32_MIN).
    ``force`` picks a variant regardless of the shape (see
    :func:`variant`; the tests use it). The split variant works on a
    global scratch of :func:`split_scratch_words` int32, which it
    fills itself.

    Bound: per call the kernel must read ``D*N*(14 + 4*A)`` bytes and
    write ``D*N + 8*D*S`` bytes, with O(D*N*A) integer maxima — bound by
    memory traffic."""
    global last_variant
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
    var = variant(N, S, A, force, D=D)
    fn = cuda_build.load('flatmap_resolve', 'flatmap_resolve_run',
                         _ARGTYPES)
    scratch = None
    if var == 'block-global':
        scratch = torch.empty((D, (S + 1) * (A + 2)), dtype=_I32,
                              device=dev)
    elif var == 'split':
        scratch = torch.empty(split_scratch_words(D, S, A), dtype=_I32,
                              device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_VARIANTS[var], seg_id.data_ptr(), actor.data_ptr(),
                 seq.data_ptr(), clock.data_ptr(), is_del.data_ptr(),
                 valid.data_ptr(), surviving.data_ptr(), winner.data_ptr(),
                 seg_max_actor.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 D, N, S, A, stream)
    if err != 0:
        raise RuntimeError(f'flatmap_resolve kernel launch failed ({var} '
                           f'variant): CUDA error {err}')
    last_variant = var
    launches['resolve', var] = launches.get(('resolve', var), 0) + 1
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
