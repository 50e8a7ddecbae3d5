"""The flat-map resolve: the PyTorch port's plain version
(``merge.resolve_assignments_batch``, the CPU path of
``cuda_merge.dispatch_resolve``) against the JAX package's Pallas kernel
in interpret mode and its XLA segment resolve, on numpy-seeded
``gen_docset_workload`` batches at the shapes of ``tests/test_pallas.py``
— exact equality, dtypes included — and on one long document (replica
sync's union) against ``merge._resolve``, edge ids included; and the
variant dispatch's bounds, the split variant's bands among them.
The CUDA kernel's variants (each forced through ``resolve_cuda``'s
``force``) are held against the plain version on the card
(``cuda``-marked cases; run there with ``python -m pytest
tests/test_torch_flatmap_resolve.py -m cuda``). The JAX package is
imported inside the tests that compare with it, so the card's cases
need only the port."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device import cuda_grid, cuda_merge, engine, merge
from automerge_tpu_torch.device.workloads import (gen_block_workload,
                                                  gen_docset_workload)

torch.set_num_threads(1)

SHAPES = [(1, 8, 2, 3), (3, 130, 4, 7), (8, 128, 8, 32), (9, 257, 3, 40)]
KEYS = ('surviving', 'winner', 'seg_max_actor')


def _workload(n_docs, n_ops, n_actors, n_keys, seed=0):
    return gen_docset_workload(n_docs=n_docs, n_ops=n_ops,
                               n_actors=n_actors, n_keys=n_keys, seed=seed,
                               del_p=0.1, invalid_p=0.1, cross_clock=True)


def _same(jout, tout, keys=KEYS):
    for k in keys:
        a = np.asarray(jout[k])
        b = tout[k].cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize('n_docs,n_ops,n_actors,n_keys', SHAPES)
def test_plain_matches_jax_pallas_and_xla(n_docs, n_ops, n_actors, n_keys):
    import jax.numpy as jnp
    from automerge_tpu.device.merge import resolve_assignments_batch
    from automerge_tpu.device.pallas_merge import \
        resolve_assignments_batch_pallas
    args = _workload(n_docs, n_ops, n_actors, n_keys)
    jargs = tuple(jnp.asarray(a) for a in args)
    got = cuda_merge.dispatch_resolve(*(torch.as_tensor(a) for a in args),
                                      num_segments=n_ops)
    _same(resolve_assignments_batch(*jargs, num_segments=n_ops), got)
    _same(resolve_assignments_batch_pallas(*jargs, num_segments=n_ops,
                                           interpret=True), got)


def _tiny(seg_id, actor, seq, clock, is_del, valid):
    return tuple(torch.as_tensor(np.asarray(a, dt)) for a, dt in (
        (seg_id, np.int32), (actor, np.int32), (seq, np.int32),
        (clock, np.int32), (is_del, bool), (valid, bool)))


def test_all_deleted_segment():
    args = _tiny(np.zeros((1, 4)), [[0, 1, 2, 3]], np.ones((1, 4)),
                 np.zeros((1, 4, 4)), np.ones((1, 4)), np.ones((1, 4)))
    out = cuda_merge.dispatch_resolve(*args, num_segments=4)
    assert int(out['winner'][0, 0]) == -1
    assert not bool(out['surviving'].any())
    # empty segments: winner -1, seg_max_actor the segment_max identity
    assert out['winner'][0, 1:].tolist() == [-1] * 3
    assert out['seg_max_actor'][0].tolist() == [-1] + [-(1 << 31)] * 3


def test_all_invalid_segment_reads_minus_one_in_both_packages():
    """A segment of only invalid (padding) ops reads seg_max_actor -1,
    not the empty segment's INT32_MIN: the invalid ops scatter -1. Both
    the plain version and the JAX package's Pallas kernel (interpret
    mode) say so, and the warp variant's winner keys must keep it."""
    import jax.numpy as jnp
    from automerge_tpu.device.pallas_merge import \
        resolve_assignments_batch_pallas
    # segment 0: invalid ops only; 1: deleted ops only; 2: one live op
    # of actor 2; 3: no op
    args = _tiny([[0, 0, 1, 1, 2, 0]], [[1, 3, 1, 3, 2, 0]],
                 np.ones((1, 6)), np.zeros((1, 6, 4)),
                 [[0, 0, 1, 1, 0, 0]], [[0, 0, 1, 1, 1, 0]])
    got = cuda_merge.dispatch_resolve(*args, num_segments=4)
    assert got['seg_max_actor'][0].tolist() == [-1, -1, 2, -(1 << 31)]
    assert got['winner'][0].tolist() == [-1, -1, 4, -1]
    assert got['surviving'][0].tolist() == [False] * 4 + [True, False]
    _same(resolve_assignments_batch_pallas(
        *(jnp.asarray(a.numpy()) for a in args), num_segments=4,
        interpret=True), got)


# (N, S, A) -> the variant the dispatch documents: (16960, 32, 8) holds
# a warp slice of exactly the shared-memory cap, (512, 32, 3) and
# (512, 512, 1) N_WARP_SCALAR ops on the word-by-word clock stream (and
# (1024, 256, 2) one bucket past it), (16, 4096, 8) a slot-heavy slice
# that still fits, and (513, 5119, 8) block slots of exactly the cap
VARIANT_CASES = [
    ((128, 32, 8), 'warp'), ((1, 1, 1), 'warp'), ((16, 256, 8), 'warp'),
    ((16, 4096, 8), 'warp'), ((512, 512, 1), 'warp'),
    ((1024, 256, 2), 'block'), ((64, 1024, 16), 'warp'),
    ((8192, 32, 8), 'warp'), ((16960, 32, 8), 'warp'),
    ((16961, 32, 8), 'block'), ((512, 32, 3), 'warp'),
    ((513, 32, 3), 'block'), ((8192, 32, 3), 'block'),
    ((513, 5119, 8), 'block'), ((513, 5120, 8), 'block-global'),
    ((64, 6000, 6000), 'block-global'),
]


@pytest.mark.parametrize('shape,want', VARIANT_CASES)
def test_variant_bounds(shape, want):
    N, S, A = shape
    assert cuda_merge.variant(N, S, A) == want
    if want == 'warp':
        assert cuda_merge.warp_slice_bytes(N, S, A) <= 200 * 1024
        assert A % 4 == 0 or N <= cuda_merge.N_WARP_SCALAR
    assert cuda_merge.variant(N, S, A, force='block') == \
        ('block-global' if want == 'block-global' else 'block')


def test_variant_force():
    assert cuda_merge.warp_slice_bytes(16960, 32, 8) == 200 * 1024
    assert cuda_merge.variant(8192, 32, 3, force='warp') == 'warp'
    assert cuda_merge.variant(16, 4096, 8, force='warp') == 'warp'
    with pytest.raises(ValueError):
        cuda_merge.variant(64, 6000, 8, force='warp')   # slice > the cap
    with pytest.raises(ValueError):
        cuda_merge.variant(128, 32, 8, force='wide')


# (N, S, A, D) -> the variant the dispatch takes once the caller names
# the document count: replica sync's union of one long document takes
# the split variant; the map-only batch and a sharded engine's shard
# (thousands of short documents) keep the warp variant
SPLIT_CASES = [
    ((65536, 4096, 16, 1), 'split'),
    ((128, 32, 8, 10240), 'warp'),
    ((128, 32, 8, 2560), 'warp'),
    ((128, 32, 8, 1), 'warp'),
]


@pytest.mark.parametrize('shape,want', SPLIT_CASES)
def test_variant_with_documents(shape, want):
    N, S, A, D = shape
    assert cuda_merge.variant(N, S, A, D=D) == want
    assert cuda_merge.variant(N, S, A, D=None) == cuda_merge.variant(N, S, A)


@pytest.mark.parametrize('shape,want', VARIANT_CASES)
def test_variant_without_documents_keeps_its_answer(shape, want):
    """``D=None`` gives the answer of the dispatch before the split
    variant existed, at every shape of :data:`VARIANT_CASES`."""
    assert cuda_merge.variant(*shape, D=None) == want


@pytest.mark.parametrize('S,A', [(32, 8), (32, 16), (4096, 8), (4096, 16)])
def test_split_band_edges(S, A):
    """Each band of ``SPLIT_BANDS`` sends up to its document count to
    the split variant and one document more to the variant without it,
    at its upper bound of N and one op past the band below."""
    lower = 0
    for bound, rows in cuda_merge.SPLIT_BANDS:
        for N in sorted({lower + 1, bound or 65536}):
            without = cuda_merge.variant(N, S, A)
            if rows:
                assert cuda_merge.variant(N, S, A, D=rows) == 'split'
            assert cuda_merge.variant(N, S, A, D=rows + 1) == without
            assert cuda_merge.variant(N, S, A, D=max(rows, 1) * 1000) == \
                without
        lower = bound or lower


def test_split_scratch_and_limits():
    assert cuda_merge.split_scratch_words(1, 4096, 16) == 4096 * 18
    assert cuda_merge.split_scratch_words(3, 5, 3) == 3 * 5 * 5
    assert cuda_merge.split_fits(1, 65536, 4096)
    assert cuda_merge.split_fits(1, cuda_grid.GRID_MAX_SLOTS, 1)
    assert not cuda_merge.split_fits(1, cuda_grid.GRID_MAX_SLOTS + 1, 1)
    assert cuda_merge.split_fits(1, 8, cuda_merge.SPLIT_MAX_SLOTS)
    assert not cuda_merge.split_fits(2, 8, cuda_merge.SPLIT_MAX_SLOTS // 2 + 1)
    assert cuda_merge.variant(128, 32, 8, force='split', D=10240) == 'split'
    with pytest.raises(ValueError):                     # no document count
        cuda_merge.variant(128, 32, 8, force='split')
    with pytest.raises(ValueError):                     # past its slots
        cuda_merge.variant(8, cuda_merge.SPLIT_MAX_SLOTS, 1, force='split',
                           D=2)
    # past its limits the dispatch keeps the other variants
    assert cuda_merge.variant(8, cuda_merge.SPLIT_MAX_SLOTS, 1, D=2) == \
        cuda_merge.variant(8, cuda_merge.SPLIT_MAX_SLOTS, 1)


def _one_long_document(N, S, A, seed):
    """One document (D = 1) of ``N`` ops over ``S`` fields and ``A``
    actors, the shape of replica sync's union, with every edge of the
    plain version's semantics: invalid ops and deletes (one in ten
    each), segment ids below 0 (wrapping once, then clamped) and at or
    past S (scattering nothing), and actor ties (ops copied to a later
    index of their field, so two survivors of one actor share it and the
    lower index must win)."""
    seg, actor, seq, clock, is_del, valid = _workload(1, N, A, S, seed=seed)
    pick = np.random.default_rng(seed + 1).choice(N, 40, replace=False)
    seg[0, pick[:8]] = [-1, -2, -S, -S - 1, -S - 9, S, S + 1, 2**31 - 1]
    src, dst = np.sort(pick[8:40].reshape(2, 16), axis=0)
    for arr in (seg, actor, seq, clock, is_del, valid):
        arr[0, dst] = arr[0, src]
    return seg, actor, seq, clock, is_del, valid


def test_plain_matches_jax_resolve_on_one_long_document():
    """The plain version at replica sync's shape, one long document
    (D = 1, N = 4,096, S = 256, A = 16), against the JAX package's
    ``merge._resolve`` (what its replica sync runs per peer,
    ``ici_sync.py:83`` and ``:149``) and its batch form: every output,
    edge ids included."""
    import jax.numpy as jnp
    from automerge_tpu.device import merge as jm
    N, S = 4096, 256
    args = _one_long_document(N, S, 16, seed=41)
    got = cuda_merge.dispatch_resolve(*(torch.as_tensor(a) for a in args),
                                      num_segments=S)
    assert int(got['winner'].ne(-1).sum()) > S // 2
    one = jm._resolve(*(jnp.asarray(a[0]) for a in args), num_segments=S)
    _same({k: np.asarray(v)[None] for k, v in one.items()}, got)
    _same(jm.resolve_assignments_batch(*(jnp.asarray(a) for a in args),
                                       num_segments=S), got)


def test_plain_matches_jax_pallas_on_one_long_document():
    """The same edges against the Pallas kernel in interpret mode, at a
    width its interpreter takes in seconds (its tiles compare every op
    pair: 48 s at N = 1,024 here): winner and seg_max_actor everywhere,
    surviving on the in-range ops. An op whose segment id lies outside
    [0, S) is matched by its raw id in the Pallas kernel, but gathers
    its survivorship from the wrapped, clamped slot in ``merge._resolve``
    and the plain version; neither reaches a field's outputs."""
    import jax.numpy as jnp
    from automerge_tpu.device.pallas_merge import \
        resolve_assignments_batch_pallas
    N, S = 256, 64
    args = _one_long_document(N, S, 16, seed=43)
    got = cuda_merge.dispatch_resolve(*(torch.as_tensor(a) for a in args),
                                      num_segments=S)
    want = resolve_assignments_batch_pallas(
        *(jnp.asarray(a) for a in args), num_segments=S, interpret=True)
    _same(want, got, keys=('winner', 'seg_max_actor'))
    seg = args[0]
    in_rng = (seg >= 0) & (seg < S)
    surv = np.asarray(want['surviving'])
    assert surv.dtype == got['surviving'].numpy().dtype
    assert np.array_equal(surv[in_rng], got['surviving'].numpy()[in_rng])


def test_supersession_chain():
    args = _tiny(np.zeros((1, 2)), [[0, 1]], [[1, 1]],
                 [[[0, 0], [1, 0]]], np.zeros((1, 2)), np.ones((1, 2)))
    out = cuda_merge.dispatch_resolve(*args, num_segments=2)
    assert out['surviving'][0].tolist() == [False, True]
    assert int(out['winner'][0, 0]) == 1


def test_workloads_match_the_jax_package():
    from automerge_tpu.device import workloads as jw
    for kw in ({'cross_clock': True, 'invalid_p': 0.1}, {}):
        a = gen_docset_workload(n_docs=5, n_ops=40, n_actors=3, n_keys=6,
                                seed=3, **kw)
        b = jw.gen_docset_workload(n_docs=5, n_ops=40, n_actors=3,
                                   n_keys=6, seed=3, **kw)
        for x, y in zip(a, b, strict=True):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert gen_block_workload(n_docs=4, n_actors=3, ops_per_change=4,
                              n_keys=8, seed=2, del_p=0.2).to_changes() == \
        jw.gen_block_workload(n_docs=4, n_actors=3, ops_per_change=4,
                              n_keys=8, seed=2, del_p=0.2).to_changes()


def test_pick_resolve_kernel_routing_on_the_cpu():
    assert engine.pick_resolve_kernel('xla') is \
        merge.resolve_assignments_batch
    assert engine.pick_resolve_kernel('pallas') is \
        cuda_merge.dispatch_resolve
    assert engine.pick_resolve_kernel('auto') is cuda_merge.dispatch_resolve
    args = tuple(torch.as_tensor(a) for a in _workload(3, 20, 3, 5))
    before = sum(cuda_merge.launches.values())
    outs = [engine.pick_resolve_kernel(k)(*args, num_segments=20)
            for k in ('auto', 'pallas', 'xla')]
    # CPU tensors: plain only
    assert sum(cuda_merge.launches.values()) == before
    for out in outs[1:]:
        for k in KEYS:
            assert torch.equal(outs[0][k], out[k])
    with pytest.raises(ValueError):
        cuda_merge.resolve_cuda(*args, num_segments=20)


def test_batch_merge_docs_kernels_agree_on_the_cpu():
    docs = gen_block_workload(n_docs=6, n_actors=4, ops_per_change=5,
                              n_keys=12, seed=9, del_p=0.2).to_changes()
    outs = [engine.batch_merge_docs(docs, kernel=k, device='cpu')
            for k in ('auto', 'pallas', 'xla')]
    assert outs[0] == outs[1] == outs[2]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_flatmap_resolve.py -m cuda)')
    return torch.device('cuda')


CUDA_SHAPES = ([s + (s[1],) for s in SHAPES]
               + [(10240, 128, 8, 32, 32), (10241, 128, 8, 32, 32),
                  (4, 64, 8, 6000, 6000)])


def _edge_rows(args, n_segs):
    """Doc 0: out-of-range segment ids (the sink slot / the wrapped
    gather); doc 1: all padding; doc 2: segment 0 holds only deleted or
    invalid ops."""
    seg_id, _, _, _, is_del, valid = args
    edge = torch.tensor([-1, n_segs, -n_segs - 2], dtype=torch.int32)
    seg_id[0, :3] = edge[:seg_id.shape[1]]
    if seg_id.shape[0] > 1:
        valid[1] = False
    if seg_id.shape[0] > 2:
        seg_id[2, :4] = 0
        in0 = seg_id[2] == 0
        odd = torch.arange(in0.shape[0], device=in0.device) % 2 == 1
        is_del[2] |= in0
        valid[2] &= ~(in0 & odd)


@pytest.mark.cuda
@pytest.mark.parametrize('force', [None, 'warp', 'block'])
@pytest.mark.parametrize('n_docs,n_ops,n_actors,n_keys,n_segs', CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, n_docs, n_ops, n_actors,
                                   n_keys, n_segs, force):
    args = [torch.as_tensor(a).to(cuda_device)
            for a in _workload(n_docs, n_ops, n_actors, n_keys, seed=5)]
    _edge_rows(args, n_segs)
    want = merge.resolve_assignments_batch(*args, num_segments=n_segs)
    if n_segs > 1 and n_docs > 2:
        assert int(want['seg_max_actor'][2, 0]) == -1
    before = sum(cuda_merge.launches.values())
    if force == 'warp' and cuda_merge.warp_slice_bytes(
            n_ops, n_segs, n_actors) > 200 * 1024:
        with pytest.raises(ValueError):
            cuda_merge.resolve_cuda(*args, num_segments=n_segs, force=force)
        return
    if force is None:
        got = engine.pick_resolve_kernel('auto')(*args, num_segments=n_segs)
    else:
        got = cuda_merge.resolve_cuda(*args, num_segments=n_segs,
                                      force=force)
    torch.cuda.synchronize()
    assert sum(cuda_merge.launches.values()) == before + 1
    assert cuda_merge.last_variant == cuda_merge.variant(
        n_ops, n_segs, n_actors, force, D=n_docs)
    for k in KEYS:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k])



# the split variant's shapes on the card: one to three documents of one
# op to replica sync's 65,536, 16 actors (16-byte clock vectors) or 3
# (word by word), S = N // 16 fields (one field for a single op)
SPLIT_CUDA = [(D, N, A) for D in (1, 2, 3) for N in (1, 31, 4096, 65536)
              for A in (16, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize('force', [None, 'split'])
@pytest.mark.parametrize('n_docs,n_ops,n_actors', SPLIT_CUDA)
def test_cuda_split_matches_plain(cuda_device, n_docs, n_ops, n_actors,
                                  force):
    """The split variant, forced and through the dispatch, against the
    plain version with the edge rows of ``_edge_rows`` (out-of-range
    segment ids, an all-padding document, a field of only dead ops)."""
    n_segs = max(1, n_ops // 16)
    args = [torch.as_tensor(a).to(cuda_device) for a in _workload(
        n_docs, n_ops, n_actors, n_segs, seed=n_docs + n_ops)]
    _edge_rows(args, n_segs)
    want = merge.resolve_assignments_batch(*args, num_segments=n_segs)
    before = sum(cuda_merge.launches.values())
    if force is None:
        got = cuda_merge.dispatch_resolve(*args, num_segments=n_segs)
    else:
        got = cuda_merge.resolve_cuda(*args, num_segments=n_segs,
                                      force=force)
    torch.cuda.synchronize()
    assert sum(cuda_merge.launches.values()) == before + 1
    assert cuda_merge.last_variant == cuda_merge.variant(
        n_ops, n_segs, n_actors, force, D=n_docs)
    for k in KEYS:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k])


@pytest.mark.cuda
@pytest.mark.parametrize('n_segs', [1, 4096])
def test_cuda_split_one_segment_and_out_of_range(cuda_device, n_segs):
    """One long document whose ops all share one field (every key
    maximum lands on one slot) or spread over 4,096, a quarter of its
    segment ids out of range: the split variant bit-equal to the plain
    version and to the block variant."""
    rng = np.random.default_rng(n_segs)
    args = [torch.as_tensor(a).to(cuda_device)
            for a in _workload(1, 65536, 16, n_segs, seed=3)]
    out = rng.random(65536) < 0.25
    args[0][0, torch.as_tensor(out).to(cuda_device)] = torch.as_tensor(
        rng.integers(-2 * n_segs - 3, 2 * n_segs + 3, int(out.sum())),
        dtype=torch.int32).to(cuda_device)
    want = merge.resolve_assignments_batch(*args, num_segments=n_segs)
    for force in ('split', 'block'):
        got = cuda_merge.resolve_cuda(*args, num_segments=n_segs,
                                      force=force)
        torch.cuda.synchronize()
        for k in KEYS:
            assert torch.equal(want[k], got[k]), (force, k)
