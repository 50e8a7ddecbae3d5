"""RGA ordering from the child sort: the PyTorch port's plain version
(``sequence._order_from_sorted_plain``, the CPU path of
``sequence._order_from_sorted``) against the JAX package's Pallas kernel
``rga_order_batch_pallas`` in interpret mode (``vis_index`` and
``length``, the outputs the Pallas kernel has) on numpy-seeded ragged
trees — exact equality, dtypes included. The CUDA kernel is held
against the plain version on the card (``cuda``-marked cases: every
output, ``tree_pos`` on valid rows, including the global-memory variant
at m = 40,000; run there with ``python -m pytest
tests/test_torch_rga_kernel.py -m cuda``). The JAX package is imported
inside the tests that compare with it, so the card's cases need only
the port."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.device import cuda_sequence, sequence

from chip_smoke import random_trees

torch.set_num_threads(1)

OUTS = ('tree_pos', 'vis_index', 'node_at_pos', 'length')


def _sorted_inputs(planes):
    """The inputs of the second step of ``_rga_order_batched``."""
    parent, elem, actor, visible, valid = planes
    return (*sequence._child_sort(parent, elem, actor, valid), visible,
            valid)


@pytest.mark.parametrize('K,m', [(3, 16), (9, 130)])
def test_plain_matches_jax_pallas_interpret(K, m):
    import jax.numpy as jnp
    from automerge_tpu.device.pallas_sequence import rga_order_batch_pallas
    planes = random_trees(np.random.default_rng(K * 100 + m), K, m)
    want = rga_order_batch_pallas(*(jnp.asarray(p) for p in planes),
                                  interpret=True)
    got = sequence._order_from_sorted_plain(
        *_sorted_inputs([torch.as_tensor(p) for p in planes]))
    for k in ('vis_index', 'length'):
        a = np.asarray(want[k])
        b = got[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_cpu_planes_take_the_plain_version():
    planes = [torch.as_tensor(p)
              for p in random_trees(np.random.default_rng(4), 5, 40)]
    before = cuda_sequence.launches
    got = sequence._rga_order_batched(*planes)
    assert cuda_sequence.launches == before
    want = sequence._order_from_sorted_plain(*_sorted_inputs(planes))
    for k in OUTS:
        assert got[k].dtype == torch.int32 and torch.equal(got[k], want[k])
    with pytest.raises(ValueError):
        cuda_sequence.order_from_sorted_cuda(
            *(t.to(torch.int32) for t in _sorted_inputs(planes)[:3]),
            planes[3], planes[4], rounds=7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_rga_kernel.py -m cuda)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('K,m', [(1, 2), (6, 16), (37, 200), (12288, 64),
                                 (64, 4096), (2, 40000)])
def test_cuda_kernel_matches_plain(cuda_device, K, m):
    planes = [torch.as_tensor(p).to(cuda_device)
              for p in random_trees(np.random.default_rng(K + m), K, m)]
    want = sequence._order_from_sorted_plain(*_sorted_inputs(planes))
    before = cuda_sequence.launches
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert cuda_sequence.launches == before + 1
    assert cuda_sequence.uses_global_scratch(m) == (m == 40000)
    valid = planes[4]
    for k in OUTS:
        assert got[k].dtype == want[k].dtype, k
        if k == 'tree_pos':
            assert torch.equal(got[k][valid], want[k][valid]), k
        else:
            assert torch.equal(got[k], want[k]), k
