"""The mesh layer's base: the PyTorch port's ``parallel/mesh.py``.

A port mesh is an ordered list of ``torch.device`` entries (repeats
allowed; the CPU tests run 8 logical ``'cpu'`` entries, where the JAX
tests run 8 forced host devices). Each collective is one function over
the per-shard tensors: held against numpy, dtypes included (int32 stays
int32, bit-equal). ``make_mesh`` raises without a card unless
``device='cpu'`` is asked for."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.config import Options
from automerge_tpu_torch.parallel import mesh as M
from automerge_tpu_torch.parallel.ici_sync import make_peer_mesh

torch.set_num_threads(1)


def _shards(seed, n_dev, shape, dtype):
    rng = np.random.default_rng(seed)
    arr = rng.integers(-2**20, 2**20, size=(n_dev,) + shape)
    return arr.astype(dtype), [torch.as_tensor(a) for a in arr.astype(dtype)]


@pytest.mark.parametrize('dtype', [np.int32, np.int64, np.float32])
@pytest.mark.parametrize('n_dev', [1, 3, 8])
def test_collectives_match_numpy(n_dev, dtype):
    arr, xs = _shards(n_dev, n_dev, (5, 3), dtype)
    for name, fn, want in (
            ('psum', M.psum, arr.sum(axis=0).astype(dtype)),
            ('pmax', M.pmax, arr.max(axis=0)),
            ('all_gather', M.all_gather, arr),
            ('all_gather tiled', lambda x: M.all_gather(x, tiled=True),
             arr.reshape((-1, 3)))):
        got = fn(xs)
        assert len(got) == n_dev, name
        for g in got:
            assert g.dtype == xs[0].dtype, name
            np.testing.assert_array_equal(g.numpy(), want, err_msg=name)


def test_psum_of_int32_wraps_as_int32():
    xs = [torch.tensor([2**31 - 1], dtype=torch.int32),
          torch.tensor([1], dtype=torch.int32)]
    assert M.psum(xs)[0].dtype == torch.int32
    assert int(M.psum(xs)[1]) == -2**31


def test_ppermute_ring_and_zeros_for_unreceived():
    arr, xs = _shards(4, 4, (6,), np.int32)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    got = M.ppermute(xs, ring)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), arr[(i - 1) % 4])
    got = M.ppermute(xs, [(0, 2)])
    np.testing.assert_array_equal(got[2].numpy(), arr[0])
    for i in (0, 1, 3):
        assert not got[i].any() and got[i].dtype == torch.int32


def test_make_mesh_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default mesh works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        M.make_mesh()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Options().make_mesh()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_peer_mesh(2)
    mesh = M.make_mesh(device='cpu')
    assert mesh.devices.size == 1 and mesh.axis_names == ('docs',)
    mesh = M.make_mesh(8, device='cpu')
    assert mesh.devices.size == 8
    assert all(d == torch.device('cpu') for d in mesh.devices)


def test_repeated_device_list_and_round_robin_placement():
    mesh = M.make_mesh(devices=['cpu', 'cpu', 'cpu'])
    assert mesh.devices.size == 3
    assert M.shard_device(mesh, 7) == torch.device('cpu')
    assert M.shard_device(M.make_mesh(devices=[]), 0) is None
    assert M.doc_sharding(mesh, 12) == [(0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError, match='do not divide'):
        M.doc_sharding(mesh, 10)
    a, b = M.shard_docs(mesh, np.arange(6), torch.arange(12).reshape(6, 2))
    assert [t.tolist() for t in a] == [[0, 1], [2, 3], [4, 5]]
    assert b[2].tolist() == [[8, 9], [10, 11]]
    # the mesh is a frozen, hashable value
    assert mesh == M.make_mesh(devices=['cpu'] * 3)
    assert len({mesh, M.make_mesh(devices=['cpu'] * 3)}) == 1


def test_options_build_meshes_on_the_cpu():
    mesh = Options().make_mesh(device='cpu')
    assert mesh.devices.size == 1
    mesh = Options(n_devices=4).make_mesh(device='cpu')
    assert mesh.devices.size == 4 and mesh.axis_names == ('docs',)
    peers = Options(n_devices=4).make_peer_mesh(device='cpu')
    assert peers.devices.size == 4 and peers.axis_names == ('peers',)


def test_peer_mesh_refuses_more_peers_than_devices():
    with pytest.raises(ValueError, match='need 3 devices for 3 peers'):
        make_peer_mesh(3, devices=['cpu', 'cpu'])
    assert make_peer_mesh(2, devices=['cpu'] * 4).devices.size == 2
