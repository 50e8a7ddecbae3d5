"""The PyTorch port stands alone: no module of ``automerge_tpu_torch``
(nor ``chip_smoke.py``, nor the port's ``tools/torch_*.py``) imports JAX
or the JAX package, importing it (the mesh layer included) loads
neither, nor any ``torch.distributed`` module beyond those ``import
torch`` loads, and its entry points refuse to fall back to the CPU when
CUDA is missing."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'automerge_tpu_torch')


def _port_sources():
    tools = os.path.join(ROOT, 'tools')
    out = [os.path.join(ROOT, 'chip_smoke.py')]
    out += [os.path.join(tools, f) for f in os.listdir(tools)
            if f.startswith('torch_') and f.endswith('.py')]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith('.py')]
    return sorted(out)


def _forbidden(name):
    return (name == 'jax' or name.startswith('jax.')
            or name == 'automerge_tpu' or name.startswith('automerge_tpu.'))


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f'{path} imports {bad}'


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        'import sys\n'
        # torch itself loads torch.distributed; the port must add none
        'import torch\n'
        'before = set(sys.modules)\n'
        'import automerge_tpu_torch\n'
        'import automerge_tpu_torch.device.general\n'
        'import automerge_tpu_torch.device.cuda_view\n'
        'import automerge_tpu_torch.device.engine\n'
        'import automerge_tpu_torch.device.general_backend\n'
        'import automerge_tpu_torch.device.backend\n'
        'import automerge_tpu_torch.device.cuda_build\n'
        'import automerge_tpu_torch.device.cuda_merge\n'
        'import automerge_tpu_torch.device.cuda_sequence\n'
        'import automerge_tpu_torch.device.workloads\n'
        'import automerge_tpu_torch.backend\n'
        'import automerge_tpu_torch.sync\n'
        'import automerge_tpu_torch.frontend\n'
        'import automerge_tpu_torch.native\n'
        'import automerge_tpu_torch.wire\n'
        'import automerge_tpu_torch.snapshot\n'
        'import automerge_tpu_torch.durability\n'
        'import automerge_tpu_torch.compaction\n'
        'import automerge_tpu_torch.traces\n'
        'import automerge_tpu_torch.interop\n'
        'import automerge_tpu_torch.frontend.worker\n'
        'import automerge_tpu_torch.device.clock\n'
        'import automerge_tpu_torch.device.text_block\n'
        'import automerge_tpu_torch.sync.watchable_doc\n'
        'import automerge_tpu_torch.sync.connection\n'
        'import automerge_tpu_torch.sync.resilient\n'
        'import automerge_tpu_torch.telemetry\n'
        'import automerge_tpu_torch.fleetsim\n'
        'import automerge_tpu_torch.sync.transport\n'
        'import automerge_tpu_torch.sync.serving\n'
        'import automerge_tpu_torch.sync.control\n'
        'import automerge_tpu_torch.sync.chaos\n'
        'import automerge_tpu_torch.sync.dense_doc_set\n'
        'import automerge_tpu_torch.device.dense_store\n'
        'import automerge_tpu_torch.parallel\n'
        'import automerge_tpu_torch.parallel.mesh\n'
        'import automerge_tpu_torch.parallel.docset_engine\n'
        'import automerge_tpu_torch.parallel.general_shard\n'
        'import automerge_tpu_torch.parallel.ici_sync\n'
        'import automerge_tpu_torch.sync.sharded\n'
        'new = set(sys.modules) - before\n'
        'print(sorted(m for m in new if m == "jax" or '
        'm.startswith("jax.") or m == "automerge_tpu" or '
        'm.startswith("automerge_tpu.") or m == "torch.distributed" '
        'or m.startswith("torch.distributed.")))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]', out.stdout


def test_card_lane_collects_without_jax():
    """``chip_smoke.py`` phase 4h runs the conformance harness's ``cuda``
    lane on a machine without JAX: with ``jax`` blocked, the harness's
    loader imports a JAX test module against the port, and the lane of
    ``chip_smoke.CONFORMANCE_FILES`` collects without an import error,
    exactly ``chip_smoke.CONFORMANCE_CASES`` cases by JAX module, and
    loads neither JAX nor the JAX package."""
    code = (
        'import collections, json, sys\n'
        "sys.modules['jax'] = None\n"
        f'sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "tests")!r}]\n'
        'import pytest\n'
        'import chip_smoke\n'
        'from test_torch_conformance_harness import load, source_module\n'
        'assert load("test_integration").Automerge.__name__ == '
        '"automerge_tpu_torch"\n'
        'class Items:\n'
        '    ids = []\n'
        '    def pytest_collection_finish(self, session):\n'
        '        Items.ids += [i.nodeid for i in session.items]\n'
        f'rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", '
        f'"-p", "no:xdist", "-p", "no:randomly", "-m", "cuda", '
        f'"--collect-only", "-q", "--rootdir", {ROOT!r}, '
        f'*[{ROOT!r} + "/" + f for f in chip_smoke.CONFORMANCE_FILES]], '
        f'plugins=[Items()])\n'
        'loaded = sorted(m for m in sys.modules if m.startswith("jax.") '
        'or m.split(".")[0] == "automerge_tpu")\n'
        'print(json.dumps([rc, collections.Counter(map(source_module, '
        'Items.ids)), chip_smoke.CONFORMANCE_CASES, loaded]))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rc, got, want, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and got == want and not loaded, out.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from automerge_tpu_torch import GeneralDocSet, init_store
    from automerge_tpu_torch.device import general_backend
    from automerge_tpu_torch.device import backend as device_backend
    from automerge_tpu_torch.device.engine import batch_merge_docs
    from automerge_tpu_torch.sync import DeviceDocSet
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        GeneralDocSet(4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_store(4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        GeneralDocSet(4, device='cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        general_backend.init()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        batch_merge_docs([[]])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_backend.init()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DeviceDocSet()
    from automerge_tpu_torch import fleetsim
    from automerge_tpu_torch.device.dense_store import DenseMapStore
    from automerge_tpu_torch.sync import DenseDocSet, ServingDocSet
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DenseMapStore(4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DenseDocSet(4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fleetsim.FleetSim('zipf')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ServingDocSet.recover(os.path.join(ROOT, 'no-such-dir'))


def test_cpu_entry_points_keep_every_tensor_on_the_cpu():
    from automerge_tpu_torch import GeneralDocSet
    ds = GeneralDocSet(2, device='cpu')
    ds.apply_changes('d', [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': 't'},
        {'action': 'link', 'obj': '00000000-0000-0000-0000-000000000000',
         'key': 'text', 'value': 't'},
        {'action': 'ins', 'obj': 't', 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': 't', 'key': 'a:1', 'value': 'x'}]}])
    assert ds.materialize('d') == {'text': 'x'}
    assert ds.device.type == 'cpu' and ds.store.device.type == 'cpu'
    mir = ds.store.pool.mirror
    assert all(v.device.type == 'cpu' for v in mir.values()
               if isinstance(v, torch.Tensor))


def test_unported_paths_raise_not_implemented():
    """Nothing on these paths is left unported: the wire apply, the
    state bootstrap and eviction (ported with the wire, compaction and
    sync stack) work on a CPU doc set, and so do the mesh hooks — a
    mesh from the options, a dense store on a mesh, and the sharded
    fleet scenario."""
    from automerge_tpu_torch import GeneralDocSet, compaction
    from automerge_tpu_torch.config import Options
    from automerge_tpu_torch.device import general
    import json
    ds = GeneralDocSet(2, device='cpu')
    change = {'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': '00000000-0000-0000-0000-000000000000',
         'key': 'k', 'value': 1}]}
    assert ds.apply_wire(json.dumps([[change]]).encode(),
                         doc_ids=['d']) == [ds.get_doc('d')]
    state = compaction.extract_doc_states(ds.store, [ds.id_of['d']])
    assert ds.extract_doc_state(['d'])['d']['clock'] == {'a': 1}
    ds.drop_doc_state(['d'])
    assert ds.materialize('d') == {}
    ds.apply_states({'d': state[ds.id_of['d']]['state']})
    assert ds.materialize('d') == {'k': 1}
    # the async apply is ported: it resolves to a patch
    fut = general.apply_general_block_async(ds.store, ds.store.encode_changes(
        [[{'actor': 'b', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'set', 'obj': '00000000-0000-0000-0000-000000000000',
             'key': 'k', 'value': 2}]}], []]))
    assert fut.diffs(0)
    general.close_general(ds.store)
    mesh = Options(n_devices=2).make_mesh(device='cpu')
    assert mesh.devices.size == 2
    from automerge_tpu_torch import fleetsim
    from automerge_tpu_torch.device.dense_store import DenseMapStore
    store = DenseMapStore(2, key_capacity=4, actor_capacity=2, mesh=mesh)
    assert [p[0].shape[0] for p in store._planes] == [4, 4]
    out = fleetsim.run_scenario('hot_shard', device='cpu')
    assert out['verdict'] == 'green' and out['migrations'] >= 1
