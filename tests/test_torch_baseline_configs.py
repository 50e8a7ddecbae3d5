"""BASELINE configs 1-3 in the port against the JAX package, and the
port's codec loader when it cannot build.

The same seeded inputs go through ``automerge_tpu`` (host-oracle
documents from its ``init``, its device backend and general engine on
the CPU) and the port with ``device='cpu'``, through the generators
``chip_smoke.py`` phase 4g drives on the card, with a counter uuid
factory in both packages. Every comparison is exact:

* config 1, the README's card list at the bench's size: ``save``,
  ``inspect``, the conflicts and the history's length;
* config 2, three writers' text at 3 x 40 chars: the change lists, the
  ``DeviceBackend.apply_changes`` diffs on the per-doc route and on the
  bulk route, ``apply_general_block``'s diffs, and each route's text
  against the host oracle's;
* config 3, DocSet + Connection: the eager exchange's message log and
  documents at 8 documents, the dense and general lines' at 16.

The codec loader (``native._wire_load``) with ``_native/`` and the
per-user cache both unwritable falls back to the pure-Python parser
with a warning, never an ``OSError``, and loads a stale binary it cannot
rebuild with a warning, as the JAX package's ``wire._load`` does.
"""

import json
import os
import pathlib
import subprocess
import warnings

import pytest
import torch

import automerge_tpu as jam
import automerge_tpu_torch as tam
from automerge_tpu.config import Options as JOptions
from automerge_tpu.device import backend as JDeviceBackend
from automerge_tpu.device import general as jgeneral
from automerge_tpu.device import general_backend as jgeneral_backend
from automerge_tpu.sync.connection import BatchingConnection as JBatching
from automerge_tpu.sync.dense_doc_set import DenseDocSet as JDense
from automerge_tpu.sync.general_doc_set import GeneralDocSet as JGeneral
from automerge_tpu_torch import native as tnative
from automerge_tpu_torch import wire as twire
from automerge_tpu_torch.config import Options as TOptions
from automerge_tpu_torch.device import backend as TDeviceBackend
from automerge_tpu_torch.device import general as tgeneral
from automerge_tpu_torch.device import general_backend as tgeneral_backend
from automerge_tpu_torch.sync.connection import BatchingConnection as \
    TBatching
from automerge_tpu_torch.sync.dense_doc_set import DenseDocSet as TDense
from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet as \
    TGeneral

from chip_smoke import (card_list_docs, card_list_merge, counter_uuids,
                        doc_view, docset_source, sync_round,
                        text_through_frontend, text_writer_changes)
from test_torch_wire import _container

torch.set_num_threads(1)

TEXT_CHARS = 120


@pytest.fixture(autouse=True)
def _uuids():
    """A counter uuid factory in each package, from 0, reset after."""
    jam.uuid.set_factory(counter_uuids())
    tam.uuid.set_factory(counter_uuids())
    yield
    jam.uuid.reset()
    tam.uuid.reset()


def _tam_cpu(actor):
    return tam.init(actor, device='cpu')


def _tam_oracle(actor):
    return tam.Frontend.init({'actorId': actor, 'backend': tam.Backend})


def _config1(am, new):
    a, b = card_list_docs(am, new)
    merged = card_list_merge(am, new, a, b)
    return {'saves': [am.save(d) for d in (a, b, merged)],
            'inspect': am.inspect(merged),
            'conflicts': [am.get_conflicts(merged),
                          am.get_conflicts(merged['cards'])] +
                         [am.get_conflicts(c) for c in merged['cards']],
            'history': len(am.get_history(merged)),
            'view': doc_view(merged)}


@pytest.mark.parametrize('new', [_tam_cpu, _tam_oracle],
                         ids=['device-cpu', 'oracle'])
def test_config1_card_list(new):
    want = _config1(jam, jam.init)
    got = _config1(tam, new)
    assert got == want
    assert want['inspect'] == {'cards': [
        {'title': 'Rewrite everything in JAX', 'done': True}]}


def _config2(am, DeviceBackend, general, general_backend, Options, **dev):
    changes = text_writer_changes(am, TEXT_CHARS)
    _, oracle = am.Backend.apply_changes(am.Backend.init(), changes)
    routes = {}
    for route, thr in (('per-doc', None), ('bulk', 50)):
        state, patch = DeviceBackend.apply_changes(
            DeviceBackend.init(**dev), changes,
            options=Options(bulk_route_min_ops=thr))
        assert isinstance(state, general_backend.GeneralBackendState) == \
            (route == 'bulk')
        routes[route] = list(patch['diffs'])
    store = general.init_store(1, **dev)
    routes['block'] = list(general.apply_general_block(
        store, store.encode_changes([changes])).diffs(0))
    return changes, routes, text_through_frontend(am, oracle['diffs'])


def test_config2_three_writers_text():
    j_changes, j_routes, j_text = _config2(
        jam, JDeviceBackend, jgeneral, jgeneral_backend, JOptions)
    t_changes, t_routes, t_text = _config2(
        tam, TDeviceBackend, tgeneral, tgeneral_backend, TOptions,
        device='cpu')
    assert t_changes == j_changes
    assert sum(len(c['ops']) for c in t_changes) >= 2 * TEXT_CHARS
    assert t_text == j_text and len(t_text) == TEXT_CHARS
    assert sorted(set(t_text)) == ['a', 'b', 'c']
    for route in ('per-doc', 'bulk', 'block'):
        assert t_routes[route] == j_routes[route], route
        assert text_through_frontend(tam, t_routes[route]) == t_text, route
        assert text_through_frontend(jam, j_routes[route]) == j_text, route


def _views(ds):
    return {i: doc_view(ds.get_doc(i)) for i in ds.doc_ids}


def test_config3_eager_exchange():
    logs, copies = [], []
    for am, new in ((jam, jam.init), (tam, _tam_cpu)):
        src = docset_source(am, new, 8)
        dst = am.DocSet()
        logs.append(sync_round(src, dst, am.Connection))
        copies.append(_views(dst))
        assert copies[-1] == _views(src)
    assert logs[1] == logs[0]
    assert len(logs[0]) == 32
    assert copies[1] == copies[0]


@pytest.mark.parametrize('line', ['dense', 'general'])
def test_config3_batched_lines(line):
    n = 16
    rich = line == 'general'
    out = []
    for am, new, batching, make in (
            (jam, jam.init, JBatching,
             lambda: JDense(n, key_capacity=8, actor_capacity=4)
             if line == 'dense' else JGeneral(n)),
            (tam, _tam_cpu, TBatching,
             lambda: TDense(n, key_capacity=8, actor_capacity=4,
                            device='cpu')
             if line == 'dense' else TGeneral(n, device='cpu'))):
        src = docset_source(am, new, n, rich=rich)
        dst = make()
        log = sync_round(src, dst, am.Connection, batching)
        docs = {f'doc{i}': dst.materialize(f'doc{i}') for i in range(n)}
        assert docs == {i: am.inspect(src.get_doc(i)) for i in src.doc_ids}
        out.append((log, docs))
    assert out[1] == out[0]
    if rich:
        assert out[1][1][f'doc{n - 1}'] == {
            'title': f'doc {n - 1}', 'meta': {'v': n - 1},
            'items': [1, 2, n - 1], 'text': 'hey'}


# ---- the codec loader (native._wire_load) ----------------------------------

@pytest.fixture
def loader(monkeypatch, tmp_path):
    """The codec loader with its once-only flags reset (restored after):
    ``_native/`` and the per-user cache (``XDG_CACHE_HOME``) both lie
    under a regular file, where no directory can be made, whoever runs
    the test."""
    blocker = tmp_path / 'not-a-dir'
    blocker.write_text('')
    monkeypatch.setattr(tnative, '_WIRE_SO_PATH',
                        str(blocker / '_native' / 'libamwire.so'))
    monkeypatch.setenv('XDG_CACHE_HOME', str(blocker / 'cache'))
    monkeypatch.delenv('AUTOMERGE_TPU_NATIVE', raising=False)
    for flag in ('_WIRE', '_STAGE', '_VIEW', '_EMIT', '_COLUMNAR'):
        monkeypatch.setattr(tnative, f'{flag}_LIB', None)
        monkeypatch.setattr(tnative, f'{flag}_ATTEMPTED', False)
    monkeypatch.setattr(twire, '_LIB', None)
    monkeypatch.setattr(twire, '_LOAD_ATTEMPTED', False)
    return tmp_path


def _tiny_so(path):
    """A shared library exporting ``amtest() == 7`` (not the codec)."""
    src = path.with_suffix('.c')
    src.write_text('extern "C" int amtest(void) { return 7; }\n')
    subprocess.run(['g++', '-shared', '-fPIC', '-x', 'c++', str(src), '-o',
                    str(path)], check=True, capture_output=True, timeout=60)


def test_codec_cache_path_is_the_ports_own():
    path = tnative._wire_cache_so_path()
    assert os.sep + 'automerge_tpu_torch' + os.sep in path
    assert os.path.basename(path).startswith('libamwire-')
    assert len(os.path.basename(path)) == len('libamwire-') + 16 + 3


def test_codec_loader_falls_back_to_the_python_parser(loader):
    per_doc = [text_writer_changes(tam, 12)]
    data = json.dumps(per_doc).encode()
    with pytest.warns(RuntimeWarning, match='pure-Python parser'):
        block = twire.parse_general_block(data)
    assert tnative._wire_load() is None
    assert not twire.available() and tnative.columnar_lib() is None
    assert block.to_changes() == per_doc
    # a v3 message, emitted and parsed by the Python codec
    container = _container(twire, block, 3)
    assert container[:4] == twire.COLUMNAR_MAGIC_V3
    assert twire.parse_columnar_block(container).to_changes() == per_doc
    assert twire.parse_change_block(json.dumps(
        [[{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'set', 'obj': tam.ROOT_ID, 'key': 'k',
             'value': 1}]}]])).to_changes()[0][0]['ops'][0]['value'] == 1


def test_codec_loader_loads_a_fresh_cached_binary(loader, monkeypatch):
    assert tnative._wire_cache_so_path().startswith(
        str(loader / 'not-a-dir'))
    # a cache home that can be written, holding a binary newer than the
    # source: loaded as it is, with no rebuild and no warning
    monkeypatch.setenv('XDG_CACHE_HOME', str(loader / 'cache'))
    cached = pathlib.Path(tnative._wire_cache_so_path())
    cached.parent.mkdir(parents=True)
    _tiny_so(cached)
    src_mtime = os.path.getmtime(tnative._WIRE_SRC_PATH)
    os.utime(cached, (src_mtime + 10, src_mtime + 10))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        lib = tnative._wire_load()
    assert lib is not None and lib.amtest() == 7


def test_codec_loader_loads_a_stale_binary_with_a_warning(loader,
                                                          monkeypatch):
    native_dir = loader / '_native'
    native_dir.mkdir()
    so_path = native_dir / 'libamwire.so'
    _tiny_so(so_path)
    # a source newer than the binary that does not compile: no candidate
    # can be rebuilt (the cache lies under a file)
    src = loader / 'wire_codec.cpp'
    src.write_text('this is not C++\n')
    mtime = os.path.getmtime(so_path)
    os.utime(src, (mtime + 10, mtime + 10))
    monkeypatch.setattr(tnative, '_WIRE_SRC_PATH', str(src))
    monkeypatch.setattr(tnative, '_WIRE_SO_PATH', str(so_path))
    with pytest.warns(RuntimeWarning, match='stale binary'):
        lib = tnative._wire_load()
    assert lib is not None and lib.amtest() == 7
    # it lacks the codec's entry points: parsing falls back, with a
    # warning, and still works
    with pytest.warns(RuntimeWarning, match='pure-Python parser'):
        assert not twire.available()
    per_doc = [text_writer_changes(tam, 6)]
    assert twire.parse_general_block(json.dumps(per_doc)).to_changes() == \
        per_doc
