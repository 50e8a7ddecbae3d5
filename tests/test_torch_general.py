"""The general engine end to end: the PyTorch port (``device='cpu'``)
against the JAX package on the same changes.

* ``_STAGE_CAPTURE`` (a module hook in both packages) records every
  staged plane and the fused outputs (survivor bits, winners, vis
  planes) of each apply: they must be equal, dtypes included, on a
  packed-format store and on a cols-format store (more than 256 actor
  slots in one document forces cols). The JAX side runs its rebuild
  arm (``_INDEX_MODE='rebuild'``), the only arm this slice ports.
* A 64-document tick 1 + tick 2 (the chip smoke's config-5 generators
  at a small size) through both ``GeneralDocSet``s, with the port's
  edit-stream read on and off: equal views, state digests and resident
  mirror words.
* ``general_backend.apply_changes`` patches of single documents.
* A snapshot saved by the JAX package after tick 1, loaded by the port,
  then tick 2 on both: equal views.
"""

import numpy as np
import pytest
import torch

from automerge_tpu.device import general as jg
from automerge_tpu.device import general_backend as jgb
from automerge_tpu.sync.general_doc_set import GeneralDocSet as JaxDocSet
from automerge_tpu_torch.device import general as tg
from automerge_tpu_torch.device import general_backend as tgb
from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet

from chip_smoke import ROOT_ID, gen_mixed_docs, gen_tick2

torch.set_num_threads(1)

N_DOCS, LIST_OPS = 64, 48
IDS = [f'doc{d}' for d in range(N_DOCS)]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return tuple(_host(y) for y in x)
    return np.asarray(x) if hasattr(x, 'dtype') else x


def _same_capture(jcap, tcap):
    assert set(jcap) == set(tcap)
    for k in jcap:
        a, b = _host(jcap[k]), _host(tcap[k])
        if isinstance(a, tuple):
            assert len(a) == len(b), k
            pairs = zip(a, b)
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
                assert np.array_equal(x, y), k
            else:
                assert x == y, (k, x, y)


class _Capture:
    """Set both packages' ``_STAGE_CAPTURE`` hooks (restored after)."""

    def __init__(self):
        self.jax, self.port = [], []

    def __enter__(self):
        self._saved = (jg._STAGE_CAPTURE, jg._INDEX_MODE,
                       tg._STAGE_CAPTURE)
        jg._STAGE_CAPTURE = self.jax.append
        jg._INDEX_MODE = 'rebuild'
        tg._STAGE_CAPTURE = self.port.append
        return self

    def __exit__(self, *exc):
        jg._STAGE_CAPTURE, jg._INDEX_MODE, tg._STAGE_CAPTURE = self._saved


def _ticks(ds, ticks, docs=range(N_DOCS)):
    for batch in ticks:
        ds.apply_changes_batch({IDS[d]: batch[d] for d in docs})


@pytest.fixture(scope='module')
def workload():
    return gen_mixed_docs(N_DOCS, LIST_OPS), gen_tick2(N_DOCS, LIST_OPS)


@pytest.fixture(scope='module')
def jax_fleet(workload):
    """The JAX package's run: captures, a snapshot after tick 1, and
    the final doc set."""
    tick1, tick2 = workload
    with _Capture() as cap:
        ds = JaxDocSet(N_DOCS)
        _ticks(ds, [tick1])
        snap = ds.save_snapshot()
        _ticks(ds, [tick2])
        views = ds.materialize_all()
    return {'ds': ds, 'captures': cap.jax, 'snapshot': snap,
            'views': views}


@pytest.mark.parametrize('edit_stream', [False, True])
def test_docset_ticks_match_jax(workload, jax_fleet, edit_stream,
                                monkeypatch):
    monkeypatch.setattr(tg, '_EDIT_STREAM', edit_stream)
    tick1, tick2 = workload
    with _Capture() as cap:
        ds = GeneralDocSet(N_DOCS, device='cpu')
        _ticks(ds, [tick1, tick2])
        # the patch read of the last tick, through the edit stream or
        # the host read path
        assert ds.last_patch.diffs(ds.id_of['doc3'])
    assert len(cap.port) == len(jax_fleet['captures']) == 2
    for jcap, tcap in zip(jax_fleet['captures'], cap.port):
        assert tcap['variant'] == 'packed'
        _same_capture(jcap, tcap)
    assert ds.materialize_all() == jax_fleet['views']
    jstore, tstore = jax_fleet['ds'].store, ds.store
    for d in range(N_DOCS):
        assert jstore.digest_of(d) == tstore.digest_of(d)
    jm, tm = jstore.pool.mirror, tstore.pool.mirror
    assert tm['fmt'] == jm['fmt'] == 'packed' and tm['n'] == jm['n']
    for k in ('w1', 'w2', 'tp'):
        assert np.array_equal(np.asarray(jm[k]), tm[k].numpy()), k
    assert all(tm[k].device.type == 'cpu' for k in ('w1', 'w2', 'tp'))


@pytest.mark.parametrize('edit_stream', [None, False, True])
def test_cuda_store_always_takes_the_edit_stream(edit_stream, monkeypatch):
    """The switch picks a CPU store's read arm only; a CUDA store has
    no kernel-free read path, and asking for one raises."""
    monkeypatch.setattr(tg, '_EDIT_STREAM', edit_stream)
    assert tg._edit_stream_on(torch.device('cpu')) is bool(edit_stream)
    if edit_stream is False:
        with pytest.raises(ValueError, match='CUDA store'):
            tg._edit_stream_on(torch.device('cuda'))
    else:
        assert tg._edit_stream_on(torch.device('cuda')) is True


@pytest.mark.parametrize('edit_stream', [False, True])
def test_backend_patches_match_jax(workload, edit_stream, monkeypatch):
    monkeypatch.setattr(tg, '_EDIT_STREAM', edit_stream)
    tick1, tick2 = workload
    for d in (0, 7):
        js, ts = jgb.init(), tgb.init(device='cpu')
        for batch in (tick1, tick2):
            js, jp = jgb.apply_changes(js, batch[d])
            ts, tp = tgb.apply_changes(ts, batch[d])
            assert list(jp['diffs']) == list(tp['diffs'])
            assert {k: v for k, v in jp.items() if k != 'diffs'} == \
                {k: v for k, v in tp.items() if k != 'diffs'}
        assert jgb.get_patch(js) == tgb.get_patch(ts)


def test_jax_snapshot_resumes_in_the_port(workload, jax_fleet):
    _, tick2 = workload
    ds = GeneralDocSet.load_snapshot(jax_fleet['snapshot'], device='cpu')
    assert ds.store.pool.mirror['fmt'] == 'packed'
    assert ds.store.pool.mirror['w2'].device.type == 'cpu'
    _ticks(ds, [tick2])
    assert ds.materialize_all() == jax_fleet['views']


def _wide_actor_docs(n_actors, tick):
    """Two docs: doc 0 gathers ``n_actors`` concurrent actors (each
    inserts into one shared list and sets the same root key), doc 1 is
    an ordinary two-change doc. Tick 2 deletes and re-sets some of
    them."""
    lst = '00000000-0000-4000-8000-00000000cafe'
    doc0 = []
    if tick == 1:
        doc0.append({'actor': 'a000', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeList', 'obj': lst},
            {'action': 'link', 'obj': ROOT_ID, 'key': 'l', 'value': lst}]})
        for i in range(1, n_actors):
            a = f'a{i:03d}'
            doc0.append({'actor': a, 'seq': 1, 'deps': {'a000': 1},
                         'ops': [
                             {'action': 'ins', 'obj': lst, 'key': '_head',
                              'elem': i},
                             {'action': 'set', 'obj': lst, 'key': f'{a}:{i}',
                              'value': i},
                             {'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                              'value': i}]})
    else:
        deps = {f'a{i:03d}': 1 for i in range(n_actors)}
        ops = [{'action': 'del', 'obj': lst, 'key': f'a{i:03d}:{i}'}
               for i in range(1, n_actors, 7)]
        ops += [{'action': 'set', 'obj': lst, 'key': f'a{i:03d}:{i}',
                 'value': -i} for i in range(3, n_actors, 11)]
        ops.append({'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                    'value': 'final'})
        doc0.append({'actor': 'z', 'seq': 1, 'deps': deps, 'ops': ops})
    doc1 = gen_mixed_docs(1, 6)[0] if tick == 1 else \
        gen_tick2(1, 6, seed=3)[0]
    return [doc0, doc1]


@pytest.mark.parametrize('edit_stream', [False, True])
def test_cols_store_matches_jax(edit_stream, monkeypatch):
    """Store level, so the two packages' patches compare too: the cols
    program's staged planes and outputs, each tick's diffs (the port's
    read through the plain edit stream or the host path), the views."""
    monkeypatch.setattr(tg, '_EDIT_STREAM', edit_stream)
    n_actors = 300                     # > 256 actor slots: cols format
    ticks = [_wide_actor_docs(n_actors, 1), _wide_actor_docs(n_actors, 2)]
    with _Capture() as cap:
        jst = jg.init_store(2)
        tst = tg.init_store(2, device='cpu')
        for batch in ticks:
            jp = jg.apply_general_block(jst, jst.encode_changes(batch))
            tp = tg.apply_general_block(tst, tst.encode_changes(batch))
            for d in (0, 1):
                assert jp.diffs(d) == tp.diffs(d)
    assert [c['variant'] for c in cap.port] == ['cols', 'cols']
    for jcap, tcap in zip(cap.jax, cap.port):
        _same_capture(jcap, tcap)
    assert tst.pool.mirror['fmt'] == 'cols'
    for d in (0, 1):
        assert jst.doc_fields(d) == tst.doc_fields(d)
        assert jst.digest_of(d) == tst.digest_of(d)
    assert tst.doc_fields(0)[(ROOT_ID, 'k')] == [('z', 'final')]
