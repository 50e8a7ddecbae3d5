"""The general engine end to end: the PyTorch port (``device='cpu'``)
against the JAX package on the same changes.

* ``_STAGE_CAPTURE`` (a module hook in both packages) records every
  staged plane and the fused outputs (survivor bits, winners, vis
  planes) of each apply: they must be equal, dtypes included, on a
  packed-format store and on a cols-format store (more than 256 actor
  slots in one document forces cols). Both packages run the same
  ``_INDEX_MODE``: the rebuild arm (``'rebuild'``) and the default
  (``None``), where tick 2 takes the incremental index update.
* A 64-document tick 1 + tick 2 (the chip smoke's config-5 generators
  at a small size) through both ``GeneralDocSet``s, with the port's
  edit-stream read on and off: equal views, state digests and resident
  mirror words.
* ``general_backend.apply_changes`` patches of single documents.
* A snapshot saved by the JAX package after tick 1, loaded by the port,
  then tick 2 on both: equal views.
* A wide-format store: a text crossing the packed bound (a huge elem
  counter) in both doc sets, then the JAX package's snapshot of the
  wide store resumed by the port.
* The async apply: its patches equal the sync apply's, and a failing
  async apply rolls back while the store keeps serving.
* ``set_doc`` adopts a frontend document through its backend (the
  oracle when it names none), as the reference does.
* The patch read by document: on card lists and a text whose field rows
  interleave documents, every ``diffs(d)`` (and the async apply's)
  equals the JAX package's, an untouched document reads ``[]``, and the
  program's counters show one index a patch and one path a named object.
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
from automerge_tpu_torch.utils.metrics import metrics as tmetrics

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
    """Set both packages' ``_STAGE_CAPTURE`` hooks and the same
    ``_INDEX_MODE`` on both (restored after)."""

    def __init__(self, index_mode):
        self.jax, self.port = [], []
        self.index_mode = index_mode

    def __enter__(self):
        self._saved = (jg._STAGE_CAPTURE, jg._INDEX_MODE,
                       tg._STAGE_CAPTURE, tg._INDEX_MODE)
        jg._STAGE_CAPTURE = self.jax.append
        tg._STAGE_CAPTURE = self.port.append
        jg._INDEX_MODE = tg._INDEX_MODE = self.index_mode
        return self

    def __exit__(self, *exc):
        (jg._STAGE_CAPTURE, jg._INDEX_MODE, tg._STAGE_CAPTURE,
         tg._INDEX_MODE) = self._saved


def _ticks(ds, ticks, docs=range(N_DOCS)):
    for batch in ticks:
        ds.apply_changes_batch({IDS[d]: batch[d] for d in docs})


@pytest.fixture(scope='module')
def workload():
    return gen_mixed_docs(N_DOCS, LIST_OPS), gen_tick2(N_DOCS, LIST_OPS)


@pytest.fixture(scope='module', params=['rebuild', None])
def jax_fleet(workload, request):
    """The JAX package's run at one ``_INDEX_MODE``: captures, a
    snapshot after tick 1, and the final doc set."""
    tick1, tick2 = workload
    with _Capture(request.param) as cap:
        ds = JaxDocSet(N_DOCS)
        _ticks(ds, [tick1])
        snap = ds.save_snapshot()
        _ticks(ds, [tick2])
        views = ds.materialize_all()
    return {'ds': ds, 'captures': cap.jax, 'snapshot': snap,
            'views': views, 'index_mode': request.param}


@pytest.mark.parametrize('edit_stream', [False, True])
def test_docset_ticks_match_jax(workload, jax_fleet, edit_stream,
                                monkeypatch):
    monkeypatch.setattr(tg, '_EDIT_STREAM', edit_stream)
    tick1, tick2 = workload
    base = tmetrics.counters.get('device_idx_incremental_applies', 0)
    with _Capture(jax_fleet['index_mode']) as cap:
        ds = GeneralDocSet(N_DOCS, device='cpu')
        _ticks(ds, [tick1, tick2])
        # the patch read of the last tick, through the edit stream or
        # the host read path
        assert ds.last_patch.diffs(ds.id_of['doc3'])
    # tick 2 (a concurrent front insert) goes incremental by default
    incr = tmetrics.counters.get('device_idx_incremental_applies', 0) - base
    assert incr == (jax_fleet['index_mode'] is None)
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


def test_jax_snapshot_resumes_in_the_port(workload, jax_fleet,
                                          monkeypatch):
    monkeypatch.setattr(tg, '_INDEX_MODE', jax_fleet['index_mode'])
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
    with _Capture('rebuild') as cap:
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


def _wide_text_ticks():
    """Three ticks of one text document: 12 typed chars, then a char
    whose elem counter (40,000) is past the packed format's 15-bit bound
    (the store crosses packed -> wide), then typing after it with a
    delete."""
    obj = '00000000-0000-4000-8000-00000000beef'
    ops = [{'action': 'makeText', 'obj': obj},
           {'action': 'link', 'obj': ROOT_ID, 'key': 't', 'value': obj}]
    prev = '_head'
    for e in range(1, 13):
        ops += [{'action': 'ins', 'obj': obj, 'key': prev, 'elem': e},
                {'action': 'set', 'obj': obj, 'key': f'w:{e}',
                 'value': chr(96 + e)}]
        prev = f'w:{e}'
    big = [{'action': 'ins', 'obj': obj, 'key': prev, 'elem': 40000},
           {'action': 'set', 'obj': obj, 'key': 'w:40000', 'value': 'W'}]
    tail = [{'action': 'ins', 'obj': obj, 'key': 'w:40000',
             'elem': 40001},
            {'action': 'set', 'obj': obj, 'key': 'w:40001', 'value': 'X'},
            {'action': 'del', 'obj': obj, 'key': 'w:2'}]
    return [[{'actor': 'w', 'seq': s + 1, 'deps': {}, 'ops': o}]
            for s, o in enumerate((ops, big, tail))]


def test_wide_store_and_its_snapshot_match_jax():
    ticks = _wide_text_ticks()
    jds, tds = JaxDocSet(1), GeneralDocSet(1, device='cpu')
    for batch in ticks[:2]:
        jds.apply_changes('d', batch)
        tds.apply_changes('d', batch)
    jm, tmir = jds.store.pool.mirror, tds.store.pool.mirror
    assert jm['fmt'] == tmir['fmt'] == 'wide'
    for k in ('w1', 'w2', 'w3', 'tp', 'rank_table'):
        assert np.array_equal(np.asarray(jm[k]), tmir[k].numpy()), k
    assert jds.materialize_all() == tds.materialize_all()
    # the JAX package's snapshot of the wide store resumes in the port
    # on the wide mirror, and the next tick keeps both equal
    resumed = GeneralDocSet.load_snapshot(jds.save_snapshot(),
                                          device='cpu')
    assert resumed.store.pool.mirror['fmt'] == 'wide'
    for ds in (jds, tds, resumed):
        ds.apply_changes('d', ticks[2])
    view = jds.materialize_all()
    assert view['d']['t'] == 'acdefghijklWX'
    assert tds.materialize_all() == resumed.materialize_all() == view
    for d in (tds, resumed):
        assert d.store.digest_of(0) == jds.store.digest_of(0)


def test_async_apply_equals_sync_and_survives_errors():
    """apply_general_block_async over three blocks equals the sync
    apply (and the JAX package's); a failing async apply rolls back,
    surfaces on its own future only, and the store keeps serving."""
    n, k = 4, 3
    wide = n * k
    tick1 = gen_mixed_docs(wide, 8)
    blocks = []
    for i in range(k):
        per_doc = [tick1[d] if i * n <= d < (i + 1) * n else []
                   for d in range(wide)]
        blocks.append(per_doc)
    # each block is encoded up front (against a store of its own), so
    # no encode runs beside the applier thread
    enc = [tg.init_store(wide, device='cpu').encode_changes(b)
           for b in blocks]
    store = tg.init_store(wide, device='cpu')
    futs = [tg.apply_general_block_async(store, b) for b in enc]
    async_diffs = [[f.diffs(d) for d in range(i * n, (i + 1) * n)]
                   for i, f in enumerate(futs)]
    tg.drain_general(store)
    for s2, mod in ((tg.init_store(wide, device='cpu'), tg),
                    (jg.init_store(wide), jg)):
        sync_diffs = []
        for i, b in enumerate(blocks):
            p = mod.apply_general_block(s2, s2.encode_changes(b))
            sync_diffs.append([p.diffs(d)
                               for d in range(i * n, (i + 1) * n)])
        assert async_diffs == sync_diffs
        for d in range(wide):
            assert store.doc_fields(d) == s2.doc_fields(d)
    bad = store.encode_changes(
        [[{'actor': 'z', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'ins', 'obj': ROOT_ID, 'key': '_head',
             'elem': 1}]}]] + [[] for _ in range(wide - 1)])
    fut = tg.apply_general_block_async(store, bad)
    with pytest.raises(ValueError):
        fut.result()
    ok = tg.apply_general_block_async(store, store.encode_changes(
        [[{'actor': 'z', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'set', 'obj': ROOT_ID, 'key': 'ok',
             'value': True}]}]] + [[] for _ in range(wide - 1)]))
    ok.block_until_ready()
    tg.close_general(store)
    assert store.doc_fields(0)[(ROOT_ID, 'ok')] == [('z', True)]


def test_async_rollback_keeps_views_valid():
    ds = GeneralDocSet(2, device='cpu')
    ds.apply_changes('doc0', [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'x', 'value': 1}]}])
    t0 = ds.materialize('doc0')
    bad = ds.store.encode_changes([[
        {'actor': 'a', 'seq': 2, 'deps': {}, 'ops': [
            # duplicate creation: a validation error after admission
            {'action': 'makeMap',
             'obj': 'dddddddd-0000-4000-8000-000000000001'},
            {'action': 'makeMap',
             'obj': 'dddddddd-0000-4000-8000-000000000001'}]}]])
    fut = tg.apply_general_block_async(ds.store, bad)
    with pytest.raises(ValueError):
        fut.result()
    tg.drain_general(ds.store)
    assert ds.materialize('doc0') is t0
    ds.apply_changes('doc0', [{'actor': 'a', 'seq': 2, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'x', 'value': 2}]}])
    tg.close_general(ds.store)
    assert ds.materialize('doc0') == {'x': 2}


def test_set_doc_adopts_through_the_backend():
    """``set_doc`` replays a frontend document's changes through its
    backend (the host oracle when the document names none): an oracle
    document adopts, and one with no backend state fails as the JAX
    package's does."""
    from automerge_tpu import backend as JB
    from automerge_tpu import frontend as JF
    from automerge_tpu_torch import backend as TB
    from automerge_tpu_torch import frontend as TF
    errors = []
    for F, B, ds in ((JF, JB, JaxDocSet(2)),
                     (TF, TB, GeneralDocSet(2, device='cpu'))):
        doc = F.init({'backend': B})
        doc, _ = F.change(doc, lambda d: d.update({'x': 1}))
        ds.set_doc('a', doc)
        doc, _ = F.change(doc, lambda d: d.update({'y': 2}))
        ds.set_doc('a', doc)
        assert ds.materialize('a') == {'x': 1, 'y': 2}
        with pytest.raises(Exception) as err:
            ds.set_doc('b', F.init({'actorId': 'zz'}))
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]


def _uuid(d, k):
    return f'{d:08x}-0000-4000-8000-{k:012x}'


def _card_ops(d, lst, actor, elem, prev, k, title):
    """Insert card ``k`` (a map {title, done}) after ``prev`` in list
    ``lst`` of document ``d``."""
    card = _uuid(d, k)
    return [{'action': 'ins', 'obj': lst, 'key': prev, 'elem': elem},
            {'action': 'makeMap', 'obj': card},
            {'action': 'set', 'obj': card, 'key': 'title', 'value': title},
            {'action': 'set', 'obj': card, 'key': 'done', 'value': False},
            {'action': 'link', 'obj': lst, 'key': f'{actor}:{elem}',
             'value': card}]


CARD_LISTS, TEXT_DOC, N_CARD_DOCS = (0, 1, 2, 3), 4, 5


def _card_ticks():
    """Three ticks of five documents. Tick 1 loads card lists (three
    cards and a root key ``meta`` each) into docs 0-3 and a text into
    doc 4. Tick 2 leaves doc 2 alone; in docs 0, 1 and 3 two writers
    each insert a card, set the same title (a conflict), set and delete
    fields, delete a card and set ``meta``, and doc 4 gets a keystroke
    and a backspace: the tick's field rows interleave documents (new
    cards get object rows after every loaded one), and doc 3's text
    ``notes`` gets a keystroke too. Tick 3 only creates
    objects, so its patch has no device read."""
    t1, t2, t3 = ([[] for _ in range(N_CARD_DOCS)] for _ in range(3))
    for d in CARD_LISTS:
        lst = _uuid(d, 0)
        ops = [{'action': 'makeList', 'obj': lst},
               {'action': 'link', 'obj': ROOT_ID, 'key': 'cards',
                'value': lst},
               {'action': 'set', 'obj': ROOT_ID, 'key': 'meta', 'value': 0}]
        prev = '_head'
        for e in (1, 2, 3):
            ops += _card_ops(d, lst, 'a', e, prev, e, f'card {e}')
            prev = f'a:{e}'
        t1[d] = [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': ops}]
    txt = _uuid(TEXT_DOC, 0)
    ops = [{'action': 'makeText', 'obj': txt},
           {'action': 'link', 'obj': ROOT_ID, 'key': 't', 'value': txt}]
    prev = '_head'
    for e, ch in enumerate('hello', 1):
        ops += [{'action': 'ins', 'obj': txt, 'key': prev, 'elem': e},
                {'action': 'set', 'obj': txt, 'key': f'a:{e}', 'value': ch}]
        prev = f'a:{e}'
    t1[TEXT_DOC] = [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': ops}]
    notes = _uuid(3, 30)               # doc 3 holds a text beside its list
    t1[3][0]['ops'] += [
        {'action': 'makeText', 'obj': notes},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'notes', 'value': notes},
        {'action': 'ins', 'obj': notes, 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': notes, 'key': 'a:1', 'value': 'n'}]
    for d in (0, 1, 3):
        lst = _uuid(d, 0)
        b = _card_ops(d, lst, 'b', 4, 'a:1', 10, 'from b')
        b += [{'action': 'set', 'obj': _uuid(d, 2), 'key': 'title',
               'value': 'b2'},
              {'action': 'del', 'obj': lst, 'key': 'a:3'},
              {'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
               'value': d + 1}]
        c = _card_ops(d, lst, 'c', 4, '_head', 11, 'from c')
        c += [{'action': 'set', 'obj': _uuid(d, 2), 'key': 'title',
               'value': 'c2'},
              {'action': 'set', 'obj': _uuid(d, 1), 'key': 'done',
               'value': True},
              {'action': 'del', 'obj': _uuid(d, 1), 'key': 'title'}]
        t2[d] = [{'actor': 'b', 'seq': 1, 'deps': {'a': 1}, 'ops': b},
                 {'actor': 'c', 'seq': 1, 'deps': {'a': 1}, 'ops': c}]
    t2[3][0]['ops'] += [
        {'action': 'ins', 'obj': notes, 'key': 'a:1', 'elem': 5},
        {'action': 'set', 'obj': notes, 'key': 'b:5', 'value': 'o'}]
    t2[TEXT_DOC] = [{'actor': 'b', 'seq': 1, 'deps': {'a': 1}, 'ops': [
        {'action': 'ins', 'obj': txt, 'key': 'a:5', 'elem': 6},
        {'action': 'set', 'obj': txt, 'key': 'b:6', 'value': '!'},
        {'action': 'del', 'obj': txt, 'key': 'a:2'}]}]
    for d in (1, 3):
        t3[d] = [{'actor': 'z', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeMap', 'obj': _uuid(d, 20)}]}]
    return t1, t2, t3


def _counter(name):
    return tmetrics.counters.get(name, 0)


@pytest.mark.parametrize('edit_stream', [False, True])
def test_patch_read_by_document_matches_jax(edit_stream, monkeypatch):
    """Every document's diffs, each tick, equal the JAX package's list
    for list and in order; an untouched document reads ``[]``; two
    reads are equal but distinct; ``to_patches()`` is the per-document
    ``patch(d)``; the async apply reads the same."""
    monkeypatch.setattr(tg, '_EDIT_STREAM', edit_stream)
    jst = jg.init_store(N_CARD_DOCS)
    tst = tg.init_store(N_CARD_DOCS, device='cpu')
    astore = tg.init_store(N_CARD_DOCS, device='cpu')
    for i, batch in enumerate(_card_ticks()):
        jp = jg.apply_general_block(jst, jst.encode_changes(batch))
        tp = tg.apply_general_block(tst, tst.encode_changes(batch))
        # read before the next apply: paths follow the live store
        fut = tg.apply_general_block_async(
            astore, tg.init_store(N_CARD_DOCS, device='cpu')
            .encode_changes(batch))
        want = [jp.diffs(d) for d in range(N_CARD_DOCS)]
        assert [tp.diffs(d) for d in range(N_CARD_DOCS)] == want
        assert [fut.diffs(d) for d in range(N_CARD_DOCS)] == want
        assert tp.to_patches() == \
            [tp.patch(d) for d in range(N_CARD_DOCS)] == jp.to_patches()
        for d in range(N_CARD_DOCS):
            if not batch[d]:
                assert tp.diffs(d) == [] == want[d]
        if i != 1:
            continue
        # tick 2: rows interleave documents, doc 2 is untouched, a read
        # is a fresh list every time
        assert (np.diff(tp.f_doc) < 0).any()
        assert [int(tst.obj_doc[o]) for o in tp.seq_edits] == \
            [0, 1, 3, 3, 4]
        assert want[2] == []
        first, again = tp.diffs(0), tp.diffs(0)
        assert first == again == want[0] and first is not again
        first[-1]['index'] = -1
        first.clear()
        assert again == tp.diffs(0) == want[0]
    # tick 3 only creates: its patch had no device read
    assert [c[0] for c in tp.creates] == [1, 3]
    assert not len(tp.f_doc)
    tg.close_general(astore)


def test_patch_read_costs_follow_the_document():
    """Counted, not timed: one by-document index per patch however many
    reads, and one path per object a document's diffs name, not one per
    field."""
    ticks = _card_ticks()
    store = tg.init_store(N_CARD_DOCS, device='cpu')
    for batch in ticks[:2]:
        patch = tg.apply_general_block(store, store.encode_changes(batch))
    builds = _counter('general_patch_index_builds')
    paths = _counter('general_patch_paths_resolved')
    diffs = patch.diffs(0)
    assert _counter('general_patch_index_builds') == builds + 1
    mine = (patch.f_doc == 0) & ~patch.f_kind
    objs = set(patch.f_obj[mine].tolist()) | {
        o for o in patch.seq_edits if store.obj_doc[o] == 0}
    assert len(objs) < int(mine.sum())        # objects with several fields
    assert _counter('general_patch_paths_resolved') == paths + len(objs)
    assert len({id(e['path']) for e in diffs if 'path' in e}) == len(objs)
    for d in range(N_CARD_DOCS):
        patch.diffs(d)
    patch.to_patches()
    assert _counter('general_patch_index_builds') == builds + 1
    assert patch.diffs(2) == []
    # an untouched document resolves no path
    paths = _counter('general_patch_paths_resolved')
    patch.diffs(2)
    assert _counter('general_patch_paths_resolved') == paths
    # a patch with no device read (tick 3 only creates) indexes once too
    made = tg.apply_general_block(store, store.encode_changes(ticks[2]))
    assert made.diffs(1) == [{'action': 'create', 'obj': _uuid(1, 20),
                              'type': 'map'}]
    made.to_patches()
    assert _counter('general_patch_index_builds') == builds + 2


@pytest.mark.cuda
def test_cuda_wide_resume_and_async_match_cpu():
    """On the card: the JAX package's snapshot of a wide store resumes on
    the wide mirror and keeps serving, and the async apply over the
    same ticks equals the CPU store's sync apply."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_general.py -m cuda)')
    ticks = _wide_text_ticks()
    jds = JaxDocSet(1)
    for batch in ticks[:2]:
        jds.apply_changes('d', batch)
    resumed = GeneralDocSet.load_snapshot(jds.save_snapshot(),
                                          device='cuda')
    mir = resumed.store.pool.mirror
    assert mir['fmt'] == 'wide' and mir['w3'].device.type == 'cuda'
    jds.apply_changes('d', ticks[2])
    resumed.apply_changes('d', ticks[2])
    assert resumed.materialize_all() == jds.materialize_all()
    blocks = [tg.init_store(1, device='cpu').encode_changes([t])
              for t in ticks]
    cpu = tg.init_store(1, device='cpu')
    want = [tg.apply_general_block(cpu, b).diffs(0) for b in blocks]
    card = tg.init_store(1, device='cuda')
    futs = [tg.apply_general_block_async(card, b) for b in blocks]
    tg.drain_general(card)
    assert [f.diffs(0) for f in futs] == want
    tg.close_general(card)
    assert card.doc_fields(0) == cpu.doc_fields(0)
