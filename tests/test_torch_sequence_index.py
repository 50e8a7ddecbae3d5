"""The incremental sequence index of the general engine: the PyTorch port
(``device='cpu'``) against the JAX package on the same changes.

The port of the reference's ``tests/test_sequence_index.py`` parity and
invalidation cases (``TestIncrementalParity``; the snapshot-resume cases
of ``TestInvalidationPaths`` — the state-absorb and eviction cases need
the compaction layer, which the port does not have yet). Every case
drives both packages' ``general_backend.apply_changes`` with the same
frontend changes, both at the default ``_INDEX_MODE=None`` and
``_WINDOW_MODE=None`` (or the same forced modes), and requires exact
equality, dtypes included, after every apply:

* the patch (diffs, clock) and the whole-document patch (the view);
* the state digest and the entry fields;
* the resident mirror: its format, every word plane and the persistent
  'tp' index plane;
* the ``_STAGE_CAPTURE`` record (staged planes, ``m_pad``, fused
  outputs);
* the per-apply counters (incremental, rebuild, window, invalidation,
  delta nodes, format conversions).

The wide format is forced with a huge ``elem`` counter, never with a
32k-node document.
"""

import numpy as np
import pytest
import torch

from automerge_tpu import backend as Backend
from automerge_tpu import frontend as Frontend
from automerge_tpu import native as jnative
from automerge_tpu.device import general as jg
from automerge_tpu.device import general_backend as jgb
from automerge_tpu.text import Text
from automerge_tpu.utils.metrics import metrics as jm
from automerge_tpu_torch import native as tnative
from automerge_tpu_torch.device import general as tg
from automerge_tpu_torch.device import general_backend as tgb
from automerge_tpu_torch.utils.metrics import metrics as tm

torch.set_num_threads(1)

KEYS = ('device_idx_incremental_applies', 'device_idx_rebuild_applies',
        'device_idx_window_applies', 'device_idx_invalidations',
        'device_idx_delta_nodes', 'general_mirror_converts',
        'general_mirror_convert_packed_to_wide')


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return tuple(_host(y) for y in x)
    return np.asarray(x) if hasattr(x, 'dtype') else x


def _same(a, b, what):
    a, b = _host(a), _host(b)
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        assert np.array_equal(a, b), what
    else:
        assert a == b, (what, a, b)


def _same_mirror(jstore, tstore):
    jmir, tmir = jstore.pool.mirror, tstore.pool.mirror
    if jmir is None:
        assert tmir is None
        return
    assert set(jmir) == set(tmir)
    for k in jmir:
        _same(jmir[k], tmir[k], f'mirror {k}')


class _Both:
    """One general-backend token per package; :meth:`apply` runs the
    same changes through both and compares everything listed in the
    module docstring."""

    def __init__(self, jstate=None, tstate=None):
        self.j = jstate if jstate is not None else jgb.init()
        self.t = tstate if tstate is not None else tgb.init(device='cpu')
        self.counts = {k: 0 for k in KEYS}

    def apply(self, changes):
        caps = {}
        base = ({k: jm.counters.get(k, 0) for k in KEYS},
                {k: tm.counters.get(k, 0) for k in KEYS})
        saved = jg._STAGE_CAPTURE, tg._STAGE_CAPTURE
        jg._STAGE_CAPTURE = caps.setdefault('j', []).append
        tg._STAGE_CAPTURE = caps.setdefault('t', []).append
        try:
            self.j, jp = jgb.apply_changes(self.j, changes)
            self.t, tp = tgb.apply_changes(self.t, changes)
        finally:
            jg._STAGE_CAPTURE, tg._STAGE_CAPTURE = saved
        assert jp == tp
        delta = [{k: m.counters.get(k, 0) - b[k] for k in KEYS}
                 for m, b in ((jm, base[0]), (tm, base[1]))]
        assert delta[0] == delta[1], delta
        for k in KEYS:
            self.counts[k] += delta[1][k]
        assert len(caps['j']) == len(caps['t'])
        for jc, tc in zip(caps['j'], caps['t']):
            assert set(jc) == set(tc)
            for k in jc:
                _same(jc[k], tc[k], f'capture {k}')
        self.check()
        return tp

    def check(self):
        js, ts = self.j.store, self.t.store
        assert jgb.get_patch(self.j) == tgb.get_patch(self.t)
        assert js.digest_of(0) == ts.digest_of(0)
        assert js.doc_fields(0) == ts.doc_fields(0)
        _same_mirror(js, ts)


def _run(changes, per_change=True):
    both = _Both()
    for batch in ([c] for c in changes) if per_change else [changes]:
        both.apply(batch)
    return both


def _changes_of(doc, actor):
    return Backend.get_changes_for_actor(
        Frontend.get_backend_state(doc), actor)


def _fork(base_changes, actor, *edits):
    doc = Frontend.init({'backend': Backend})
    doc = Frontend.set_actor_id(doc, actor)
    if base_changes:
        state, patch = Backend.apply_changes(
            Frontend.get_backend_state(doc), base_changes)
        patch['state'] = state
        doc = Frontend.apply_patch(doc, patch)
    for e in edits:
        doc, _ = Frontend.change(doc, e)
    return _changes_of(doc, actor)


def _typing_changes(n=24, deletes=True):
    doc = Frontend.init({'backend': Backend})
    doc = Frontend.set_actor_id(doc, 'typist')
    doc, _ = Frontend.change(doc, lambda d: d.update({'text': Text()}))
    for i in range(n):
        doc, _ = Frontend.change(
            doc, lambda d, i=i: d['text'].insert_at(
                len(d['text']), chr(97 + i % 26)))
        if deletes and i % 7 == 6:
            doc, _ = Frontend.change(
                doc, lambda d: d['text'].delete_at(1))
    return _changes_of(doc, 'typist')


class _Modes:
    """Set ``_INDEX_MODE`` / ``_WINDOW_MODE`` on both packages."""

    def __init__(self, index=None, window=None):
        self.modes = {'_INDEX_MODE': index, '_WINDOW_MODE': window}

    def __enter__(self):
        self.saved = [(m, k, getattr(m, k)) for m in (jg, tg)
                      for k in self.modes]
        for m, k, _ in self.saved:
            setattr(m, k, self.modes[k])

    def __exit__(self, *exc):
        for m, k, v in self.saved:
            setattr(m, k, v)


class TestIncrementalParity:
    @pytest.mark.parametrize('force_native', [False, True])
    def test_sequential_typing(self, force_native, monkeypatch):
        if force_native and not (tnative.stage_available()
                                 and jnative.stage_available()):
            pytest.skip('the native stager did not build here')
        monkeypatch.setattr(jg, '_NATIVE_STAGING', force_native)
        monkeypatch.setattr(tg, '_NATIVE_STAGING', force_native)
        both = _run(_typing_changes())
        assert both.counts['device_idx_incremental_applies'] >= 10
        assert both.counts['device_idx_window_applies'] >= 1

    def test_concurrent_appends_and_deletes(self):
        base = _fork([], 'alice',
                     lambda d: d.update({'text': Text()}),
                     lambda d: d['text'].insert_at(0, *'hello'))
        a = _fork(base, 'alice',
                  lambda d: d['text'].insert_at(5, *' world'),
                  lambda d: d['text'].delete_at(0))
        b = _fork(base, 'bob',
                  lambda d: d['text'].insert_at(5, *'!!'),
                  lambda d: d['text'].insert_at(0, '>'))
        both = _run(base + a + b)
        assert both.counts['device_idx_incremental_applies'] >= 1

    def test_interleaved_delivery_schedules(self):
        import random
        base = _fork([], 'a1', lambda d: d.update({'list': [1, 2, 3]}))
        x = _fork(base, 'a2', lambda d: d['list'].insert_at(1, 'x'),
                  lambda d: d['list'].append('y'))
        y = _fork(base, 'a3', lambda d: d['list'].insert_at(3, 'z'),
                  lambda d: d['list'].delete_at(0))
        rng = random.Random(7)
        for _ in range(2):
            tail = x + y
            rng.shuffle(tail)
            _run(base + tail)

    def test_insert_after_concurrently_deleted_parent(self):
        base = _fork([], 'alice',
                     lambda d: d.update({'text': Text()}),
                     lambda d: d['text'].insert_at(0, *'abcdef'))
        a = _fork(base, 'alice', lambda d: d['text'].delete_at(2))
        b = _fork(base, 'bob', lambda d: d['text'].insert_at(3, 'X'))
        _run(base + a + b)
        _run(base + b + a)

    def test_mid_insert_falls_back_to_rebuild(self):
        base = _fork([], 'alice',
                     lambda d: d.update({'text': Text()}),
                     lambda d: d['text'].insert_at(0, *'abcdef'))
        b = _fork(base, 'bob', lambda d: d['text'].insert_at(3, 'X'))
        a2 = _fork(base, 'alice',
                   lambda d: d['text'].insert_at(6, *'123456'))
        both = _run(base + a2 + b)
        assert both.counts['device_idx_rebuild_applies'] >= 2
        assert both.counts['device_idx_invalidations'] >= 1

    @pytest.mark.parametrize('force_native', [False, True])
    def test_wide_format_incremental(self, force_native, monkeypatch):
        """The crossing and the wide incremental applies, with the wire
        assembled by numpy and by the native stager."""
        if force_native and not (tnative.stage_available()
                                 and jnative.stage_available()):
            pytest.skip('the native stager did not build here')
        monkeypatch.setattr(jg, '_NATIVE_STAGING', force_native)
        monkeypatch.setattr(tg, '_NATIVE_STAGING', force_native)
        changes = _typing_changes(n=12, deletes=False)
        obj = changes[1]['ops'][0]['obj']
        # a raw change with a huge elem counter forces the wide pick
        big = {'actor': 'typist', 'seq': len(changes) + 1, 'deps': {},
               'ops': [{'action': 'ins', 'obj': obj, 'key': '_head',
                        'elem': 40000},
                       {'action': 'set', 'obj': obj,
                        'key': 'typist:40000', 'value': 'W'}]}
        tail = [{'actor': 'typist', 'seq': len(changes) + 2 + k,
                 'deps': {},
                 'ops': [{'action': 'ins', 'obj': obj,
                          'key': f'typist:{40000 + k}',
                          'elem': 40001 + k},
                         {'action': 'set', 'obj': obj,
                          'key': f'typist:{40001 + k}', 'value': 'X'}]}
                for k in range(3)]
        both = _run(changes + [big] + tail)
        assert both.t.store.pool.mirror['fmt'] == 'wide'
        assert both.counts['general_mirror_convert_packed_to_wide'] == 1
        # the index survives the packed -> wide conversion: the tail
        # appends after the crossing still go incremental
        assert both.counts['device_idx_incremental_applies'] >= 3

    def test_wide_format_rebuild_arm(self):
        """The wide rebuild program (``_INDEX_MODE='rebuild'`` on both
        packages) across the same crossing."""
        changes = _typing_changes(n=6, deletes=False)
        obj = changes[1]['ops'][0]['obj']
        big = {'actor': 'typist', 'seq': len(changes) + 1, 'deps': {},
               'ops': [{'action': 'ins', 'obj': obj, 'key': 'typist:3',
                        'elem': 40000},
                       {'action': 'set', 'obj': obj,
                        'key': 'typist:40000', 'value': 'W'},
                       {'action': 'del', 'obj': obj, 'key': 'typist:2'}]}
        with _Modes(index='rebuild'):
            both = _run(changes + [big])
        assert both.t.store.pool.mirror['fmt'] == 'wide'
        assert both.counts['device_idx_incremental_applies'] == 0

    def test_cols_fallback_always_rebuilds(self, monkeypatch):
        for m in (jg, tg):
            monkeypatch.setattr(m, '_packed_mirror_guard',
                                lambda *a, **k: False)
            monkeypatch.setattr(m, '_wide_mirror_guard',
                                lambda *a, **k: False)
        both = _run(_typing_changes(n=8, deletes=False))
        st = both.t.store
        assert st.pool.mirror['fmt'] == 'cols'
        assert 'tp' not in st.pool.mirror
        assert not st.pool.idx_ok.any()
        assert both.counts['device_idx_incremental_applies'] == 0
        assert both.counts['device_idx_rebuild_applies'] > 0

    def test_idx_update_span_emitted(self):
        events = []
        tm.subscribe(events.append)
        try:
            _run(_typing_changes(n=6, deletes=False))
        finally:
            tm.unsubscribe(events.append)
        spans = [e for e in events if e.get('name') == 'device.idx_update']
        assert spans and all('dur_ms' in e for e in spans)

    def test_index_mode_require_raises_on_first_sight(self):
        changes = _typing_changes(n=2)[:2]
        with _Modes(index='require'):
            for gb, state in ((jgb, jgb.init()),
                              (tgb, tgb.init(device='cpu'))):
                with pytest.raises(RuntimeError, match='incremental'):
                    gb.apply_changes(state, changes)
        # the rollback left both stores usable
        _run(_typing_changes(n=2))

    def test_require_holds_on_warm_appends(self):
        changes = _typing_changes(n=8, deletes=False)
        both = _Both()
        both.apply(changes[:2])
        with _Modes(index='require'):
            for c in changes[2:]:
                both.apply([c])


def _append(changes, obj, key, elem, value, k=0):
    last = max(c['seq'] for c in changes)
    return {'actor': 'typist', 'seq': last + 1 + k, 'deps': {},
            'ops': [{'action': 'ins', 'obj': obj, 'key': key,
                     'elem': elem},
                    {'action': 'set', 'obj': obj,
                     'key': f'typist:{elem}', 'value': value}]}


class TestInvalidationPaths:
    def _resumed(self, data):
        return jg.GeneralStore.load_snapshot(data), \
            tg.GeneralStore.load_snapshot(data, device='cpu')

    def _apply_both(self, jst, tst, change):
        base = ({k: jm.counters.get(k, 0) for k in KEYS},
                {k: tm.counters.get(k, 0) for k in KEYS})
        jp = jg.apply_general_block(jst, jst.encode_changes([[change]]))
        tp = tg.apply_general_block(tst, tst.encode_changes([[change]]))
        assert jp.to_patches() == tp.to_patches()
        delta = [{k: m.counters.get(k, 0) - b[k] for k in KEYS}
                 for m, b in ((jm, base[0]), (tm, base[1]))]
        assert delta[0] == delta[1]
        assert jst.doc_fields(0) == tst.doc_fields(0)
        assert jst.digest_of(0) == tst.digest_of(0)
        _same_mirror(jst, tst)
        return delta[1]

    @pytest.mark.parametrize('wide', [False, True])
    def test_snapshot_resume_skips_rebuild(self, wide):
        """A snapshot (the JAX package's, and the port's own) resumes
        in both packages with the index claims intact: the next append
        goes straight to the incremental path, packed or wide."""
        changes = _typing_changes(n=10, deletes=False)
        obj = changes[1]['ops'][0]['obj']
        elem = 40000 if wide else 11000
        both = _run(changes)
        for data in (both.j.store.save_snapshot(),
                     both.t.store.save_snapshot()):
            jst, tst = self._resumed(data)
            assert tst.pool.idx_ok.any() and 'tp' in tst.pool.mirror
            _same_mirror(jst, tst)
            d = self._apply_both(jst, tst,
                                 _append(changes, obj, 'typist:10', elem,
                                         'Z'))
            assert d['device_idx_incremental_applies'] == 1
            assert tst.pool.mirror['fmt'] == ('wide' if wide else 'packed')
            if wide:
                # resume the wide store itself: it builds the wide
                # mirror directly, and the next append stays incremental
                jst2, tst2 = self._resumed(tst.save_snapshot())
                assert tst2.pool.mirror['fmt'] == 'wide'
                _same_mirror(jst2, tst2)
                d = self._apply_both(
                    jst2, tst2, _append(changes, obj, f'typist:{elem}',
                                        elem + 1, 'Y', k=1))
                assert d['device_idx_incremental_applies'] == 1

    def test_pre_index_resume_rebuilds_then_goes_incremental(self):
        changes = _typing_changes(n=6, deletes=False)
        both = _run(changes)
        both.j.store.pool.idx_ok[:] = False   # a pre-index snapshot's
        data = both.j.store.save_snapshot()   # claims
        jst, tst = self._resumed(data)
        assert not tst.pool.idx_ok.any()
        obj = changes[1]['ops'][0]['obj']
        for k in range(2):
            key = f'typist:{9000 + k - 1}' if k else 'typist:6'
            d = self._apply_both(jst, tst,
                                 _append(changes, obj, key, 9000 + k, 'q',
                                         k=k))
            which = 'device_idx_rebuild_applies' if k == 0 else \
                'device_idx_incremental_applies'
            assert d[which] == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card: python -m '
                    'pytest tests/test_torch_sequence_index.py -m cuda)')
    return torch.device('cuda')


def _port_run(changes, device):
    """The port alone on ``device``: per-change patches, per-apply
    counters, the final token."""
    state = tgb.init(device=device)
    out = []
    for c in changes:
        base = {k: tm.counters.get(k, 0) for k in KEYS}
        state, patch = tgb.apply_changes(state, [c])
        out.append((patch, {k: tm.counters.get(k, 0) - base[k]
                            for k in KEYS}))
    return state, out


def _cuda_schedules():
    changes = _typing_changes(n=12, deletes=False)
    obj = changes[1]['ops'][0]['obj']
    wide, key = list(changes), 'typist:12'
    for k in range(3):                   # past the packed elem bound
        wide.append(_append(changes, obj, key, 40000 + k, 'W', k=k))
        key = f'typist:{40000 + k}'
    base = _fork([], 'alice', lambda d: d.update({'text': Text()}),
                 lambda d: d['text'].insert_at(0, *'abcdef'))
    mid = base + _fork(base, 'alice',
                       lambda d: d['text'].insert_at(6, *'123456')) + \
        _fork(base, 'bob', lambda d: d['text'].insert_at(3, 'X'))
    return {'typing': _typing_changes(), 'wide': wide, 'mid-insert': mid}


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['typing', 'wide', 'mid-insert'])
def test_cuda_store_matches_cpu(cuda_device, name):
    """The same schedules on the card and on the CPU (the port alone):
    equal patches, per-apply counters (incremental, windowed, rebuilt,
    converted) and mirror planes — the incremental program, the window
    and the wide format through the card's kernels."""
    changes = _cuda_schedules()[name]
    cs, cout = _port_run(changes, 'cpu')
    gs, gout = _port_run(changes, cuda_device)
    assert cout == gout
    assert tgb.get_patch(cs) == tgb.get_patch(gs)
    cm, gm = cs.store.pool.mirror, gs.store.pool.mirror
    assert set(cm) == set(gm)
    for k in cm:
        a, b = cm[k], gm[k]
        if isinstance(b, torch.Tensor):
            assert b.device.type == 'cuda', k
            a, b = a.numpy(), b.cpu().numpy()
        _same(a, b, f'mirror {k}')
    if name == 'wide':
        assert gm['fmt'] == 'wide'
    incr = sum(d['device_idx_incremental_applies'] for _, d in gout)
    assert incr >= (1 if name == 'mid-insert' else 3)
