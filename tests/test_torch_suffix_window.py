"""The suffix window of the incremental index update: the PyTorch port
(``device='cpu'``) against the JAX package on the same blocks.

The port of the reference's ``tests/test_suffix_window.py`` parity and
gating cases. A warm chain-shaped sequence taking an append-only tick
renumbers only the [ws, n) suffix of its plane (``_apply_window``
rewrites the host wire before it crosses as one copy); mid-chain
inserts, branched tails and cold objects decline to the whole-plane
renumber. Each case runs both packages at the same ``_WINDOW_MODE``
and requires exact equality, dtypes included, after every apply: the
patches, entry fields and state digest, the resident mirror (every word
plane and 'tp'), the ``_STAGE_CAPTURE`` record (with the window's
``m_pad``) and the per-apply counters; and the windowed arm must end in
the same store state as the whole-plane arm (``'off'``).
"""

import numpy as np
import pytest
import torch

from automerge_tpu import native as jnative
from automerge_tpu.common import ROOT_ID
from automerge_tpu.device import general as jg
from automerge_tpu.utils.metrics import metrics as jm
from automerge_tpu_torch import native as tnative
from automerge_tpu_torch.device import general as tg
from automerge_tpu_torch.utils.metrics import metrics as tm

torch.set_num_threads(1)

OBJ = '00000000-0000-4000-8000-000000000516'
KEYS = ('device_idx_incremental_applies', 'device_idx_rebuild_applies',
        'device_idx_window_applies', 'device_idx_invalidations',
        'device_idx_delta_nodes', 'general_mirror_converts')


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


class _Stores:
    """One general store per package at the same ``_WINDOW_MODE``;
    :meth:`apply` runs one block of changes through both and compares
    everything listed in the module docstring."""

    def __init__(self, window=None):
        self.window = window
        self.j = jg.init_store(1)
        self.t = tg.init_store(1, device='cpu')
        self.counts = {k: 0 for k in KEYS}

    def apply(self, changes):
        caps = {'j': [], 't': []}
        base = ({k: jm.counters.get(k, 0) for k in KEYS},
                {k: tm.counters.get(k, 0) for k in KEYS})
        saved = (jg._STAGE_CAPTURE, tg._STAGE_CAPTURE, jg._WINDOW_MODE,
                 tg._WINDOW_MODE)
        jg._STAGE_CAPTURE, tg._STAGE_CAPTURE = caps['j'].append, \
            caps['t'].append
        jg._WINDOW_MODE = tg._WINDOW_MODE = self.window
        try:
            jp = jg.apply_general_block(self.j,
                                        self.j.encode_changes([changes]))
            tp = tg.apply_general_block(self.t,
                                        self.t.encode_changes([changes]))
        finally:
            (jg._STAGE_CAPTURE, tg._STAGE_CAPTURE, jg._WINDOW_MODE,
             tg._WINDOW_MODE) = saved
        assert jp.to_patches() == tp.to_patches()
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
        assert self.j.doc_fields(0) == self.t.doc_fields(0)
        assert self.j.digest_of(0) == self.t.digest_of(0)
        jmir, tmir = self.j.pool.mirror, self.t.pool.mirror
        assert set(jmir) == set(tmir)
        for k in jmir:
            _same(jmir[k], tmir[k], f'mirror {k}')
        return delta[1]


def _same_state(a, b):
    """Two port stores (windowed and whole-plane arms) hold the same
    document, visibility, order and index."""
    assert a.doc_fields(0) == b.doc_fields(0)
    a.pool.sync()
    b.pool.sync()
    assert np.array_equal(a.pool.visible, b.pool.visible)
    assert np.array_equal(a.pool.vis_index, b.pool.vis_index)
    n = a.pool.mirror['n']
    assert np.array_equal(a.pool.mirror['tp'][:n].numpy(),
                          b.pool.mirror['tp'][:n].numpy())


def _typing_wave(actor, seq, prev, elems):
    ops = []
    for e in elems:
        ops.append({'action': 'ins', 'obj': OBJ, 'key': prev, 'elem': e})
        ops.append({'action': 'set', 'obj': OBJ, 'key': f'{actor}:{e}',
                    'value': 'x'})
        prev = f'{actor}:{e}'
    return [{'actor': actor, 'seq': seq, 'deps': {}, 'ops': ops}], prev


def _seed(window, n_chars=48, elem0=1):
    both = _Stores(window)
    ops = [{'action': 'makeText', 'obj': OBJ},
           {'action': 'link', 'obj': ROOT_ID, 'key': 't', 'value': OBJ}]
    prev = '_head'
    for e in range(elem0, elem0 + n_chars):
        ops.append({'action': 'ins', 'obj': OBJ, 'key': prev, 'elem': e})
        ops.append({'action': 'set', 'obj': OBJ, 'key': f'w:{e}',
                    'value': 'x'})
        prev = f'w:{e}'
    both.apply([{'actor': 'w', 'seq': 1, 'deps': {}, 'ops': ops}])
    return both, prev


class TestWindowParity:
    @pytest.mark.parametrize('force_native', [False, True])
    def test_end_typing_windows_and_matches_full(self, force_native,
                                                 monkeypatch):
        """Warm end-of-document typing: every tick after the seed takes
        the window ('require' raises otherwise), in both packages, and
        the store ends equal to the whole-plane arm's."""
        if force_native and not (tnative.stage_available()
                                 and jnative.stage_available()):
            pytest.skip('the native stager did not build here')
        monkeypatch.setattr(jg, '_NATIVE_STAGING', force_native)
        monkeypatch.setattr(tg, '_NATIVE_STAGING', force_native)
        arms = {}
        for mode in ('require', 'off'):
            both, prev = _seed(None)
            both.window = mode
            for k in range(8):
                wave, prev = _typing_wave('w', 2 + k, prev,
                                          range(100 + 2 * k, 102 + 2 * k))
                d = both.apply(wave)
                assert d['device_idx_window_applies'] == (mode == 'require')
                assert d['device_idx_incremental_applies'] == 1
            arms[mode] = both.t
        _same_state(arms['require'], arms['off'])

    def test_window_state_equals_off_arm_blockwise(self):
        arms = {}
        for mode in (None, 'off'):
            both, prev = _seed(mode)
            for k in range(6):
                wave, prev = _typing_wave('w', 2 + k, prev,
                                          range(100 + 4 * k, 104 + 4 * k))
                both.apply(wave)
            arms[mode] = both.t
        _same_state(arms[None], arms['off'])

    @pytest.mark.parametrize('force_native', [False, True])
    def test_wide_end_typing_windows(self, force_native, monkeypatch):
        """A text whose elem counters sit past the packed bound lives on
        the wide mirror from its first apply; warm end typing windows
        there too (the wire assembled by numpy and by the native stager),
        and equals the whole-plane arm."""
        if force_native and not (tnative.stage_available()
                                 and jnative.stage_available()):
            pytest.skip('the native stager did not build here')
        monkeypatch.setattr(jg, '_NATIVE_STAGING', force_native)
        monkeypatch.setattr(tg, '_NATIVE_STAGING', force_native)
        arms = {}
        for mode in ('require', 'off'):
            both, prev = _seed(None, n_chars=40, elem0=40000)
            assert both.t.pool.mirror['fmt'] == 'wide'
            both.window = mode
            seq = 2
            for k in range(4):
                wave, prev = _typing_wave('w', seq, prev,
                                          range(50000 + 3 * k,
                                                50003 + 3 * k))
                if k == 2:           # a backspace inside the window
                    wave[0]['ops'].append({'action': 'del', 'obj': OBJ,
                                           'key': 'w:50001'})
                both.apply(wave)
                seq += 1
            assert both.counts['device_idx_window_applies'] == \
                (4 if mode == 'require' else 0)
            arms[mode] = both.t
        _same_state(arms['require'], arms['off'])

    def test_mid_insert_breaks_linearity_and_still_matches(self):
        arms = {}
        for mode in (None, 'off'):
            both, prev = _seed(mode, n_chars=24)
            both.apply([{'actor': 'm', 'seq': 1, 'deps': {}, 'ops': [
                {'action': 'ins', 'obj': OBJ, 'key': 'w:3', 'elem': 900},
                {'action': 'set', 'obj': OBJ, 'key': 'm:900',
                 'value': 'M'}]}])
            # the object left idx_linear for good: tail appends decline
            wave, _ = _typing_wave('w', 2, prev, [800, 801])
            d = both.apply(wave)
            assert d['device_idx_window_applies'] == 0
            row = both.t.obj_uuid.index(OBJ)
            assert not both.t.pool.idx_linear[row]
            arms[mode] = both.t
        _same_state(arms[None], arms['off'])

    def test_concurrent_tail_appends_window_parity(self):
        arms = {}
        for mode in (None, 'off'):
            both, prev = _seed(mode, n_chars=32)
            both.apply([
                {'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
                    {'action': 'ins', 'obj': OBJ, 'key': prev,
                     'elem': 500},
                    {'action': 'set', 'obj': OBJ, 'key': 'a:500',
                     'value': 'A'}]},
                {'actor': 'b', 'seq': 1, 'deps': {}, 'ops': [
                    {'action': 'ins', 'obj': OBJ, 'key': prev,
                     'elem': 600},
                    {'action': 'set', 'obj': OBJ, 'key': 'b:600',
                     'value': 'B'}]}])
            wave, _ = _typing_wave('a', 2, 'b:600', [501, 502])
            both.apply(wave)
            arms[mode] = both.t
        _same_state(arms[None], arms['off'])

    def test_require_raises_when_window_declines(self):
        both, prev = _seed(None, n_chars=24)
        both.apply([{'actor': 'm', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'ins', 'obj': OBJ, 'key': 'w:3', 'elem': 900},
            {'action': 'set', 'obj': OBJ, 'key': 'm:900', 'value': 'M'}]}])
        wave, _ = _typing_wave('w', 2, prev, [1000])
        for g, st in ((jg, both.j), (tg, both.t)):
            saved = g._WINDOW_MODE
            g._WINDOW_MODE = 'require'
            try:
                with pytest.raises(RuntimeError, match='window'):
                    g.apply_general_block(st, st.encode_changes([wave]))
            finally:
                g._WINDOW_MODE = saved
        # the rollback left both stores usable and equal
        both.apply(wave)
