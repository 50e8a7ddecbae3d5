"""The wire codec of the PyTorch port against the JAX package's.

Blocks of the same seeded changes are encoded by one package and parsed
by the other, for wire v1 (JSON blobs), v2 (columnar, tagged literal
table) and v3 (RLE columns, session string tables): the parsed
``ChangeBlock`` columns, tables and change dicts must be equal, and the
encoded bytes too. Both packages build the same ``native/wire_codec.cpp``
(the port into its own ``_native/``); the port's pure-Python parser and
emitter must give the native codec's bytes and blocks.
"""

import numpy as np
import pytest
import torch

from automerge_tpu import wire as jwire
from automerge_tpu.sync.general_doc_set import GeneralDocSet as JaxDocSet
from automerge_tpu_torch import native as tnative
from automerge_tpu_torch import wire as twire
from automerge_tpu_torch.sync.general_doc_set import GeneralDocSet

from chip_smoke import ROOT_ID

torch.set_num_threads(1)

_COLS = ('doc', 'actor', 'seq', 'dep_ptr', 'dep_actor', 'dep_seq',
         'op_ptr', 'action', 'key', 'obj', 'key_kind', 'key_elem', 'elem')


def seeded_docs(n_docs, seed):
    """Per-document change lists of the config-5 shape, small: a list and
    a text from one actor, a root map write (nested value, float, bool,
    null, a delete) from a second that depends on it, and a concurrent
    same-key set from a third."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_docs):
        lst = f'00000000-0000-4000-8000-{d:012x}'
        txt = f'00000000-0000-4000-8000-{d + 4096:012x}'
        n = int(rng.integers(1, 6))
        ops = [{'action': 'makeList', 'obj': lst},
               {'action': 'link', 'obj': ROOT_ID, 'key': 'items',
                'value': lst},
               {'action': 'ins', 'obj': lst, 'key': '_head', 'elem': 1}]
        for i in range(2, n + 1):
            ops.append({'action': 'ins', 'obj': lst,
                        'key': f'w0-{d}:{i - 1}', 'elem': i})
        for i in range(1, n + 1):
            ops.append({'action': 'set', 'obj': lst, 'key': f'w0-{d}:{i}',
                        'value': int(rng.integers(-1000, 1000))})
        ops += [{'action': 'makeText', 'obj': txt},
                {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
                 'value': txt},
                {'action': 'ins', 'obj': txt, 'key': '_head', 'elem': 1},
                {'action': 'set', 'obj': txt, 'key': f'w0-{d}:1',
                 'value': 'hé"\\'[d % 4]}]
        val = [{'v': d, 'tags': [d, None, True]}, d * 1.5, False, None,
               'str\n'][int(rng.integers(0, 5))]
        out.append([
            {'actor': f'w0-{d}', 'seq': 1, 'deps': {}, 'ops': ops},
            {'actor': f'w1-{d}', 'seq': 1, 'deps': {f'w0-{d}': 1},
             'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'meta',
                      'value': val},
                     {'action': 'del', 'obj': ROOT_ID, 'key': 'meta'}
                     if d % 3 == 0 else
                     {'action': 'set', 'obj': ROOT_ID, 'key': 'n',
                      'value': d}]},
            {'actor': f'w2-{d}', 'seq': 1, 'deps': {f'w0-{d}': 1},
             'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'n',
                      'value': -d}]}])
    return out


def _blocks(per_doc):
    cap = max(len(per_doc), 2)
    return (JaxDocSet(cap).store.encode_changes(per_doc),
            GeneralDocSet(cap, device='cpu').store.encode_changes(per_doc))


def _same_block(a, b):
    assert a.n_docs == b.n_docs and a.n_changes == b.n_changes
    for name in _COLS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert list(a.actors) == list(b.actors)
    assert list(a.keys) == list(b.keys)
    assert list(a.objs) == list(b.objs)
    assert [a.change_dict(c) for c in range(a.n_changes)] == \
        [b.change_dict(c) for c in range(b.n_changes)]


def _container(mod, block, version):
    rows = list(range(block.n_changes))
    enc = mod.encode_change_rows_columnar if version == 2 else \
        mod.encode_change_rows_columnar_v3
    spans, tab = mod.assemble_columnar_spans(enc(block, rows))
    per_doc = [[] for _ in range(block.n_docs)]
    for c, span in zip(rows, spans):
        per_doc[block.doc[c]].append((0, span))
    return mod.build_columnar_container([tab], per_doc, version=version)


def test_the_port_builds_its_own_codec():
    assert tnative.emit_available() and tnative.columnar_available()
    assert tnative.columnar_v3_available() and twire.available()
    assert '_native' in tnative._WIRE_SO_PATH
    assert 'automerge_tpu_torch' in tnative._WIRE_SO_PATH


@pytest.mark.parametrize('seed', [0, 1])
def test_v1_blobs_equal_and_parse_across(seed):
    jb, tb = _blocks(seeded_docs(5, seed))
    rows = list(range(jb.n_changes))
    blobs_j = jwire.encode_change_rows(jb, rows)
    blobs_t = twire.encode_change_rows(tb, rows)
    assert blobs_j == blobs_t
    data = b'[' + b','.join(
        b'[' + b','.join(blobs_t[c] for c in rows if tb.doc[c] == d) + b']'
        for d in range(tb.n_docs)) + b']'
    _same_block(jwire.parse_general_block(data),
                twire.parse_general_block(data))


@pytest.mark.parametrize('version', [2, 3])
@pytest.mark.parametrize('seed', [0, 1])
def test_columnar_encode_in_one_parse_in_the_other(version, seed):
    jb, tb = _blocks(seeded_docs(6, seed))
    data_j = _container(jwire, jb, version)
    data_t = _container(twire, tb, version)
    assert data_j == data_t
    # the port encodes, the JAX package parses, and the other way round
    _same_block(jwire.parse_columnar_block(data_t),
                twire.parse_columnar_block(data_t))
    _same_block(twire.parse_columnar_block(data_j), jb)
    assert twire.columnar_container_to_changes(data_j) == \
        jwire.columnar_container_to_changes(data_t)


@pytest.mark.parametrize('version', [2, 3])
def test_python_codec_matches_native(version, monkeypatch):
    _, tb = _blocks(seeded_docs(4, 2))
    native = _container(twire, tb, version)
    parsed = twire.parse_columnar_block(native)
    monkeypatch.setattr(twire, '_NATIVE_COLUMNAR', False)
    assert _container(twire, tb, version) == native
    _same_block(twire.parse_columnar_block(native), parsed)


def test_session_tables_across_packages():
    jb, tb = _blocks(seeded_docs(4, 3))
    rows = list(range(tb.n_changes))
    entries = twire.encode_change_rows_columnar_v3(tb, rows)
    assert entries == jwire.encode_change_rows_columnar_v3(jb, rows)
    for enc, dec in ((twire, jwire), (jwire, twire)):
        table = enc.SessionStringTable()
        spans, tab, used = enc.assemble_session_spans(entries, table)
        refs = dict(dec.decode_session_defs(tab))
        got = dec.decode_session_spans(b''.join(spans),
                                       [len(s) for s in spans], refs)
        assert got == [(body, tuple(lits)) for body, lits in entries]
        assert used == set(refs)
        # once acked, the literals ride as bare refs in both packages
        table.note_acked(used, used)
        spans2, tab2, _ = enc.assemble_session_spans(entries, table)
        assert dec.decode_session_defs(tab2) == []
        assert dec.decode_session_spans(
            b''.join(spans2), [len(s) for s in spans2], refs) == got


@pytest.mark.parametrize('val', [0, -7, 2 ** 40, 1.25, 'x', '', True,
                                 False, None, {'a': [1, None]}, [1, 'b']])
def test_tagged_literals_equal(val):
    raw = twire.encode_tagged_literal(val)
    assert raw == jwire.encode_tagged_literal(val)
    assert twire.decode_tagged_literal(raw) == val
