"""Native wire edge: JSON change batches -> ChangeBlock at C speed.

`ChangeBlock.from_changes` walks every change/op dict in Python — fine
for the compatibility edge, not for a million-op sync message. This
module binds `native/wire_codec.cpp`: one pass over the raw JSON bytes
produces the columnar block directly (interned actors/keys, CSR
deps/ops), and op values come back as BYTE SPANS decoded lazily on first
access (:class:`~automerge_tpu_torch.device.blocks.LazyValues`) — on the bulk
apply path values ride to the store without ever being parsed.

`parse_change_block(data)` accepts the JSON text of
``[[change, ...], ...]`` (one change list per document — exactly
``json.dumps(block.to_changes())``). Falls back to
``json.loads`` + ``from_changes`` when the native library is
unavailable.

The same library also exports the ``amst_*`` native STAGER (bound in
:mod:`automerge_tpu_torch.native`): the general engine feeds a parsed block
straight through C++ staging into the fused device program, so the
whole wire-bytes -> device-planes path runs without per-op Python
(``GeneralDocSet.apply_wire`` is the end-to-end edge).

The PyTorch port's copy of ``automerge_tpu/wire.py``: the codec
library is the port's own build (:func:`.native._wire_load`, into this
package's ``_native/``); the pure-Python parser and emitter are the
reference's.
"""

import ctypes
import json
import os
import warnings

import numpy as np

from .common import ROOT_ID
from .device.blocks import (
    ChangeBlock, LazyValues, _SET, _INS, _LINK,
    _GEN_ACTION_CODES, _KEY_STR, _KEY_ELEM, _KEY_HEAD, _KEY_NONE,
    _intern)

_LIB = None
_LOAD_ATTEMPTED = False

_i64 = ctypes.c_int64
_p32 = ctypes.POINTER(ctypes.c_int32)
_p64 = ctypes.POINTER(ctypes.c_int64)
_p8 = ctypes.POINTER(ctypes.c_int8)


def _bind(lib):
    lib.amwc_parse.argtypes = [ctypes.c_char_p, _i64]
    lib.amwc_parse.restype = ctypes.c_void_p
    lib.amwc_parse_general.argtypes = [ctypes.c_char_p, _i64,
                                       ctypes.c_char_p, _p64, _p32, _p8,
                                       _i64]
    lib.amwc_parse_general.restype = ctypes.c_void_p
    lib.amwc_error.argtypes = [ctypes.c_void_p]
    lib.amwc_error.restype = ctypes.c_char_p
    for name in ('amwc_n_docs', 'amwc_n_changes', 'amwc_n_ops',
                 'amwc_n_deps', 'amwc_n_values', 'amwc_n_actors',
                 'amwc_actors_bytes', 'amwc_n_keys', 'amwc_keys_bytes',
                 'amwc_dup_keys', 'amwc_n_objs', 'amwc_objs_bytes'):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = _i64
    for name in ('amwc_fill_actors', 'amwc_fill_keys', 'amwc_fill_objs'):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _p64]
        fn.restype = None
    lib.amwc_fill_changes.argtypes = [ctypes.c_void_p] + [_p32] * 5
    lib.amwc_fill_changes.restype = None
    lib.amwc_fill_deps.argtypes = [ctypes.c_void_p, _p32, _p32]
    lib.amwc_fill_deps.restype = None
    lib.amwc_fill_ops.argtypes = [ctypes.c_void_p, _p8, _p32, _p32]
    lib.amwc_fill_ops.restype = None
    lib.amwc_fill_ops_general.argtypes = [ctypes.c_void_p, _p32, _p8,
                                          _p32, _p32]
    lib.amwc_fill_ops_general.restype = None
    lib.amwc_fill_value_spans.argtypes = [ctypes.c_void_p, _p64, _p64]
    lib.amwc_fill_value_spans.restype = None
    lib.amwc_free.argtypes = [ctypes.c_void_p]
    lib.amwc_free.restype = None
    return lib


def _load():
    """The codec library bound for parsing, or None. It is the port's own
    build of ``native/wire_codec.cpp`` (:func:`..native._wire_load`, into
    this package's ``_native/`` or the per-user cache, a stale binary as
    a last resort); without it the pure-Python parser runs, with a
    warning."""
    global _LIB, _LOAD_ATTEMPTED
    if _LOAD_ATTEMPTED:
        return _LIB
    _LOAD_ATTEMPTED = True
    from . import native as _native
    lib = _native._wire_load()
    if lib is None:
        if os.environ.get('AUTOMERGE_TPU_NATIVE', '1') != '0':
            warnings.warn(
                'automerge_tpu_torch: native wire codec unavailable '
                '(compilation failed or no g++); falling back to the '
                'pure-Python parser. Set AUTOMERGE_TPU_NATIVE=0 to '
                'silence.', RuntimeWarning)
        return None
    try:
        _LIB = _bind(lib)
    except AttributeError:
        # a stale .so predating newer symbols: fall back as the warning
        # promises
        warnings.warn(
            'automerge_tpu_torch: the native wire codec lacks the parse '
            'entry points; falling back to the pure-Python parser.',
            RuntimeWarning)
        _LIB = None
    return _LIB


def available():
    return _load() is not None


def _ptr32(a):
    return a.ctypes.data_as(_p32)


def _table(lib, h, n_fn, bytes_fn, fill_fn):
    n = int(n_fn(h))
    nbytes = int(bytes_fn(h))
    buf = ctypes.create_string_buffer(max(nbytes, 1))
    offsets = np.empty(n + 1, np.int64)
    fill_fn(h, buf, offsets.ctypes.data_as(_p64))
    raw = buf.raw[:nbytes]
    return [raw[offsets[i]:offsets[i + 1]].decode('utf-8')
            for i in range(n)]


def _extract_block(lib, h, data, general, values_cls=LazyValues):
    err = lib.amwc_error(h)
    if err:
        raise ValueError('wire parse failed: ' + err.decode('utf-8'))
    n_docs = int(lib.amwc_n_docs(h))
    dup_keys = bool(lib.amwc_dup_keys(h))
    c = int(lib.amwc_n_changes(h))
    n_ops = int(lib.amwc_n_ops(h))
    n_deps = int(lib.amwc_n_deps(h))
    n_vals = int(lib.amwc_n_values(h))

    doc = np.empty(c, np.int32)
    actor = np.empty(c, np.int32)
    seq = np.empty(c, np.int32)
    dep_ptr = np.empty(c + 1, np.int32)
    op_ptr = np.empty(c + 1, np.int32)
    lib.amwc_fill_changes(h, _ptr32(doc), _ptr32(actor), _ptr32(seq),
                          _ptr32(dep_ptr), _ptr32(op_ptr))
    dep_actor = np.empty(n_deps, np.int32)
    dep_seq = np.empty(n_deps, np.int32)
    lib.amwc_fill_deps(h, _ptr32(dep_actor), _ptr32(dep_seq))
    action = np.empty(n_ops, np.int8)
    key = np.empty(n_ops, np.int32)
    value = np.empty(n_ops, np.int32)
    lib.amwc_fill_ops(h, action.ctypes.data_as(_p8), _ptr32(key),
                      _ptr32(value))
    starts = np.empty(n_vals, np.int64)
    ends = np.empty(n_vals, np.int64)
    lib.amwc_fill_value_spans(h, starts.ctypes.data_as(_p64),
                              ends.ctypes.data_as(_p64))

    actors = _table(lib, h, lib.amwc_n_actors, lib.amwc_actors_bytes,
                    lib.amwc_fill_actors)
    keys = _table(lib, h, lib.amwc_n_keys, lib.amwc_keys_bytes,
                  lib.amwc_fill_keys)
    extra = {}
    if general:
        obj = np.empty(n_ops, np.int32)
        key_kind = np.empty(n_ops, np.int8)
        key_elem = np.empty(n_ops, np.int32)
        elem = np.empty(n_ops, np.int32)
        lib.amwc_fill_ops_general(h, _ptr32(obj),
                                  key_kind.ctypes.data_as(_p8),
                                  _ptr32(key_elem), _ptr32(elem))
        extra = {'obj': obj, 'key_kind': key_kind, 'key_elem': key_elem,
                 'elem': elem,
                 'objs': _table(lib, h, lib.amwc_n_objs,
                                lib.amwc_objs_bytes, lib.amwc_fill_objs)}

    values = values_cls(data, starts, ends)
    return ChangeBlock(n_docs, doc, actor, seq, dep_ptr, dep_actor,
                       dep_seq, op_ptr, action, key, value, actors, keys,
                       values, dup_keys=dup_keys, **extra)


def parse_change_block(data):
    """Parse the JSON text of per-document change lists into a
    :class:`~automerge_tpu_torch.device.blocks.ChangeBlock` (native when the
    codec library is available)."""
    if isinstance(data, str):
        data = data.encode('utf-8')
    lib = _load()
    if lib is None:
        return ChangeBlock.from_changes(json.loads(data.decode('utf-8')))

    h = lib.amwc_parse(data, len(data))
    if not h:
        raise MemoryError('wire codec allocation failed')
    try:
        return _extract_block(lib, h, data, general=False)
    finally:
        lib.amwc_free(h)


def parse_general_block(data, store=None):
    """Parse the JSON text of per-document change lists with the FULL op
    schema (sequences, nested objects, links) into a general
    :class:`~automerge_tpu_torch.device.blocks.ChangeBlock`.

    Key kinds resolve against the object types of ``store`` (a
    :class:`~automerge_tpu_torch.device.general.GeneralStore`) plus objects
    created within the batch — exactly `store.encode_changes`, at C
    speed. Falls back to the Python edge when the codec is unavailable.
    """
    if isinstance(data, str):
        data = data.encode('utf-8')
    lib = _load()
    if lib is None:
        if store is None:
            from .device.general import GeneralStore
            per_doc = json.loads(data.decode('utf-8'))
            # a throwaway store that only encodes on the host (the
            # native parse needs no device either)
            return GeneralStore(len(per_doc),
                                device='cpu').encode_changes(per_doc)
        return store.encode_changes(json.loads(data.decode('utf-8')))

    if store is not None and hasattr(store, 'wire_obj_tables'):
        # cached marshalling (rebuilding the uuid blob per parse costs
        # O(objects) on every steady-state receive tick)
        blob, offsets, doc_arr, type_arr = store.wire_obj_tables()
        n_objs = len(store.obj_uuid)
    else:
        uuids = list(store.obj_uuid) if store is not None else []
        types = list(store.obj_type) if store is not None else []
        docs = list(store.obj_doc) if store is not None else []
        encoded = [u.encode('utf-8') for u in uuids]
        blob = b''.join(encoded)
        offsets = np.zeros(len(uuids) + 1, np.int64)
        if encoded:
            np.cumsum([len(e) for e in encoded], out=offsets[1:])
        type_arr = np.asarray(types, np.int8) if types else \
            np.zeros(1, np.int8)
        doc_arr = np.asarray(docs, np.int32) if docs else \
            np.zeros(1, np.int32)
        n_objs = len(uuids)

    h = lib.amwc_parse_general(
        data, len(data), blob, offsets.ctypes.data_as(_p64),
        doc_arr.ctypes.data_as(_p32), type_arr.ctypes.data_as(_p8),
        n_objs)
    if not h:
        raise MemoryError('wire codec allocation failed')
    try:
        return _extract_block(lib, h, data, general=True)
    finally:
        lib.amwc_free(h)


# ---------------------------------------------------------------------------
# Wire-blob EMIT: change rows of a retained ChangeBlock -> the compact
# canonical JSON bytes the codec parses (the encode side of the
# zero-re-encode sync tick). `parse_general_block(b'[[' + b','.join(
# encode_change_rows(block, rows)) + b']]')` round-trips to the same
# changes. The general-schema fast path is `amwe_emit_general` in
# native/wire_codec.cpp; the Python fallback below is byte-identical
# (both splice the SAME host-pre-escaped string/value literals, so
# parity is by construction — C++ only formats integers).

# force switch (tests/CI): None = auto, True = native emit must be used
# for general blocks (raise instead of falling back), False = numpy off
_NATIVE_EMIT = None


# one shared encoder: json.dumps builds a fresh JSONEncoder per call,
# which is ~40% of a 276k-value cold emit
_JSON_ENC = json.JSONEncoder(separators=(',', ':'),
                             ensure_ascii=False).encode


def _json_lit(v):
    """Canonical JSON literal bytes of one host value (compact
    separators, raw UTF-8)."""
    return _JSON_ENC(v).encode('utf-8')


def _block_lits(block):
    """Pre-escaped JSON string-literal tables (actors, keys, objs) of a
    block, built once and cached on the block — retained blocks are
    immutable and serve many peers. (``block._wire_lits`` is a dict so
    the native marshalling can cache its joined blob forms alongside.)
    """
    cache = block._wire_lits
    if cache is None:
        actors = [_json_lit(s) for s in block.actors]
        keys = [_json_lit(s) for s in block.keys]
        objs = [_json_lit(s) for s in block.objs] if block.is_general() \
            else [_json_lit(ROOT_ID)]
        cache = block._wire_lits = {'tables': (actors, keys, objs)}
    return cache['tables']


def _op_selection(block, rows_arr):
    """Vectorized op selection of change rows: ``(sel, use, v)`` — the
    selected op indexes, the value-bearing mask (set/link with a value
    row) and the value column over ``sel``. Computed ONCE per emit
    batch and shared by the value-literal build and the native
    marshalling."""
    from .device.blocks import _span_indices
    if not len(rows_arr) or not block.n_ops:
        z = np.zeros(0, np.int64)
        return z, np.zeros(0, bool), np.zeros(0, np.int32)
    op_ptr = block.op_ptr
    starts = op_ptr[rows_arr].astype(np.int64)
    counts = (op_ptr[rows_arr + 1] - op_ptr[rows_arr]).astype(np.int64)
    sel = _span_indices(starts, counts)
    act = block.action[sel]
    v = block.value[sel]
    use = ((act == _SET) | (act == _LINK)) & (v >= 0)
    return sel, use, v


def _value_lits(block, use, v):
    """{value row: literal bytes} for every value the selected ops
    reference (decoded host values re-encode canonically; spans of
    wire-ingested blocks decode lazily here, exactly once). Bulk value
    fetch and content-level dedup — op value tables are full of
    repeated scalars, and each distinct one should hit the JSON
    encoder once."""
    vids = np.unique(v[use]) if len(v) else np.zeros(0, np.int32)
    take = getattr(block.values, 'take', None)
    vals = take(vids) if take is not None \
        else [block.values[int(i)] for i in vids.tolist()]
    out = {}
    memo = {}
    for i, val in zip(vids.tolist(), vals):
        # memo keys pair the class with the value: bool IS an int and
        # 1 == 1.0, but 'true'/'1'/'1.0' are three different literals
        key = (val.__class__, val)
        try:
            blob = memo.get(key)
        except TypeError:                  # unhashable (dict/list)
            out[i] = _json_lit(val)
            continue
        if blob is None:
            blob = memo[key] = _json_lit(val)
        out[i] = blob
    return out


def _emit_change_py(block, c, lits, vlits):
    """One change row as canonical JSON bytes (the fallback emitter —
    keep byte-identical with amwe_emit_general)."""
    actors_l, keys_l, objs_l = lits
    p = [b'{"actor":', actors_l[block.actor[c]],
         b',"seq":', b'%d' % int(block.seq[c]), b',"deps":{']
    for i, j in enumerate(range(block.dep_ptr[c],
                                block.dep_ptr[c + 1])):
        if i:
            p.append(b',')
        p += [actors_l[block.dep_actor[j]], b':',
              b'%d' % int(block.dep_seq[j])]
    p.append(b'},"ops":[')
    general = block.is_general()
    for i, j in enumerate(range(block.op_ptr[c], block.op_ptr[c + 1])):
        if i:
            p.append(b',')
        a = int(block.action[j])
        if general:
            p += [b'{"action":"', _GEN_ACTION_CODES[a].encode(),
                  b'","obj":', objs_l[block.obj[j]]]
            kind = int(block.key_kind[j])
            if kind == _KEY_STR:
                p += [b',"key":', keys_l[block.key[j]]]
            elif kind == _KEY_ELEM:
                # "<actor>:<elem>" — splice the escaped actor literal
                # minus its closing quote (':' and digits are
                # escape-free)
                p += [b',"key":', actors_l[block.key[j]][:-1], b':',
                      b'%d' % int(block.key_elem[j]), b'"']
            elif kind == _KEY_HEAD:
                p.append(b',"key":"_head"')
            if a == _INS:
                p += [b',"elem":', b'%d' % int(block.elem[j])]
        else:
            p += [b'{"action":"', (b'set' if a == _SET else b'del'),
                  b'","obj":', objs_l[0],
                  b',"key":', keys_l[block.key[j]]]
        if a == _SET or (general and a == _LINK):
            p += [b',"value":', vlits.get(int(block.value[j]), b'null')]
        p.append(b'}')
    p.append(b']}')
    return b''.join(p)


def encode_change_rows(block, rows):
    """Encode change rows ``rows`` of ``block`` to their compact wire
    bytes — one ``bytes`` per row, native C++ for general blocks when
    the library is available, byte-identical Python fallback otherwise
    (always Python for flat root-map blocks — the wire protocol serves
    general stores). ``_NATIVE_EMIT = True`` raises instead of falling
    back (the CI forced-native lane)."""
    rows_arr = np.asarray([int(r) for r in rows], np.int64)
    lits = _block_lits(block)
    sel, use, v = _op_selection(block, rows_arr)
    vlits = _value_lits(block, use, v)
    if block.is_general() and _NATIVE_EMIT is not False:
        from . import native as _native
        out = _native.emit_change_rows(block, rows_arr, lits, vlits,
                                       sel, use, v)
        if out is not None:
            return out
        if _NATIVE_EMIT is True:
            raise RuntimeError(
                'native wire emit forced (_NATIVE_EMIT=True) but the '
                'library is unavailable')
    return [_emit_change_py(block, c, lits, vlits)
            for c in rows_arr.tolist()]


parseChangeBlock = parse_change_block
parseGeneralBlock = parse_general_block


# ---------------------------------------------------------------------------
# Columnar wire blob v2: the JSON-free binary change encoding (emit AND
# parse twins of the amwe_emit_columnar / amst_parse_columnar entry
# points in native/wire_codec.cpp — see the format comment there; the
# layout constants below are the single Python-side source of truth).
#
# A change's cached encoding is ``(body, lits)``: a varint/delta-packed
# column body referencing a LOCAL literal list, plus the tagged literal
# bytes themselves (first-occurrence order over actor, deps, then each
# op's obj/key/value). The per-peer message layer interns every change's
# literals into ONE shared table per message (`assemble_columnar_spans`)
# — an actor uuid referenced by a thousand changes ships once — and the
# receive side stitches the tick's messages into one container
# (`build_columnar_container`) that parses straight into a ChangeBlock
# with zero `json.loads` (`parse_columnar_block`). The native emitter
# returns bodies + global ref lists and the HOST maps refs to literal
# bytes, so the pure-Python emitter below is byte-identical by
# construction: same two-pass walk, same varints, same tables.

import struct as _struct

COLUMNAR_MAGIC = b'AMW2'
# v3 containers: same framing as AMW2, two column changes inside the
# change body — the action|key_kind byte column and the obj column are
# run-length encoded (see _emit_columnar_v3_py). The heavy literal
# dedup moved up a layer: v3 MESSAGES reference a per-connection
# session string table instead of re-shipping a per-message tab
# (SessionStringTable below), but by the time spans stitch into this
# container the receiver has already resolved session refs back to
# message-local form, so the container stays self-contained.
COLUMNAR_MAGIC_V3 = b'AMW3'

# literal tags (match native/wire_codec.cpp)
_TAG_STR, _TAG_INT, _TAG_FLOAT = 0, 1, 2
_TAG_TRUE, _TAG_FALSE, _TAG_NULL, _TAG_JSON = 3, 4, 5, 6

# force switch (tests/CI): None = auto, True = the native columnar
# codec must serve general blocks (raise instead of falling back),
# False = pure Python both directions
_NATIVE_COLUMNAR = None


def _uv(out, v):
    """Append one unsigned LEB128 varint."""
    while v >= 0x80:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    out.append(v)


def _sv(out, v):
    """Append one zigzag-signed varint."""
    _uv(out, (v << 1) if v >= 0 else ((-v << 1) - 1))


class _ColReader:
    """Bounds-checked varint reader over one bytes object (the Python
    twin of the C++ ColReader — same failure messages' spirit, always
    ValueError, never an IndexError escape)."""

    __slots__ = ('buf', 'pos', 'end')

    def __init__(self, buf, pos=0, end=None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def fail(self, msg):
        raise ValueError(
            f'columnar parse failed: {msg} at byte {self.pos}')

    def uv(self):
        v = 0
        shift = 0
        while self.pos < self.end:
            b = self.buf[self.pos]
            self.pos += 1
            if shift >= 63 and b > 1:
                self.fail('varint overflow')
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
        self.fail('truncated varint')

    def sv(self):
        u = self.uv()
        return (u >> 1) ^ -(u & 1)

    def u32(self, what):
        u = self.uv()
        if u > 0x7FFFFFFF:
            self.fail(what)
        return u


def encode_tagged_literal(val):
    """One host value as tagged literal bytes (tag + payload).
    Scalars get compact binary forms; dict/list composites fall back to
    canonical JSON, decoded lazily at materialize time — never on the
    apply path."""
    if val is None:
        return b'\x05'
    if val is True:
        return b'\x03'
    if val is False:
        return b'\x04'
    cls = val.__class__
    if cls is int:
        out = bytearray([_TAG_INT])
        _sv(out, val)
        return bytes(out)
    if cls is float:
        return b'\x02' + _struct.pack('<d', val)
    if cls is str:
        return b'\x00' + val.encode('utf-8')
    return b'\x06' + _json_lit(val)


def decode_tagged_literal(raw):
    """Tagged literal bytes -> host value (the TaggedValues decoder)."""
    tag = raw[0]
    if tag == _TAG_STR:
        return raw[1:].decode('utf-8')
    if tag == _TAG_INT:
        # host-side only, so arbitrary precision is fine (the 64-bit
        # overflow cap guards the container FRAMING varints, where
        # Python and C++ must agree; a value literal never crosses C)
        u = 0
        shift = 0
        for b in raw[1:]:
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (u >> 1) ^ -(u & 1)
    if tag == _TAG_FLOAT:
        return _struct.unpack('<d', raw[1:9])[0]
    if tag == _TAG_TRUE:
        return True
    if tag == _TAG_FALSE:
        return False
    if tag == _TAG_NULL:
        return None
    if tag == _TAG_JSON:
        return json.loads(raw[1:].decode('utf-8'))
    raise ValueError(f'unknown literal tag {tag}')


def _block_tagged_lits(block):
    """Tagged string-literal tables (actors, keys, objs) of a block,
    built once and cached alongside the JSON literals on
    ``block._wire_lits``."""
    cache = block._wire_lits
    if cache is None:
        _block_lits(block)                   # creates the dict
        cache = block._wire_lits
    tagged = cache.get('tagged')
    if tagged is None:
        tagged = cache['tagged'] = (
            [b'\x00' + s.encode('utf-8') for s in block.actors],
            [b'\x00' + s.encode('utf-8') for s in block.keys],
            [b'\x00' + s.encode('utf-8') for s in block.objs])
    return tagged


def _tagged_value_lits(block, use, v):
    """{value row: tagged literal bytes} for every value the selected
    ops reference — the v2 twin of :func:`_value_lits`, with the same
    content-level dedup."""
    vids = np.unique(v[use]) if len(v) else np.zeros(0, np.int32)
    take = getattr(block.values, 'take', None)
    vals = take(vids) if take is not None \
        else [block.values[int(i)] for i in vids.tolist()]
    out = {}
    memo = {}
    for i, val in zip(vids.tolist(), vals):
        key = (val.__class__, val)
        try:
            blob = memo.get(key)
        except TypeError:                  # unhashable (dict/list)
            out[i] = encode_tagged_literal(val)
            continue
        if blob is None:
            blob = memo[key] = encode_tagged_literal(val)
        out[i] = blob
    return out


# ref kinds of the per-change literal lists ((kind << 32) | index)
_REF_ACTOR, _REF_KEY, _REF_OBJ, _REF_VAL = 0, 1, 2, 3


def _emit_columnar_py(block, c):
    """One change row's ``(body, refs)`` — keep step-identical with
    amwe_emit_columnar (same two-pass ref walk, same varint columns)."""
    seen = {}
    refs = []

    def local(kind, idx):
        k = (kind << 32) | int(idx)
        i = seen.get(k)
        if i is None:
            i = seen[k] = len(refs)
            refs.append(k)
        return i

    action, obj, key_kind, key = block.action, block.obj, \
        block.key_kind, block.key
    ops = range(block.op_ptr[c], block.op_ptr[c + 1])
    # pass 1: canonical ref order (the change actor is always local 0)
    local(_REF_ACTOR, block.actor[c])
    for j in range(block.dep_ptr[c], block.dep_ptr[c + 1]):
        local(_REF_ACTOR, block.dep_actor[j])
    for j in ops:
        a = int(action[j])
        local(_REF_OBJ, obj[j])
        kk = int(key_kind[j])
        if kk == _KEY_STR:
            local(_REF_KEY, key[j])
        elif kk == _KEY_ELEM:
            local(_REF_ACTOR, key[j])
        if a in (_SET, _LINK) and block.value[j] >= 0:
            local(_REF_VAL, block.value[j])
    # pass 2: body columns
    o = bytearray()
    _uv(o, int(block.seq[c]))
    _uv(o, int(block.dep_ptr[c + 1] - block.dep_ptr[c]))
    for j in range(block.dep_ptr[c], block.dep_ptr[c + 1]):
        _uv(o, local(_REF_ACTOR, block.dep_actor[j]))
        _uv(o, int(block.dep_seq[j]))
    _uv(o, len(ops))
    for j in ops:
        o.append((int(key_kind[j]) << 4) | int(action[j]))
    prev = 0
    for j in ops:
        lo = local(_REF_OBJ, obj[j])
        _sv(o, lo - prev)
        prev = lo
    prev_e = 0
    for j in ops:
        kk = int(key_kind[j])
        if kk == _KEY_STR:
            _uv(o, local(_REF_KEY, key[j]))
        elif kk == _KEY_ELEM:
            _uv(o, local(_REF_ACTOR, key[j]))
            ke = int(block.key_elem[j])
            _sv(o, ke - prev_e)
            prev_e = ke
    prev_i = 0
    for j in ops:
        if int(action[j]) != _INS:
            continue
        el = int(block.elem[j])
        _sv(o, el - prev_i)
        prev_i = el
    for j in ops:
        a = int(action[j])
        if a not in (_SET, _LINK):
            continue
        vrow = int(block.value[j])
        _uv(o, local(_REF_VAL, vrow) + 1 if vrow >= 0 else 0)
    return bytes(o), refs


def _emit_columnar_v3_py(block, c):
    """One change row's v3 ``(body, refs)`` — keep step-identical with
    amwe_emit_columnar_v3. Same two-pass ref walk and varint columns as
    v2 except two columns run-length encode:

    - action column: ``{(key_kind<<4 | action) byte, uvarint extra}``
      pairs, each covering ``extra+1`` consecutive ops (a run of list
      inserts costs 2 bytes total, not 1 byte per op);
    - obj column: ``{svarint delta(obj_local), uvarint extra}`` runs —
      the delta base carries across runs exactly like v2's per-op
      deltas, so a single-object change costs 2 bytes.

    The greedy maximal-run choice is deterministic, which is what makes
    the Python and native emitters byte-identical by construction."""
    seen = {}
    refs = []

    def local(kind, idx):
        k = (kind << 32) | int(idx)
        i = seen.get(k)
        if i is None:
            i = seen[k] = len(refs)
            refs.append(k)
        return i

    action, obj, key_kind, key = block.action, block.obj, \
        block.key_kind, block.key
    ops = range(block.op_ptr[c], block.op_ptr[c + 1])
    # pass 1: canonical ref order — IDENTICAL to v2 (the session table
    # upstairs dedups by content, so ref order only needs determinism)
    local(_REF_ACTOR, block.actor[c])
    for j in range(block.dep_ptr[c], block.dep_ptr[c + 1]):
        local(_REF_ACTOR, block.dep_actor[j])
    for j in ops:
        a = int(action[j])
        local(_REF_OBJ, obj[j])
        kk = int(key_kind[j])
        if kk == _KEY_STR:
            local(_REF_KEY, key[j])
        elif kk == _KEY_ELEM:
            local(_REF_ACTOR, key[j])
        if a in (_SET, _LINK) and block.value[j] >= 0:
            local(_REF_VAL, block.value[j])
    # pass 2: body columns
    o = bytearray()
    _uv(o, int(block.seq[c]))
    _uv(o, int(block.dep_ptr[c + 1] - block.dep_ptr[c]))
    for j in range(block.dep_ptr[c], block.dep_ptr[c + 1]):
        _uv(o, local(_REF_ACTOR, block.dep_actor[j]))
        _uv(o, int(block.dep_seq[j]))
    _uv(o, len(ops))
    run_b, run_n = -1, 0
    for j in ops:
        b = (int(key_kind[j]) << 4) | int(action[j])
        if b == run_b:
            run_n += 1
            continue
        if run_n:
            o.append(run_b)
            _uv(o, run_n - 1)
        run_b, run_n = b, 1
    if run_n:
        o.append(run_b)
        _uv(o, run_n - 1)
    prev = 0
    run_v, run_n = -1, 0
    for j in ops:
        lo = local(_REF_OBJ, obj[j])
        if lo == run_v and run_n:
            run_n += 1
            continue
        if run_n:
            _sv(o, run_v - prev)
            _uv(o, run_n - 1)
            prev = run_v
        run_v, run_n = lo, 1
    if run_n:
        _sv(o, run_v - prev)
        _uv(o, run_n - 1)
    prev_e = 0
    for j in ops:
        kk = int(key_kind[j])
        if kk == _KEY_STR:
            _uv(o, local(_REF_KEY, key[j]))
        elif kk == _KEY_ELEM:
            _uv(o, local(_REF_ACTOR, key[j]))
            ke = int(block.key_elem[j])
            _sv(o, ke - prev_e)
            prev_e = ke
    prev_i = 0
    for j in ops:
        if int(action[j]) != _INS:
            continue
        el = int(block.elem[j])
        _sv(o, el - prev_i)
        prev_i = el
    for j in ops:
        a = int(action[j])
        if a not in (_SET, _LINK):
            continue
        vrow = int(block.value[j])
        _uv(o, local(_REF_VAL, vrow) + 1 if vrow >= 0 else 0)
    return bytes(o), refs


def _refs_to_lits(refs, tagged, vlits):
    """Map one change's global ref list to its literal byte tuple."""
    a_t, k_t, o_t = tagged
    out = []
    for ref in refs:
        kind, idx = ref >> 32, ref & 0xFFFFFFFF
        if kind == _REF_ACTOR:
            out.append(a_t[idx])
        elif kind == _REF_KEY:
            out.append(k_t[idx])
        elif kind == _REF_OBJ:
            out.append(o_t[idx])
        else:
            out.append(vlits[idx])
    return tuple(out)


def encode_change_rows_columnar(block, rows):
    """Encode change rows of a general ``block`` in columnar v2 form —
    one ``(body, lits)`` pair per row, native C++ when available,
    byte-identical Python fallback otherwise. ``_NATIVE_COLUMNAR =
    True`` raises instead of falling back (the CI forced-native
    lane)."""
    if not block.is_general():
        raise TypeError('columnar v2 encodes general blocks only')
    rows_arr = np.asarray([int(r) for r in rows], np.int64)
    tagged = _block_tagged_lits(block)
    sel, use, v = _op_selection(block, rows_arr)
    vlits = _tagged_value_lits(block, use, v)
    emitted = None
    if _NATIVE_COLUMNAR is not False:
        from . import native as _native
        emitted = _native.emit_columnar_rows(block, rows_arr)
        if emitted is None and _NATIVE_COLUMNAR is True:
            raise RuntimeError(
                'native columnar codec forced (_NATIVE_COLUMNAR=True) '
                'but the library is unavailable')
    if emitted is None:
        emitted = [_emit_columnar_py(block, c)
                   for c in rows_arr.tolist()]
    return [(body, _refs_to_lits(refs, tagged, vlits))
            for body, refs in emitted]


def encode_change_rows_columnar_v3(block, rows):
    """The v3 twin of :func:`encode_change_rows_columnar`: RLE
    action/obj columns, same ``(body, lits)`` contract — the session
    layer (not the message layer) dedups the literals per CONNECTION.
    Native ``amwe_emit_columnar_v3`` when available, byte-identical
    Python fallback otherwise; ``_NATIVE_COLUMNAR = True`` raises
    instead of falling back (the CI forced-native lane)."""
    if not block.is_general():
        raise TypeError('columnar v3 encodes general blocks only')
    rows_arr = np.asarray([int(r) for r in rows], np.int64)
    tagged = _block_tagged_lits(block)
    sel, use, v = _op_selection(block, rows_arr)
    vlits = _tagged_value_lits(block, use, v)
    emitted = None
    if _NATIVE_COLUMNAR is not False:
        from . import native as _native
        emitted = _native.emit_columnar_rows_v3(block, rows_arr)
        if emitted is None and _NATIVE_COLUMNAR is True:
            raise RuntimeError(
                'native columnar codec forced (_NATIVE_COLUMNAR=True) '
                'but the library is unavailable')
    if emitted is None:
        emitted = [_emit_columnar_v3_py(block, c)
                   for c in rows_arr.tolist()]
    return [(body, _refs_to_lits(refs, tagged, vlits))
            for body, refs in emitted]


def assemble_columnar_spans(entries):
    """Assemble cached ``(body, lits)`` entries into one message:
    returns ``(spans, tab)`` — per-change span bytes (remap + body)
    plus the message-level shared literal table that deduplicates every
    change's literals by CONTENT. Pure splicing: the bodies ship
    verbatim from the encode cache; only the small remap header is
    per-message."""
    tab_index = {}
    tab_list = []
    spans = []
    for body, lits in entries:
        buf = bytearray()
        _uv(buf, len(lits))
        prev = 0
        for lit in lits:
            idx = tab_index.get(lit)
            if idx is None:
                idx = tab_index[lit] = len(tab_list)
                tab_list.append(lit)
            _sv(buf, idx - prev)
            prev = idx
        buf += body
        spans.append(bytes(buf))
    t = bytearray()
    _uv(t, len(tab_list))
    for lit in tab_list:
        _uv(t, len(lit))
        t += lit
    return spans, bytes(t)


def build_columnar_container(tabs, spans_by_doc, version=2):
    """Stitch one receive tick's worth of v2 messages into the single
    container ``parse_columnar_block`` consumes: ``tabs`` is the
    message literal tables, ``spans_by_doc`` one list of
    ``(tab_idx, span)`` per document (container doc order = the
    caller's doc_ids order). ``version=3`` stamps the ``AMW3`` magic —
    same framing, RLE change bodies inside."""
    out = bytearray(COLUMNAR_MAGIC_V3 if version >= 3
                    else COLUMNAR_MAGIC)
    _uv(out, len(tabs))
    for tab in tabs:
        _uv(out, len(tab))
        out += tab
    _uv(out, len(spans_by_doc))
    for spans in spans_by_doc:
        _uv(out, len(spans))
        for tab_idx, span in spans:
            _uv(out, tab_idx)
            _uv(out, len(span))
            out += span
    return bytes(out)


def _parse_columnar_py(data):
    """Pure-Python columnar container parse -> general ChangeBlock
    (the fallback twin of amst_parse_columnar: same bounds checks, same
    column conventions, TaggedValues for the lazy value spans).
    Dispatches on the magic: ``AMW2`` per-op action/obj columns,
    ``AMW3`` the RLE pairs — everything else is shared."""
    from .device.blocks import TaggedValues
    r = _ColReader(data)
    v3 = len(data) >= 4 and data[:4] == COLUMNAR_MAGIC_V3
    if len(data) < 4 or (not v3 and data[:4] != COLUMNAR_MAGIC):
        r.fail('bad columnar magic')
    r.pos = 4
    n_tabs = r.uv()
    if n_tabs > len(data):
        r.fail('tab count exceeds container')
    tabs = []
    for _ in range(n_tabs):
        nbytes = r.uv()
        if nbytes > r.end - r.pos:
            r.fail('tab length exceeds container')
        t = _ColReader(data, pos=r.pos, end=r.pos + nbytes)
        r.pos += nbytes
        n_entries = t.uv()
        if n_entries > nbytes:
            t.fail('tab entry count exceeds tab bytes')
        spans = []
        for _ in range(n_entries):
            llen = t.uv()
            if llen == 0 or llen > t.end - t.pos:
                t.fail('bad literal length')
            spans.append((t.pos, t.pos + llen))
            t.pos += llen
        if t.pos != t.end:
            t.fail('trailing bytes in tab')
        tabs.append((spans, {}))             # spans + interning memo

    actors, actor_of = [], {}
    keys, key_of = [], {}
    objs, obj_of = [ROOT_ID], {ROOT_ID: 0}
    doc, actor, seq = [], [], []
    dep_ptr, dep_actor, dep_seq = [0], [], []
    op_ptr, action, key, value = [0], [], [], []
    obj_col, key_kind, key_elem, elem = [], [], [], []
    vstart, vend = [], []

    def intern_str(tab, entry, table, index, memo_key):
        spans, memo = tab
        hit = memo.get((memo_key, entry))
        if hit is not None:
            return hit
        s, e = spans[entry]
        if data[s] != _TAG_STR:
            raise ValueError(
                'columnar parse failed: string literal expected '
                f'at byte {s}')
        i = _intern(table, index, data[s + 1:e].decode('utf-8'))
        memo[(memo_key, entry)] = i
        return i

    n_docs = r.uv()
    if n_docs > len(data):
        r.fail('doc count exceeds container')
    for d in range(n_docs):
        n_changes = r.uv()
        if n_changes > r.end - r.pos + 1:
            r.fail('change count exceeds container')
        for _ in range(n_changes):
            tab_idx = r.uv()
            if tab_idx >= n_tabs:
                r.fail('tab index out of range')
            tab = tabs[tab_idx]
            nbytes = r.uv()
            if nbytes > r.end - r.pos:
                r.fail('span length exceeds container')
            s = _ColReader(data, pos=r.pos, end=r.pos + nbytes)
            r.pos += nbytes
            n_lits = s.uv()
            if n_lits == 0 or n_lits > nbytes:
                s.fail('bad literal count')
            locals_ = []
            prev_t = 0
            for _ in range(n_lits):
                prev_t += s.sv()
                if not 0 <= prev_t < len(tab[0]):
                    s.fail('literal index out of range')
                locals_.append(prev_t)
            actor_id = intern_str(tab, locals_[0], actors, actor_of,
                                  'a')
            seq_v = s.u32('change seq out of range (must fit int32)')
            n_deps = s.uv()
            if n_deps > nbytes:
                s.fail('bad dep count')
            for _ in range(n_deps):
                al = s.uv()
                if al >= n_lits:
                    s.fail('dep actor out of range')
                dep_actor.append(intern_str(tab, locals_[al], actors,
                                            actor_of, 'a'))
                dep_seq.append(
                    s.u32('dep seq out of range (must fit int32)'))
            n_ops = s.uv()
            if n_ops > nbytes:
                s.fail('op count exceeds span')
            acts, kinds = [], []
            while len(acts) < n_ops:
                if s.pos >= s.end:
                    s.fail('truncated action column')
                b = data[s.pos]
                s.pos += 1
                a, kk = b & 0x0F, b >> 4
                if a > 6 or kk > _KEY_NONE:
                    s.fail('bad action/kind byte')
                n = 1
                if v3:
                    n = s.uv() + 1
                    if len(acts) + n > n_ops:
                        s.fail('action run overflows op count')
                acts.extend([a] * n)
                kinds.extend([kk] * n)
            action.extend(acts)
            key_kind.extend(kinds)
            prev_o = 0
            filled_o = 0
            while filled_o < n_ops:
                prev_o += s.sv()
                if not 0 <= prev_o < n_lits:
                    s.fail('obj literal out of range')
                n = 1
                if v3:
                    n = s.uv() + 1
                    if filled_o + n > n_ops:
                        s.fail('obj run overflows op count')
                oid = intern_str(tab, locals_[prev_o], objs,
                                 obj_of, 'o')
                obj_col.extend([oid] * n)
                filled_o += n
            prev_e = 0
            for i in range(n_ops):
                kk = kinds[i]
                if kk == _KEY_STR:
                    kl = s.uv()
                    if kl >= n_lits:
                        s.fail('key literal out of range')
                    key.append(intern_str(tab, locals_[kl], keys,
                                          key_of, 'k'))
                    key_elem.append(0)
                elif kk == _KEY_ELEM:
                    al = s.uv()
                    if al >= n_lits:
                        s.fail('elem-key actor out of range')
                    key.append(intern_str(tab, locals_[al], actors,
                                          actor_of, 'a'))
                    prev_e += s.sv()
                    if not 0 <= prev_e <= 0x7FFFFFFF:
                        s.fail('element counter out of range')
                    key_elem.append(prev_e)
                else:
                    key.append(-1)
                    key_elem.append(0)
            prev_i = 0
            for i in range(n_ops):
                if acts[i] != _INS:
                    elem.append(0)
                    continue
                prev_i += s.sv()
                if not 0 <= prev_i <= 0x7FFFFFFF:
                    s.fail('ins elem out of range')
                elem.append(prev_i)
            for i in range(n_ops):
                if acts[i] not in (_SET, _LINK):
                    value.append(-1)
                    continue
                u = s.uv()
                value.append(len(vstart))
                if u == 0:
                    vstart.append(-1)
                    vend.append(-1)
                else:
                    if u - 1 >= n_lits:
                        s.fail('value literal out of range')
                    # tab spans already start AT the tag byte
                    vs, ve = tab[0][locals_[u - 1]]
                    vstart.append(vs)
                    vend.append(ve)
            if s.pos != s.end:
                s.fail('trailing bytes in change span')
            doc.append(d)
            actor.append(actor_id)
            seq.append(seq_v)
            dep_ptr.append(len(dep_actor))
            op_ptr.append(len(action))
    if r.pos != r.end:
        r.fail('trailing bytes in container')

    values = TaggedValues(data, np.asarray(vstart, np.int64),
                          np.asarray(vend, np.int64))
    return ChangeBlock(
        n_docs, np.asarray(doc, np.int32), np.asarray(actor, np.int32),
        np.asarray(seq, np.int32), np.asarray(dep_ptr, np.int32),
        np.asarray(dep_actor, np.int32), np.asarray(dep_seq, np.int32),
        np.asarray(op_ptr, np.int32), np.asarray(action, np.int8),
        np.asarray(key, np.int32), np.asarray(value, np.int32),
        actors, keys, values,
        obj=np.asarray(obj_col, np.int32),
        key_kind=np.asarray(key_kind, np.int8),
        key_elem=np.asarray(key_elem, np.int32),
        elem=np.asarray(elem, np.int32), objs=objs)


def parse_columnar_block(data):
    """Parse a columnar v2/v3 container into a general
    :class:`~automerge_tpu_torch.device.blocks.ChangeBlock` — the JSON-free
    receive edge (native ``amst_parse_columnar`` /
    ``amst_parse_columnar_v3`` when available, dispatched on the magic;
    ``_NATIVE_COLUMNAR = True`` raises instead of falling back). No
    store is consulted: key kinds ship explicitly in the format."""
    if isinstance(data, (bytearray, memoryview)):
        data = bytes(data)
    if _NATIVE_COLUMNAR is not False:
        from . import native as _native
        lib = _native.columnar_lib()
        if lib is not None:
            from .device.blocks import TaggedValues
            parse = lib.amst_parse_columnar_v3 \
                if data[:4] == COLUMNAR_MAGIC_V3 \
                else lib.amst_parse_columnar
            h = parse(data, len(data))
            if not h:
                raise MemoryError('columnar codec allocation failed')
            try:
                return _extract_block(lib, h, data, general=True,
                                      values_cls=TaggedValues)
            finally:
                lib.amwc_free(h)
        if _NATIVE_COLUMNAR is True:
            raise RuntimeError(
                'native columnar codec forced (_NATIVE_COLUMNAR=True) '
                'but the library is unavailable')
    return _parse_columnar_py(data)


def columnar_container_to_changes(data):
    """Decode a v2/v3 container back to per-document dict change lists
    — the quarantine-isolation and journal-replay fallback (NOT the
    hot path; the fused apply consumes the block directly)."""
    return parse_columnar_block(data).to_changes()


# ---------------------------------------------------------------------------
# Wire v3 session string tables.
#
# v2 dedups literals per MESSAGE: every warm tick re-ships the same
# actor uuids and hot keys in its `tab`. v3 moves the table up to the
# CONNECTION: the sender keeps a session-scoped string table (epoch
# `sid` + a next-ref watermark), v3 spans reference literals by
# session-wide varint ref, and each message carries only the DEFS the
# session has not confirmed yet. The protocol is QPACK-shaped
# (acked-only bare references) so it survives loss, reordering and
# duplication without any extra round trips:
#
#   - a literal ships as a `(ref, lit)` def in every message that uses
#     it until one of those messages is ACKED; only then do later
#     messages reference it bare. Defs install idempotently, so any
#     single message is decodable from acked state alone — dup and
#     out-of-order delivery are harmless, and retransmits re-ship the
#     stored envelope verbatim (checksum/trace machinery untouched).
#   - ref ids recycle under an LRU byte budget, but only refs that are
#     ACKED with ZERO in-flight (pending) uses: every envelope that
#     references a ref holds a pending count until it acks or dies, so
#     a recycled ref can never be resolved against a stale definition
#     by a conforming receiver (which resolves at RECEIVE time, in
#     arrival order, before acking).
#   - the receiver keys its ref maps by `sid`; a fresh connection mints
#     a fresh epoch, so reconnects never alias a dead session's refs.
#
# An unknown ref at the receiver (possible only after losing table
# state, e.g. a peer restarting mid-session) raises plain ValueError —
# the envelope is NOT acked, and the sender's retransmit/exhaustion/
# heartbeat machinery repairs it like any other delivery failure,
# never via quarantine.

import heapq as _heapq
import itertools as _itertools

_session_ids = _itertools.count(1)

# accounting overhead per table entry (the list cell + two dict slots);
# keeps the byte gauge honest for many tiny literals
_TABLE_ENTRY_OVERHEAD = 64


class SessionStringTable:
    """Sender-side wire-v3 session string table: content -> session
    ref, with QPACK-style acked/pending bookkeeping and LRU ref
    recycling under ``max_bytes``. One per WireConnection; the `sid`
    epoch stamps every outgoing v3 message."""

    __slots__ = ('sid', 'max_bytes', 'entries', 'by_ref', 'next_ref',
                 'free_refs', 'bytes', 'hits', 'misses', 'evictions',
                 '_clock', '__weakref__')

    # entries[lit] = [ref, acked, pending, last_use]
    _REF, _ACKED, _PENDING, _LAST_USE = 0, 1, 2, 3

    def __init__(self, max_bytes=1 << 20):
        self.sid = next(_session_ids)
        self.max_bytes = max_bytes
        self.entries = {}
        self.by_ref = {}
        self.next_ref = 0
        self.free_refs = []
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._clock = 0

    def __len__(self):
        return len(self.entries)

    def reset(self):
        """Tear the session down and mint a FRESH epoch: every entry
        drops and the next message goes out under a new ``sid``, so
        the peer simply starts a new rx table and re-learns defs —
        always safe (in-flight envelopes of the old sid still decode
        against the peer's retained old epoch, and their acks no-op
        against the new sid)."""
        self.sid = next(_session_ids)
        self.entries.clear()
        self.by_ref.clear()
        self.next_ref = 0
        self.free_refs = []
        self.bytes = 0

    def warm(self, lits):
        """Pre-seed a FRESH session from a ``'state'`` bootstrap's
        literal list (wire-v3 warm-up): refs assign sequentially from
        0 in list order — the peer seeds its receive map by
        enumerating the SAME deterministically-derived list
        (:func:`~automerge_tpu_torch.compaction.state_warm_literals`) — and
        entries start ACKED, because the peer demonstrably holds every
        literal (it produced the very snapshot they came from), so the
        first warm flush ships bare refs with no definitions. A
        duplicate literal burns its ref number instead of skipping it,
        keeping positional parity with the peer's enumerate whatever
        the input. No-op on a table that has already allocated refs:
        warm refs must never collide with organically interned ones.
        Returns the number of literals seeded."""
        if self.entries or self.next_ref or self.free_refs:
            return 0
        n = 0
        for lit in lits:
            ref = self.next_ref
            self.next_ref += 1
            if lit in self.entries:
                continue
            self._clock += 1
            self.entries[lit] = [ref, True, 0, self._clock]
            self.by_ref[ref] = lit
            self.bytes += len(lit) + _TABLE_ENTRY_OVERHEAD
            n += 1
        return n

    def intern(self, lit):
        """``(ref, needs_def)`` for one literal. ``needs_def`` until a
        message defining it is acked — hit/miss counters measure
        exactly the bare-reference savings."""
        self._clock += 1
        e = self.entries.get(lit)
        if e is not None:
            e[3] = self._clock
            if e[1]:
                self.hits += 1
                return e[0], False
            self.misses += 1
            return e[0], True
        if self.free_refs:
            ref = _heapq.heappop(self.free_refs)
        else:
            ref = self.next_ref
            self.next_ref += 1
        self.entries[lit] = [ref, False, 0, self._clock]
        self.by_ref[ref] = lit
        self.bytes += len(lit) + _TABLE_ENTRY_OVERHEAD
        self.misses += 1
        return ref, True

    def note_pending(self, refs):
        """One in-flight envelope now references ``refs`` (distinct
        per message): pin them against recycling until it acks or
        dies."""
        for ref in refs:
            lit = self.by_ref.get(ref)
            if lit is not None:
                self.entries[lit][2] += 1

    def note_acked(self, def_refs, used_refs):
        """An envelope acked: its defs are session-confirmed (bare
        references allowed from now on) and its uses unpinned."""
        for ref in def_refs:
            lit = self.by_ref.get(ref)
            if lit is not None:
                self.entries[lit][1] = True
        self._unpin(used_refs)

    def note_dead(self, used_refs):
        """An envelope died permanently (retry budget exhausted):
        unpin its uses — its defs were never confirmed, so the
        literals stay in needs_def state and re-define on next use."""
        self._unpin(used_refs)

    def _unpin(self, refs):
        for ref in refs:
            lit = self.by_ref.get(ref)
            if lit is not None:
                e = self.entries[lit]
                if e[2] > 0:
                    e[2] -= 1

    def evict_to_budget(self):
        """LRU-recycle refs past the byte budget. Only entries with no
        in-flight use are eligible (acked or not — an unacked entry
        was never referenced bare, so dropping it is always safe); a
        freed ref id returns to the allocation pool and its next
        definition overwrites it receiver-side."""
        if self.bytes <= self.max_bytes:
            return
        victims = sorted((e[3], lit)
                         for lit, e in self.entries.items() if not e[2])
        for _, lit in victims:
            if self.bytes <= self.max_bytes:
                break
            ref = self.entries.pop(lit)[0]
            del self.by_ref[ref]
            _heapq.heappush(self.free_refs, ref)
            self.bytes -= len(lit) + _TABLE_ENTRY_OVERHEAD
            self.evictions += 1


def encode_session_defs(defs):
    """``[(ref, lit)]`` -> the v3 message ``tab`` bytes:
    ``uvarint n_defs { uvarint ref  uvarint len  lit }*``."""
    t = bytearray()
    _uv(t, len(defs))
    for ref, lit in defs:
        _uv(t, ref)
        _uv(t, len(lit))
        t += lit
    return bytes(t)


def decode_session_defs(tab):
    """The v3 ``tab`` bytes -> ``[(ref, lit)]`` (bounds-checked; a
    corrupt tab raises ValueError and the envelope layer repairs by
    retransmit)."""
    tab = bytes(tab)
    t = _ColReader(tab)
    n = t.uv()
    if n > len(tab):
        t.fail('session def count exceeds tab')
    out = []
    for _ in range(n):
        ref = t.uv()
        llen = t.uv()
        if llen == 0 or llen > t.end - t.pos:
            t.fail('bad session def literal length')
        out.append((ref, tab[t.pos:t.pos + llen]))
        t.pos += llen
    if t.pos != t.end:
        t.fail('trailing bytes in session tab')
    return out


def assemble_session_spans(entries, table):
    """The v3 message assembly: cached ``(body, lits)`` entries against
    the sender's session ``table``. Returns ``(spans, tab, used_refs)``
    — spans are ``uvarint n_lits {svarint delta(session ref)}* body``
    (the v2 span shape with session-wide refs instead of message-local
    indices), ``tab`` the defs this message must carry. The caller pins
    ``used_refs`` per envelope (``note_pending`` already called here)
    and feeds acks/deaths back via ``note_acked``/``note_dead``."""
    spans = []
    new_defs = {}
    used = set()
    for body, lits in entries:
        buf = bytearray()
        _uv(buf, len(lits))
        prev = 0
        for lit in lits:
            ref, needs_def = table.intern(lit)
            if needs_def:
                new_defs[ref] = lit
            used.add(ref)
            _sv(buf, ref - prev)
            prev = ref
        buf += body
        spans.append(bytes(buf))
    table.note_pending(used)
    table.evict_to_budget()
    return spans, encode_session_defs(sorted(new_defs.items())), used


def decode_session_spans(blob, lens, refs):
    """Resolve one v3 message's spans against the receiver's ref map:
    returns ``[(body, lits)]`` in message-local form (the
    :func:`assemble_columnar_spans` input shape — the receiver rewrites
    the message into a self-contained per-message-tab form before
    buffering). An unresolvable ref raises ValueError: the envelope is
    not acked and the sender's retransmit repairs it."""
    blob = bytes(blob)
    entries = []
    pos = 0
    for ln in lens:
        s = _ColReader(blob, pos=pos, end=pos + ln)
        n_lits = s.uv()
        if n_lits == 0 or n_lits > ln:
            s.fail('bad session span literal count')
        lits = []
        prev = 0
        for _ in range(n_lits):
            prev += s.sv()
            lit = refs.get(prev)
            if lit is None:
                raise ValueError(
                    f'wire v3 session ref {prev} unknown (table state '
                    f'lost?); dropping for retransmit repair')
            lits.append(lit)
        entries.append((blob[s.pos:pos + ln], tuple(lits)))
        pos += ln
    return entries


def session_payload_refs(payload):
    """Stateless re-derivation of ``(def_refs, used_refs)`` from a
    STORED v3 wire payload (the sender's own envelope, so malformed
    input is impossible in practice): re-parses the ``tab`` defs and
    the span headers. The ack/death bookkeeping hooks use this so no
    seq -> refs side table is needed."""
    defs = decode_session_defs(payload['tab'])
    blob = bytes(payload['blob'])
    used = set()
    pos = 0
    for ln in payload['lens']:
        s = _ColReader(blob, pos=pos, end=pos + ln)
        n_lits = s.uv()
        prev = 0
        for _ in range(n_lits):
            prev += s.sv()
            used.add(prev)
        pos += ln
    return [ref for ref, _ in defs], used


parseColumnarBlock = parse_columnar_block
