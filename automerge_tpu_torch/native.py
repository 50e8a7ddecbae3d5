"""Native host runtime: C++ order-statistic sequence index with COW handles.

The reference's L1 native-performance role is played by `SkipList`
(backend/skip_list.js:114-334) — an immutable order-statistic index giving
elemId<->index in O(log n), introduced "for performance" (CHANGELOG.md:140)
to replace an O(n) design. Here that component is a C++ indexable skip
list (`native/seq_index.cpp`) behind refcount-based copy-on-write handles:

* :class:`SeqIndex` quacks like the ``list`` of elemId strings the oracle
  backend otherwise keeps (``index/insert/__delitem__/__getitem__/len``),
  so every call site works with either representation.
* ``clone()`` is O(1): snapshots share one C++ structure. The structure is
  physically copied only when a *shared* snapshot is mutated, via a
  linear-time structural copy in C++. Within one batched apply session
  (the fast path: ``apply_changes(state, many_changes)``) at most one copy
  happens and every subsequent edit is in-place O(log n). Per-change apply
  loops pay one O(n) copy per change — the same asymptotics as the plain
  list fallback's clone, at memcpy-level constants — so batching is where
  the 20-30x replay speedup comes from.
* elemId strings are interned process-wide to int64 keys; only ints cross
  the C boundary.

The C library is compiled on demand with g++ (no pip deps); if a compiler
or the .so is unavailable, callers fall back to plain Python lists.

This is the PyTorch port's copy of ``automerge_tpu/native.py``: it reads
the SAME C++ sources (``native/seq_index.cpp``, ``native/wire_codec.cpp``
at the repository root, never edited) and builds them with g++ into this
package's own ``_native/`` directory (the codec, where that directory
cannot be written, into a per-user cache, as the reference's
``wire._load`` does). It binds the sequence index, the
native general stager (``amst_stage_general``), the view gathers, and
the codec's wire-blob emit and columnar v2/v3 entry points that
:mod:`.wire` calls.
"""

import ctypes
import os
import subprocess
import tempfile
import warnings

_LIB = None
_LOAD_ATTEMPTED = False

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_PKG_DIR, '_native')
_SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'native')
_SO_PATH = os.path.join(_NATIVE_DIR, 'libamtpu.so')
_SRC_PATH = os.path.join(_SRC_DIR, 'seq_index.cpp')
_WIRE_SO_PATH = os.path.join(_NATIVE_DIR, 'libamwire.so')
_WIRE_SRC_PATH = os.path.join(_SRC_DIR, 'wire_codec.cpp')


def _bind(lib):
    lib.amsl_new.argtypes = [ctypes.c_uint64]
    lib.amsl_new.restype = ctypes.c_void_p
    lib.amsl_copy.argtypes = [ctypes.c_void_p]
    lib.amsl_copy.restype = ctypes.c_void_p
    lib.amsl_free.argtypes = [ctypes.c_void_p]
    lib.amsl_free.restype = None
    lib.amsl_len.argtypes = [ctypes.c_void_p]
    lib.amsl_len.restype = ctypes.c_int64
    lib.amsl_insert.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.amsl_insert.restype = ctypes.c_int
    lib.amsl_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.amsl_remove.restype = ctypes.c_int64
    lib.amsl_index_of.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.amsl_index_of.restype = ctypes.c_int64
    lib.amsl_key_at.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.amsl_key_at.restype = ctypes.c_int64
    lib.amsl_fill_keys.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.amsl_fill_keys.restype = None
    return lib


def _compile(src=_SRC_PATH, so_path=_SO_PATH):
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=os.path.dirname(so_path))
    os.close(fd)
    try:
        subprocess.run(
            ['g++', '-O2', '-shared', '-fPIC', '-std=c++17',
             src, '-o', tmp],
            check=True, capture_output=True, timeout=180)
        os.replace(tmp, so_path)  # atomic: concurrent builders both succeed
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load():
    global _LIB, _LOAD_ATTEMPTED
    if _LOAD_ATTEMPTED:
        return _LIB
    _LOAD_ATTEMPTED = True
    if os.environ.get('AUTOMERGE_TPU_NATIVE', '1') == '0':
        return None
    have_src = os.path.exists(_SRC_PATH)
    stale = (have_src and os.path.exists(_SO_PATH)
             and os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH))
    if not os.path.exists(_SO_PATH) or stale:
        if not have_src or not _compile():
            if not os.path.exists(_SO_PATH):
                return None
    try:
        _LIB = _bind(ctypes.CDLL(_SO_PATH))
    except OSError:
        _LIB = None
    return _LIB


def available():
    return _load() is not None


_WIRE_LIB = None
_WIRE_ATTEMPTED = False


def _wire_cache_so_path():
    """The codec's build target when ``_native/`` cannot be written (a
    read-only install): a per-user cache directory named for this
    package, keyed by a hash of the source, so two installs with
    different codec sources (or the JAX package's build) never load
    each other's binary."""
    import hashlib
    try:
        with open(_WIRE_SRC_PATH, 'rb') as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        tag = 'nosrc'
    base = os.environ.get('XDG_CACHE_HOME') or \
        os.path.join(os.path.expanduser('~'), '.cache')
    return os.path.join(base, 'automerge_tpu_torch', f'libamwire-{tag}.so')


def _wire_compile(so_path):
    """Build the codec into ``so_path``; False (never an ``OSError``)
    when its directory cannot be made or written."""
    try:
        return _compile(_WIRE_SRC_PATH, so_path)
    except OSError:
        return False


def _wire_load():
    """The codec library (``native/wire_codec.cpp``), or None (no
    source and no binary, no g++, or ``AUTOMERGE_TPU_NATIVE=0``). It is
    built into this package's ``_native/``, else into the per-user
    cache (:func:`_wire_cache_so_path`); a binary older than its source
    is rebuilt, and loaded with a ``RuntimeWarning`` only when no
    candidate could be rebuilt. On None, :func:`.wire._load` warns and
    the pure-Python parser runs."""
    global _WIRE_LIB, _WIRE_ATTEMPTED
    if _WIRE_ATTEMPTED:
        return _WIRE_LIB
    _WIRE_ATTEMPTED = True
    if os.environ.get('AUTOMERGE_TPU_NATIVE', '1') == '0':
        return None
    have_src = os.path.exists(_WIRE_SRC_PATH)
    candidates = (_WIRE_SO_PATH, _wire_cache_so_path())
    so_path = None
    for candidate in candidates:
        stale = (have_src and os.path.exists(candidate)
                 and os.path.getmtime(candidate)
                 < os.path.getmtime(_WIRE_SRC_PATH))
        if os.path.exists(candidate) and not stale:
            so_path = candidate
            break
        if have_src and _wire_compile(candidate):
            so_path = candidate
            break
    if so_path is None:
        # last resort: a stale binary beats no binary, but only after
        # every candidate (the user cache included) failed to rebuild
        for candidate in candidates:
            if os.path.exists(candidate):
                so_path = candidate
                warnings.warn(
                    f'automerge_tpu_torch: native wire codec at '
                    f'{candidate} is older than its source and could not '
                    f'be rebuilt; loading the stale binary.',
                    RuntimeWarning)
                break
    if so_path is None:
        return None
    try:
        _WIRE_LIB = ctypes.CDLL(so_path)
    except OSError:
        _WIRE_LIB = None
    return _WIRE_LIB


def build_all():
    """Build (or reuse) both host libraries now; returns
    ``(seq_index_ok, codec_ok)``. Callers that time set-up separately
    from the first apply call this up front."""
    return available(), _wire_load() is not None


# Process-wide elemId interner. elemIds ("actor:counter" strings) are
# append-only over a process lifetime; the table is shared by all indexes.
#
# Growth contract: one entry per distinct elemId ever seen, never pruned
# automatically — integer ids baked into live C++ skip lists must stay
# valid, so entries can only be dropped when no SeqIndex is alive. A
# long-lived process churning through many documents should call
# `reset_intern_table()` at a point where it holds no SeqIndex instances.
_INTERN = {}
_STRS = []


def _intern(key):
    i = _INTERN.get(key)
    if i is None:
        i = len(_STRS)
        _INTERN[key] = i
        _STRS.append(key)
    return i


def intern_table_size():
    """Number of distinct elemIds interned so far (observability hook)."""
    return len(_STRS)


def reset_intern_table():
    """Drop every interned elemId. ONLY safe when no SeqIndex instances
    are alive: live indexes hold the old integer ids and would resolve
    them against the new table."""
    _INTERN.clear()
    _STRS.clear()


_seed_counter = [0]


class SeqIndex:
    """COW handle over one C++ skip list; list-compatible surface."""

    __slots__ = ('_lib', '_h', '_rc')

    def __init__(self, _h=None, _rc=None, _lib=None):
        self._lib = _lib or _load()
        if _h is not None:
            self._h = _h
            self._rc = _rc
        else:
            _seed_counter[0] += 1
            self._h = self._lib.amsl_new(_seed_counter[0])
            if not self._h:
                raise MemoryError('seq index allocation failed')
            self._rc = [1]

    def clone(self):
        """O(1) snapshot: share the structure, bump the refcount."""
        self._rc[0] += 1
        return SeqIndex(_h=self._h, _rc=self._rc, _lib=self._lib)

    def _own(self):
        """Ensure exclusive ownership before a mutation (copy if shared)."""
        if self._rc[0] > 1:
            h = self._lib.amsl_copy(self._h)
            if not h:
                raise MemoryError('seq index copy failed')
            self._rc[0] -= 1
            self._h = h
            self._rc = [1]

    def __del__(self):
        rc = getattr(self, '_rc', None)
        if rc is None:
            return
        rc[0] -= 1
        if rc[0] == 0 and self._h:
            self._lib.amsl_free(self._h)
        self._h = None
        self._rc = None

    def __len__(self):
        return self._lib.amsl_len(self._h)

    def __getitem__(self, index):
        n = len(self)
        if index < 0:
            index += n
        k = self._lib.amsl_key_at(self._h, index)
        if k < 0:
            raise IndexError('seq index out of range')
        return _STRS[k]

    def index(self, key):
        i = self._lib.amsl_index_of(self._h, _INTERN.get(key, -1))
        if i < 0:
            raise ValueError(f'{key!r} is not in seq index')
        return i

    def insert(self, index, key):
        self._own()
        n = len(self)
        if index < 0:
            index = max(n + index, 0)
        if index > n:
            index = n
        rc = self._lib.amsl_insert(self._h, index, _intern(key))
        if rc == -2:
            raise MemoryError('seq index node allocation failed')
        if rc != 0:
            raise ValueError(f'duplicate elemId {key!r}')

    def __delitem__(self, index):
        self._own()
        if index < 0:
            index += len(self)
        if self._lib.amsl_remove(self._h, index) < 0:
            raise IndexError('seq index out of range')

    def __iter__(self):
        n = len(self)
        buf = (ctypes.c_int64 * n)()
        self._lib.amsl_fill_keys(self._h, buf)
        return iter([_STRS[k] for k in buf])

    def __eq__(self, other):
        if isinstance(other, (list, SeqIndex)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f'SeqIndex({list(self)!r})'


def make_seq_index():
    """A fresh sequence index: native if available, else a plain list."""
    if _load() is not None:
        return SeqIndex()
    return []


def clone_index(idx):
    """Snapshot an index produced by :func:`make_seq_index`."""
    if isinstance(idx, SeqIndex):
        return idx.clone()
    return list(idx)


# ---------------------------------------------------------------------------
# Native general-block staging (the amst_* entry points of libamwire.so).
#
# `device/general._apply_general` turns an admitted block into the staged
# planes the fused device program consumes. The heavy per-op passes —
# object-row mapping, ins grouping + local node minting, elemId
# resolution with the duplicate check, packed field keys, the stable
# field sort, the new-node d-planes and the single packed wire buffer —
# run here in one C++ call, byte-identical to the numpy staging (which
# remains the fallback whenever the library is unavailable, a change was
# queued/dropped at admission, or a late-bound string elemId appears).

import numpy as _np

_STAGE_LIB = None
_STAGE_ATTEMPTED = False

_i64 = ctypes.c_int64
_P8 = ctypes.POINTER(ctypes.c_int8)
_P32 = ctypes.POINTER(ctypes.c_int32)
_P64 = ctypes.POINTER(ctypes.c_int64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)


def _bind_stage(lib):
    lib.amst_stage_general.argtypes = [
        _i64, _P8, _P32, _P8, _P32, _P32, _P32,          # op columns
        _i64, _P32, _P32, _P32, _P32, _P32,              # change columns
        _P32, _P32,                                      # a_tab, k_tab
        _P64, _P64, _P32, _P32, _i64,                    # omap/root/obj
        _P64, _P64, _P64, _P64, _i64,                    # pool tables
        _P32, _P32, _P32, _P32, _P32,                    # pool columns
        _i64,                                            # n_old_mirror
        _i64, _P64, _P64, _P64, _P64]                    # staging cache
    lib.amst_stage_general.restype = ctypes.c_void_p
    for name in ('amst_err', 'amst_err_payload', 'amst_fallback',
                 'amst_n_ins', 'amst_n_arows', 'amst_n_dirty',
                 'amst_n_fields', 'amst_max_seq', 'amst_max_nj',
                 'amst_d_n'):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = _i64
    lib.amst_free.argtypes = [ctypes.c_void_p]
    lib.amst_free.restype = None
    lib.amst_fill_append.argtypes = [ctypes.c_void_p, _P64, _P64, _P64,
                                     _P32, _P64]
    lib.amst_fill_append.restype = None
    lib.amst_fill_res.argtypes = [ctypes.c_void_p] + [_P64] * 5
    lib.amst_fill_res.restype = None
    lib.amst_fill_order.argtypes = [ctypes.c_void_p, _P64, _P32]
    lib.amst_fill_order.restype = None
    lib.amst_fill_fields.argtypes = [ctypes.c_void_p, _P64]
    lib.amst_fill_fields.restype = None
    lib.amst_fill_dirty.argtypes = [ctypes.c_void_p, _P64, _P64, _P64]
    lib.amst_fill_dirty.restype = None
    lib.amst_fill_dplanes.argtypes = [ctypes.c_void_p] + [_P32] * 6
    lib.amst_fill_dplanes.restype = None
    lib.amst_fill_wire.argtypes = [ctypes.c_void_p, _PU8, _i64, _i64,
                                   _i64, _i64, _i64, _i64, _P64]
    lib.amst_fill_wire.restype = None
    lib.amst_fill_wire_wide.argtypes = [ctypes.c_void_p, _PU8, _i64,
                                        _i64, _i64, _i64, _i64, _i64]
    lib.amst_fill_wire_wide.restype = None
    return lib


def stage_lib():
    """The staging library, or None (no native codec / stale binary
    without the amst_* symbols / AUTOMERGE_TPU_NATIVE_STAGE=0)."""
    global _STAGE_LIB, _STAGE_ATTEMPTED
    if _STAGE_ATTEMPTED:
        return _STAGE_LIB
    _STAGE_ATTEMPTED = True
    if os.environ.get('AUTOMERGE_TPU_NATIVE_STAGE', '1') == '0':
        return None
    lib = _wire_load()
    if lib is None:
        return None
    try:
        _STAGE_LIB = _bind_stage(lib)
    except AttributeError:
        _STAGE_LIB = None            # stale .so predating the stager
    return _STAGE_LIB


def stage_available():
    return stage_lib() is not None


# ---------------------------------------------------------------------------
# Native view gather (the amst_view_* entry points of libamwire.so):
# the batched materialization's field-sort + winner select and the
# visible-element walk, byte-identical to the numpy fallbacks in
# `device/general_backend.winner_select` / `visible_walk`.

_VIEW_LIB = None
_VIEW_ATTEMPTED = False


def _bind_view(lib):
    lib.amst_view_winners.argtypes = [_i64, _P64, _P64]
    lib.amst_view_winners.restype = ctypes.c_void_p
    lib.amst_view_walk.argtypes = [_i64, _P64, _P64, _P64, _i64, _P64,
                                   _P32, _PU8, _P32]
    lib.amst_view_walk.restype = ctypes.c_void_p
    lib.amst_view_n.argtypes = [ctypes.c_void_p]
    lib.amst_view_n.restype = _i64
    lib.amst_view_fill.argtypes = [ctypes.c_void_p, _P64, _P64, _P64]
    lib.amst_view_fill.restype = None
    lib.amst_view_free.argtypes = [ctypes.c_void_p]
    lib.amst_view_free.restype = None
    return lib


def view_lib():
    """The view-gather library, or None (no native codec / stale
    binary without the amst_view_* symbols /
    AUTOMERGE_TPU_NATIVE_VIEW=0)."""
    global _VIEW_LIB, _VIEW_ATTEMPTED
    if _VIEW_ATTEMPTED:
        return _VIEW_LIB
    _VIEW_ATTEMPTED = True
    if os.environ.get('AUTOMERGE_TPU_NATIVE_VIEW', '1') == '0':
        return None
    lib = _wire_load()
    if lib is None:
        return None
    try:
        _VIEW_LIB = _bind_view(lib)
    except AttributeError:
        _VIEW_LIB = None             # stale .so predating the views
    return _VIEW_LIB


def view_available():
    return view_lib() is not None


def view_winners(field, rank):
    """Native field-sort + winner select: ``(fields, winner_pos)`` for
    packed int64 field keys and per-entry actor string ranks, or None
    when the library is unavailable (caller falls back to numpy)."""
    lib = view_lib()
    if lib is None:
        return None
    field = _np.ascontiguousarray(field, _np.int64)
    rank = _np.ascontiguousarray(rank, _np.int64)
    h = lib.amst_view_winners(len(field), _p64(field), _p64(rank))
    if not h:
        raise MemoryError('native view allocation failed')
    try:
        m = int(lib.amst_view_n(h))
        fields = _np.empty(m, _np.int64)
        wpos = _np.empty(m, _np.int64)
        lib.amst_view_fill(h, _p64(fields), _p64(wpos), None)
    finally:
        lib.amst_view_free(h)
    return fields, wpos


def view_walk(objs, pool):
    """Native visible-element walk over ``objs`` (ascending sequence
    object rows): ``(seg, local, counts)`` in per-object document
    order, or None when the library is unavailable."""
    lib = view_lib()
    if lib is None:
        return None
    objs = _np.ascontiguousarray(objs, _np.int64)
    n_of = _np.ascontiguousarray(pool.n_of, _np.int64)
    pos_sorted = _np.ascontiguousarray(pool.pos_sorted, _np.int64)
    pos_row = _np.ascontiguousarray(pool.pos_row, _np.int64)
    local = _np.ascontiguousarray(pool.local, _np.int32)
    visible = _np.ascontiguousarray(pool.visible, _np.uint8)
    vis_index = _np.ascontiguousarray(pool.vis_index, _np.int32)
    h = lib.amst_view_walk(
        len(objs), _p64(objs), _p64(pos_sorted), _p64(pos_row),
        pool.n_nodes, _p64(n_of), _p32(local),
        visible.ctypes.data_as(_PU8), _p32(vis_index))
    if not h:
        raise MemoryError('native view allocation failed')
    try:
        m = int(lib.amst_view_n(h))
        seg = _np.empty(m, _np.int64)
        loc = _np.empty(m, _np.int64)
        counts = _np.empty(len(objs), _np.int64)
        lib.amst_view_fill(h, _p64(seg), _p64(loc), _p64(counts))
    finally:
        lib.amst_view_free(h)
    return seg, loc, counts


# ---------------------------------------------------------------------------
# Native wire-blob emit (the amwe_* entry points of libamwire.so): change
# rows of a retained ChangeBlock -> compact canonical JSON bytes, the
# encode half of the zero-re-encode sync tick. Byte-identical to the
# Python fallback in `wire._emit_change_py` by construction — the host
# pre-escapes every string literal; C++ only splices spans and formats
# integers.

_EMIT_LIB = None
_EMIT_ATTEMPTED = False


def _bind_emit(lib):
    lib.amwe_emit_general.argtypes = [
        _i64, _P64,                                  # rows
        _P32, _P32, _P32, _P32, _P32,                # change columns
        _P32, _P8, _P32, _P8, _P32, _P32, _P32,      # op columns
        _P32,                                        # val_local
        ctypes.c_char_p, _P64, ctypes.c_char_p, _P64,
        ctypes.c_char_p, _P64, ctypes.c_char_p, _P64]
    lib.amwe_emit_general.restype = ctypes.c_void_p
    lib.amwe_bytes.argtypes = [ctypes.c_void_p]
    lib.amwe_bytes.restype = _i64
    lib.amwe_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _P64]
    lib.amwe_fill.restype = None
    lib.amwe_free.argtypes = [ctypes.c_void_p]
    lib.amwe_free.restype = None
    return lib


def emit_lib():
    """The wire-emit library, or None (no native codec / stale binary
    without the amwe_* symbols / AUTOMERGE_TPU_NATIVE_EMIT=0)."""
    global _EMIT_LIB, _EMIT_ATTEMPTED
    if _EMIT_ATTEMPTED:
        return _EMIT_LIB
    _EMIT_ATTEMPTED = True
    if os.environ.get('AUTOMERGE_TPU_NATIVE_EMIT', '1') == '0':
        return None
    # through the wire module: it binds the parse entry points that
    # share this handle (the columnar parse reads its results with them)
    from . import wire as _wire
    lib = _wire._load()
    if lib is None:
        return None
    try:
        _EMIT_LIB = _bind_emit(lib)
    except AttributeError:
        _EMIT_LIB = None             # stale .so predating the emitter
    return _EMIT_LIB


def emit_available():
    return emit_lib() is not None


def _lit_blob(lits):
    """(concatenated bytes, int64 offsets) of a literal table."""
    blob = b''.join(lits)
    off = _np.zeros(len(lits) + 1, _np.int64)
    if lits:
        _np.cumsum([len(x) for x in lits], out=off[1:])
    return blob, off


def emit_change_rows(block, rows_arr, lits, vlits, sel, use, v):
    """Native batch emit of general-block change rows: one ``bytes``
    per row, or None when the library is unavailable (the caller falls
    back to the Python emitter). ``lits`` are the block's pre-escaped
    (actors, keys, objs) literal tables; ``vlits`` maps referenced
    value rows to their literal bytes; ``sel``/``use``/``v`` is the
    caller's op selection (``wire._op_selection`` — computed once,
    shared with the value-literal build)."""
    lib = emit_lib()
    if lib is None:
        return None
    # joined table blobs cache on the block next to the literal lists
    # (wire._block_lits) — a fleet serve must not re-join per call
    cacheobj = block._wire_lits if isinstance(block._wire_lits, dict) \
        else None
    blobs = cacheobj.get('blobs') if cacheobj is not None else None
    if blobs is None:
        actors_l, keys_l, objs_l = lits
        blobs = (_lit_blob(actors_l), _lit_blob(keys_l),
                 _lit_blob(objs_l))
        if cacheobj is not None:
            cacheobj['blobs'] = blobs
    (a_b, a_off), (k_b, k_off), (o_b, o_off) = blobs
    vids = _np.asarray(sorted(vlits), _np.int64)
    v_b, v_off = _lit_blob([vlits[int(i)] for i in vids])
    # per-op local value index (-1 none), filled for the selected ops
    # only — one vectorized remap, no per-op Python
    val_local = _np.full(block.n_ops, -1, _np.int32)
    if len(vids) and len(sel):
        val_local[sel[use]] = _np.searchsorted(
            vids, v[use]).astype(_np.int32)
    h = lib.amwe_emit_general(
        len(rows_arr), _p64(rows_arr),
        _p32(block.actor), _p32(block.seq),
        _p32(block.dep_ptr), _p32(block.dep_actor),
        _p32(block.dep_seq),
        _p32(block.op_ptr), _p8(block.action), _p32(block.obj),
        _p8(block.key_kind), _p32(block.key), _p32(block.key_elem),
        _p32(block.elem), _p32(val_local),
        a_b, _p64(a_off), k_b, _p64(k_off),
        o_b, _p64(o_off), v_b, _p64(v_off))
    if not h:
        raise MemoryError('native wire emit allocation failed')
    try:
        nbytes = int(lib.amwe_bytes(h))
        buf = ctypes.create_string_buffer(max(nbytes, 1))
        offsets = _np.empty(len(rows_arr) + 1, _np.int64)
        lib.amwe_fill(h, buf, _p64(offsets))
        raw = buf.raw[:nbytes]
    finally:
        lib.amwe_free(h)
    return [raw[offsets[i]:offsets[i + 1]]
            for i in range(len(rows_arr))]


def _p32(a):
    return a.ctypes.data_as(_P32)


def _p64(a):
    return a.ctypes.data_as(_P64)


def _p8(a):
    return a.ctypes.data_as(_P8)


# staging error codes (wire_codec.cpp ErrCode) -> exception builders;
# messages match the numpy staging exactly
_STAGE_ERRORS = {
    1: (ValueError, 'Modification of unknown object {obj}'),
    2: (ValueError, 'Insertion into non-sequence object {uuid}'),
    3: (ValueError, 'Duplicate list element ID'),
    4: (ValueError, 'List element insertion after unknown element'),
    5: (TypeError, 'Missing index entry for list element'),
    6: (ValueError, 'assignment to _head'),
}


class GeneralStagedPlanes:
    """Handle over one native staging result. Numpy views of the
    resolution columns materialize on construction; the plane fills
    (`fill_wire`, `fill_dplanes`) stream straight from the C++ buffers
    into caller-allocated arrays. Keeps every borrowed input array
    alive until freed."""

    __slots__ = ('_lib', '_h', '_keep', 'n_ins', 'n_arows', 'n_fields',
                 'n_dirty', 'max_seq', 'max_nj', 'd_n',
                 'a_rows', 'o_field', 'seg_new', 'a_node', 'a_objrow',
                 'g_obj', 'g_local', 'g_parent', 'g_actor', 'g_elem',
                 'order', 'r_seg', 'touched', 'dirty', 'n_j', 'new_cnt')

    def __init__(self, lib, h, keep):
        self._lib = lib
        self._h = h
        self._keep = keep            # borrowed-arrays lifeline
        self.n_ins = int(lib.amst_n_ins(h))
        self.n_arows = int(lib.amst_n_arows(h))
        self.n_fields = int(lib.amst_n_fields(h))
        self.n_dirty = int(lib.amst_n_dirty(h))
        self.max_seq = int(lib.amst_max_seq(h))
        self.max_nj = int(lib.amst_max_nj(h))
        self.d_n = int(lib.amst_d_n(h))
        n_a, n_i, K, F = self.n_arows, self.n_ins, self.n_dirty, \
            self.n_fields
        self.a_rows = _np.empty(n_a, _np.int64)
        self.o_field = _np.empty(n_a, _np.int64)
        self.seg_new = _np.empty(n_a, _np.int64)
        self.a_node = _np.empty(n_a, _np.int64)
        self.a_objrow = _np.empty(n_a, _np.int64)
        lib.amst_fill_res(h, _p64(self.a_rows), _p64(self.o_field),
                          _p64(self.seg_new), _p64(self.a_node),
                          _p64(self.a_objrow))
        self.g_obj = _np.empty(n_i, _np.int64)
        self.g_local = _np.empty(n_i, _np.int64)
        self.g_parent = _np.empty(n_i, _np.int64)
        self.g_actor = _np.empty(n_i, _np.int32)
        self.g_elem = _np.empty(n_i, _np.int64)
        lib.amst_fill_append(h, _p64(self.g_obj), _p64(self.g_local),
                             _p64(self.g_parent), _p32(self.g_actor),
                             _p64(self.g_elem))
        self.order = _np.empty(n_a, _np.int64)
        self.r_seg = _np.empty(n_a, _np.int32)
        lib.amst_fill_order(h, _p64(self.order), _p32(self.r_seg))
        self.touched = _np.empty(F, _np.int64)
        lib.amst_fill_fields(h, _p64(self.touched))
        self.dirty = _np.empty(K, _np.int64)
        self.n_j = _np.empty(K, _np.int64)
        self.new_cnt = _np.empty(K, _np.int64)
        lib.amst_fill_dirty(h, _p64(self.dirty), _p64(self.n_j),
                            _p64(self.new_cnt))

    def fill_dplanes(self, d_parent, d_elemc, d_actor, d_pos,
                     job_start, n_j_arr):
        """Write the new-node planes + job table into pre-padded
        caller arrays (d_pos must be pre-filled with the cap
        sentinel)."""
        self._lib.amst_fill_dplanes(
            self._h, _p32(d_parent), _p32(d_elemc), _p32(d_actor),
            _p32(d_pos), _p32(job_start), _p32(n_j_arr))

    def fill_wire(self, wire, cap, d_pad, n_pad, K, nnz_pad, m_pad,
                  ranks):
        """Write the packed program's wire buffer (all sections except
        the three admission-clock COO sections, which the caller
        owns)."""
        self._lib.amst_fill_wire(
            self._h, wire.ctypes.data_as(_PU8), cap, d_pad, n_pad, K,
            nnz_pad, m_pad, _p64(ranks))

    def fill_wire_wide(self, wire, cap, d_pad, n_pad, K, nnz_pad,
                       m_pad):
        """Write the WIDE packed program's wire buffer (same contract
        as :meth:`fill_wire`; the wide words carry stable actor ids,
        so no rank table crosses the boundary)."""
        self._lib.amst_fill_wire_wide(
            self._h, wire.ctypes.data_as(_PU8), cap, d_pad, n_pad, K,
            nnz_pad, m_pad)

    def __del__(self):
        h = getattr(self, '_h', None)
        if h:
            self._lib.amst_free(h)
            self._h = None


def stage_general_block(block, chg_local, a_tab, k_tab, omap, root_row,
                        obj_doc, obj_type, pool, b_actor, n_old_mirror,
                        obj_uuid=None, elem_cache=None):
    """Run the native stager over an admitted general block.

    Returns a :class:`GeneralStagedPlanes`, ``None`` when the library
    is unavailable or the stager requests the numpy fallback
    (late-bound string elemIds), or raises exactly the staging error
    the numpy path would raise (same type, same message).
    ``obj_uuid`` is the store's object-uuid table (error messages).
    ``elem_cache`` is the pool's persistent elem index (obj ->
    [sorted int64 keys, aligned int64 locals]); cached objects skip
    the stager's per-object pos_sorted tabulation."""
    lib = stage_lib()
    if lib is None:
        return None
    n_of = _np.ascontiguousarray(pool.n_of, _np.int64)
    max_elem_of = _np.ascontiguousarray(pool.max_elem_of, _np.int64)
    keep = (block, chg_local, a_tab, k_tab, omap, root_row, obj_doc,
            obj_type, n_of, max_elem_of, pool.pos_sorted, pool.pos_row,
            pool.obj, pool.local, pool.actor, pool.elemc, pool.parent,
            b_actor)
    n_cache = 0
    c_objs = c_lens = c_keys = c_locs = _np.empty(0, _np.int64)
    if elem_cache and len(elem_cache) <= 4096:
        objs = sorted(elem_cache)
        ents = [elem_cache[o] for o in objs]
        c_objs = _np.asarray(objs, _np.int64)
        c_lens = _np.asarray([len(e[0]) for e in ents], _np.int64)
        c_keys = _np.asarray([e[0].ctypes.data for e in ents], _np.int64)
        c_locs = _np.asarray([e[1].ctypes.data for e in ents], _np.int64)
        n_cache = len(objs)
        keep = keep + (ents, c_objs, c_lens, c_keys, c_locs)
    h = lib.amst_stage_general(
        block.n_ops, _p8(block.action), _p32(block.obj),
        _p8(block.key_kind), _p32(block.key), _p32(block.key_elem),
        _p32(block.elem),
        block.n_changes, _p32(block.op_ptr), _p32(block.doc),
        _p32(block.seq), _p32(b_actor), _p32(chg_local),
        _p32(a_tab), _p32(k_tab),
        _p64(omap), _p64(root_row), _p32(obj_doc), _p32(obj_type),
        len(obj_doc),
        _p64(n_of), _p64(max_elem_of),
        _p64(pool.pos_sorted), _p64(pool.pos_row), pool.n_nodes,
        _p32(pool.obj), _p32(pool.local), _p32(pool.actor),
        _p32(pool.elemc), _p32(pool.parent),
        n_old_mirror,
        n_cache, _p64(c_objs), _p64(c_lens), _p64(c_keys),
        _p64(c_locs))
    if not h:
        raise MemoryError('native staging allocation failed')
    err = int(lib.amst_err(h))
    if err:
        payload = int(lib.amst_err_payload(h))
        lib.amst_free(h)
        exc, msg = _STAGE_ERRORS[err]
        if err == 1:        # payload = block obj table index
            msg = msg.format(obj=block.objs[payload])
        elif err == 2:      # payload = store object row
            msg = msg.format(
                uuid=obj_uuid[payload] if obj_uuid is not None
                else '<object>')
        raise exc(msg)
    if lib.amst_fallback(h):
        lib.amst_free(h)
        return None
    return GeneralStagedPlanes(lib, h, keep)


# ---------------------------------------------------------------------------
# Native columnar v2/v3 codec (the amwe_emit_columnar[_v3] /
# amst_parse_columnar[_v3] entry points of libamwire.so): the JSON-free
# binary wire format. Emit returns varint column bodies plus per-change
# global ref lists — the host maps refs to tagged literal bytes
# (wire.py), so the Python fallback is byte-identical by construction.
# Parse fills the same Parsed struct the JSON parsers fill (extracted
# via the amwc_* accessors in wire._extract_block). v3 adds RLE on the
# action and obj columns; the session string-table layer lives entirely
# host-side (wire.py), so the C boundary is unchanged beyond the two
# extra symbols.

_COLUMNAR_LIB = None
_COLUMNAR_ATTEMPTED = False

_COL_EMIT_ARGTYPES = [
    _i64, _P64,                                  # rows
    _P32, _P32, _P32, _P32, _P32,                # change columns
    _P32, _P8, _P32, _P8, _P32, _P32, _P32,      # op columns
    _P32]                                        # value column


def _bind_columnar(lib):
    for emit in (lib.amwe_emit_columnar, lib.amwe_emit_columnar_v3):
        emit.argtypes = _COL_EMIT_ARGTYPES
        emit.restype = ctypes.c_void_p
    lib.amwe_col_bytes.argtypes = [ctypes.c_void_p]
    lib.amwe_col_bytes.restype = _i64
    lib.amwe_col_refs.argtypes = [ctypes.c_void_p]
    lib.amwe_col_refs.restype = _i64
    lib.amwe_col_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  _P64, _P64, _P64]
    lib.amwe_col_fill.restype = None
    lib.amwe_col_free.argtypes = [ctypes.c_void_p]
    lib.amwe_col_free.restype = None
    for parse in (lib.amst_parse_columnar, lib.amst_parse_columnar_v3):
        parse.argtypes = [ctypes.c_char_p, _i64]
        parse.restype = ctypes.c_void_p
    return lib


def columnar_lib():
    """The columnar v2/v3 codec library, or None (no native codec /
    stale binary without the columnar symbols /
    AUTOMERGE_TPU_NATIVE_COLUMNAR=0)."""
    global _COLUMNAR_LIB, _COLUMNAR_ATTEMPTED
    if _COLUMNAR_ATTEMPTED:
        return _COLUMNAR_LIB
    _COLUMNAR_ATTEMPTED = True
    if os.environ.get('AUTOMERGE_TPU_NATIVE_COLUMNAR', '1') == '0':
        return None
    # through the wire module: it binds the parse entry points that
    # share this handle (the columnar parse reads its results with them)
    from . import wire as _wire
    lib = _wire._load()
    if lib is None:
        return None
    try:
        _COLUMNAR_LIB = _bind_columnar(lib)
    except AttributeError:
        _COLUMNAR_LIB = None         # stale .so predating the codec
    return _COLUMNAR_LIB


def columnar_available():
    return columnar_lib() is not None


def columnar_v3_available():
    """_bind_columnar binds the v2 and v3 symbols together (a stale
    .so missing either fails the whole bind), so v3 availability is
    the same predicate — kept distinct so CI can assert the v3 emit/
    parse arms by name."""
    lib = columnar_lib()
    return lib is not None and \
        hasattr(lib, 'amwe_emit_columnar_v3') and \
        hasattr(lib, 'amst_parse_columnar_v3')


def emit_columnar_rows(block, rows_arr):
    """Native columnar v2 emit of general-block change rows: one
    ``(body bytes, global ref list)`` per row, or None when the library
    is unavailable (the caller falls back to the Python emitter)."""
    return _emit_columnar_rows(block, rows_arr, 'amwe_emit_columnar')


def emit_columnar_rows_v3(block, rows_arr):
    """Native columnar v3 emit (RLE action/obj columns) — same contract
    as :func:`emit_columnar_rows`."""
    return _emit_columnar_rows(block, rows_arr, 'amwe_emit_columnar_v3')


def _emit_columnar_rows(block, rows_arr, sym):
    lib = columnar_lib()
    if lib is None:
        return None
    h = getattr(lib, sym)(
        len(rows_arr), _p64(rows_arr),
        _p32(block.actor), _p32(block.seq),
        _p32(block.dep_ptr), _p32(block.dep_actor),
        _p32(block.dep_seq),
        _p32(block.op_ptr), _p8(block.action), _p32(block.obj),
        _p8(block.key_kind), _p32(block.key), _p32(block.key_elem),
        _p32(block.elem), _p32(block.value))
    if not h:
        raise MemoryError('native columnar emit allocation failed')
    try:
        nbytes = int(lib.amwe_col_bytes(h))
        n_refs = int(lib.amwe_col_refs(h))
        buf = ctypes.create_string_buffer(max(nbytes, 1))
        body_off = _np.empty(len(rows_arr) + 1, _np.int64)
        refs = _np.empty(max(n_refs, 1), _np.int64)
        refs_off = _np.empty(len(rows_arr) + 1, _np.int64)
        lib.amwe_col_fill(h, buf, _p64(body_off), _p64(refs),
                          _p64(refs_off))
        raw = buf.raw[:nbytes]
    finally:
        lib.amwe_col_free(h)
    return [(raw[body_off[i]:body_off[i + 1]],
             refs[refs_off[i]:refs_off[i + 1]].tolist())
            for i in range(len(rows_arr))]
