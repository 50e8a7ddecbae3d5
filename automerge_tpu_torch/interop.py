"""Read-only save-file interop: reference transit-JSON saves -> changes.

The reference lineage serializes a document with ``Automerge.save(doc)``
as the transit-JS encoding of its Immutable.js change history (a List of
change Maps) — this framework's own save format is different by design
(packed columnar snapshots + a JSON change log; see README "Snapshots &
persistence"). The WIRE format is shared (per-change JSON, proven by the
conformance suite), so interop only needs the container decoded:
:func:`load_reference_save` turns a reference save blob into the plain
change list the existing replay edges consume
(``GeneralDocSet.apply_changes`` / the per-doc backend) — a one-way
door, import only.

The decoder covers the transit subset transit-immutable-js actually
emits for a change history: ground JSON values, ``["^ ", k, v, ...]``
maps, tagged values ``["~#tag", rep]`` for Immutable List/Map/Set
(``iL``/``iM``/``iO``/``iS``), ``~``-escaped scalar strings
(``~~``/``~:keyword``/``~i<int>``/``~d<float>``), and the write cache
(``"^<code>"`` back-references over cacheable strings: map keys and
``~``-prefixed strings of length >= 4, in first-occurrence order).
Anything outside that subset raises :class:`ReferenceSaveError` naming
the construct — a corrupt or newer-format save fails loudly, never as a
silently wrong document.

The PyTorch port's copy of ``automerge_tpu/interop.py``.
"""

import json

_CACHE_DIGITS = 44          # transit-js CACHE_CODE_DIGITS
_BASE_CHAR = 48             # codes start at '0'


class ReferenceSaveError(ValueError):
    """A reference save blob failed to decode (not transit-JSON, an
    unsupported transit construct, or not a change history)."""


def _code_to_index(code):
    """Inverse of transit-js indexToCode: '^X' -> cache index."""
    if len(code) == 1:
        return ord(code) - _BASE_CHAR
    if len(code) == 2:
        return (ord(code[0]) - _BASE_CHAR) * _CACHE_DIGITS + \
            (ord(code[1]) - _BASE_CHAR)
    raise ReferenceSaveError(f'malformed transit cache code ^{code}')


class _TransitReader:
    """One-pass transit-JSON decoder (read cache included)."""

    def __init__(self):
        self.cache = []

    def _resolve(self, s, as_key):
        """Cache machinery for one string as written: back-references
        resolve, cacheable first occurrences append. The reader must
        mirror the writer's cache EXACTLY or every later ^code is
        off-by-N — transit-js isCacheable: length >= 4 AND (map key,
        or one of the '~:' keyword / '~$' symbol / '~#' tag prefixes;
        typed scalars like '~i<long int>' are NOT cached)."""
        if s.startswith('^') and s != '^ ':
            idx = _code_to_index(s[1:])
            if idx >= len(self.cache):
                raise ReferenceSaveError(
                    f'transit cache reference ^{s[1:]} before '
                    f'definition')
            return self.cache[idx]
        if len(s) >= 4 and (as_key or
                            (s[0] == '~' and s[1] in ':$#')):
            self.cache.append(s)
        return s

    def _decode_str(self, s):
        if not s.startswith('~'):
            return s
        tag = s[1] if len(s) > 1 else ''
        if tag in ('~', '^', '`'):
            return s[1:]
        if tag in (':', '$'):
            return s[2:]                 # keyword/symbol -> plain str
        if tag == 'i':
            return int(s[2:])
        if tag in ('d', 'f'):
            return float(s[2:])
        if tag == '_':
            return None
        if tag == '?':
            return s[2:] == 't'
        if tag == '#':
            return s                     # tag heads handled by read()
        raise ReferenceSaveError(
            f'unsupported transit scalar {s!r}')

    def _read_scalar(self, s, as_key):
        return self._decode_str(self._resolve(s, as_key))

    def _tagged(self, tag, rep):
        if tag in ('iL', 'iS', 'iOS', 'list', 'set'):
            return list(rep)
        if tag in ('iM', 'iO', 'iOM'):
            if len(rep) % 2:
                raise ReferenceSaveError(
                    f'transit map rep of odd length {len(rep)}')
            return {rep[i]: rep[i + 1] for i in range(0, len(rep), 2)}
        if tag == "'":
            return rep                   # top-level scalar quote
        raise ReferenceSaveError(f'unsupported transit tag ~#{tag}')

    def read(self, node, as_key=False):
        if isinstance(node, str):
            return self._read_scalar(node, as_key)
        if isinstance(node, list):
            if not node:
                return []
            head = node[0]
            if isinstance(head, str):
                if head == '^ ':
                    items = node[1:]
                    if len(items) % 2:
                        raise ReferenceSaveError(
                            'transit map-as-array of odd length')
                    out = {}
                    for i in range(0, len(items), 2):
                        k = self.read(items[i], as_key=True)
                        out[k] = self.read(items[i + 1])
                    return out
                resolved = self._resolve(head, as_key=False)
                if resolved.startswith('~#'):
                    if len(node) != 2:
                        raise ReferenceSaveError(
                            f'tagged value {resolved!r} without a '
                            f'single rep')
                    return self._tagged(resolved[2:],
                                        self.read(node[1]))
                return [self._decode_str(resolved)] + \
                    [self.read(x) for x in node[1:]]
            return [self.read(x) for x in node]
        if isinstance(node, dict):
            # verbose-mode map (writer('json-verbose')): accepted too
            return {self._read_scalar(k, True): self.read(v)
                    for k, v in node.items()}
        return node                      # number / bool / null


_SUPPORTED_ACTIONS = {'set', 'del', 'ins', 'link',
                      'makeMap', 'makeList', 'makeText'}


def _normalize_change(change, i):
    if not isinstance(change, dict):
        raise ReferenceSaveError(
            f'change {i} decoded to {type(change).__name__}, not a '
            f'map')
    for field in ('actor', 'seq', 'ops'):
        if field not in change:
            raise ReferenceSaveError(
                f"change {i} is missing '{field}'")
    ops = change['ops']
    if not isinstance(ops, list):
        raise ReferenceSaveError(f'change {i} ops is not a list')
    for op in ops:
        if not isinstance(op, dict):
            raise ReferenceSaveError(f'change {i} op is not a map')
        action = op.get('action')
        if action not in _SUPPORTED_ACTIONS:
            raise ReferenceSaveError(
                f'change {i} carries unsupported op action '
                f'{action!r} (reference tables/rich-text era saves '
                f'are out of scope)')
    out = {'actor': change['actor'], 'seq': int(change['seq']),
           'deps': dict(change.get('deps') or {}), 'ops': ops}
    if 'message' in change:
        out['message'] = change['message']
    return out


def load_reference_save(blob):
    """Decode a reference-lineage ``Automerge.save`` blob (transit-JSON
    change history) into a plain change list, ready for the existing
    replay edges::

        changes = load_reference_save(open('doc.save').read())
        doc_set.apply_changes('imported', changes)

    Accepts ``str`` or ``bytes``. Raises :class:`ReferenceSaveError`
    on anything that is not a supported save (with the offending
    construct named). Import only — this framework saves its own
    packed snapshot format; see the README compat matrix.
    """
    if isinstance(blob, (bytes, bytearray)):
        try:
            blob = bytes(blob).decode('utf-8')
        except UnicodeDecodeError as err:
            raise ReferenceSaveError(
                f'reference save is not UTF-8 ({err})') from None
    try:
        node = json.loads(blob)
    except ValueError as err:
        raise ReferenceSaveError(
            f'reference save is not valid JSON ({err})') from None
    decoded = _TransitReader().read(node)
    if not isinstance(decoded, list):
        raise ReferenceSaveError(
            f'reference save decoded to {type(decoded).__name__}, '
            f'not a change list')
    return [_normalize_change(c, i) for i, c in enumerate(decoded)]


loadReferenceSave = load_reference_save
