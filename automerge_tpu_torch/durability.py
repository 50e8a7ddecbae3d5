"""Crash-consistent persistence: atomic checksummed snapshots + a WAL.

`snapshot.py` gives O(state) resume artifacts but leaves the file layer
to the caller — a process killed mid-`write()` leaves a truncated JSON
blob that used to die in a ``KeyError`` on the next boot, and every
change applied since the last checkpoint was simply gone. This module
is the database-grade split the snapshot docstring already cites
(checkpoint + WAL, Demers-style anti-entropy repairs the network side):

- :func:`atomic_write_bytes` — tmp file + fsync + rename (+ directory
  fsync), so a snapshot file is either the complete old artifact or the
  complete new one, never a torn mix.
- A checksummed container (:func:`pack_snapshot` /
  :func:`unpack_snapshot`): magic + length + CRC32 header over the
  payload; truncation and bit-rot both surface as a clean
  :class:`~automerge_tpu_torch.snapshot.SnapshotCorruptError` (and bump the
  ``snapshot_checksum_failures`` counter), never a decode crash.
- :class:`ChangeJournal` — an append-only change log with per-record
  length + CRC framing. Appends are fsync'd; replay stops cleanly at a
  torn tail (the record a crash interrupted), so recovery is snapshot +
  journal-tail replay. Replayed changes that the snapshot already
  covers are dropped by the engines' duplicate tolerance — the replay
  is idempotent, so "journal first, then apply" needs no two-phase
  bookkeeping.
- :class:`DurableDocSet` — the wiring: wraps a snapshot-capable DocSet
  (e.g. :class:`~automerge_tpu_torch.sync.general_doc_set.GeneralDocSet`),
  journals every applied batch before applying, checkpoints the fleet
  atomically, and :meth:`recover`\\ s from snapshot + tail after a
  crash. The chaos suite kills a peer mid-run and resumes it from this
  path (`tests/test_chaos.py`).

The PyTorch port's copy of ``automerge_tpu/durability.py`` (host code;
the same file formats).
"""

import json
import os
import re
import struct
import time
import zlib

from .snapshot import SnapshotCorruptError
from .utils.metrics import metrics

SNAP_MAGIC = b'AMTPU-SNAP1\n'
_REC_HEADER = struct.Struct('>II')           # payload length, CRC32


def _fsync_dir(path):
    """fsync the directory entry so a rename survives power loss (a
    no-op on platforms without directory fds)."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or '.',
                     os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` atomically: tmp file in the same
    directory + fsync + rename + directory fsync. Readers see either
    the previous complete file or the new complete file."""
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def pack_snapshot(payload):
    """Frame snapshot ``payload`` (bytes or str) in the checksummed
    container: magic, big-endian length, CRC32, payload."""
    if isinstance(payload, str):
        payload = payload.encode()
    return (SNAP_MAGIC +
            _REC_HEADER.pack(len(payload), zlib.crc32(payload)) +
            payload)


def unpack_snapshot(data):
    """Validate a :func:`pack_snapshot` container and return the
    payload bytes. Truncation, bad magic and checksum mismatch each
    raise :class:`SnapshotCorruptError` naming the failure; checksum
    mismatches also bump ``snapshot_checksum_failures``."""
    head = len(SNAP_MAGIC) + _REC_HEADER.size
    if len(data) < head:
        raise SnapshotCorruptError(
            f'snapshot container truncated: {len(data)} bytes, header '
            f'needs {head}')
    if data[:len(SNAP_MAGIC)] != SNAP_MAGIC:
        raise SnapshotCorruptError('snapshot container has bad magic '
                                   '(not an AMTPU-SNAP1 file)')
    length, crc = _REC_HEADER.unpack_from(data, len(SNAP_MAGIC))
    payload = data[head:head + length]
    if len(payload) < length:
        raise SnapshotCorruptError(
            f'snapshot container truncated: payload {len(payload)} of '
            f'{length} bytes')
    if zlib.crc32(payload) != crc:
        metrics.bump('snapshot_checksum_failures')
        raise SnapshotCorruptError(
            'snapshot payload checksum mismatch (bit rot or torn '
            'write)')
    return payload


def write_snapshot_file(path, payload):
    """Atomically persist a snapshot payload in the checksummed
    container."""
    atomic_write_bytes(path, pack_snapshot(payload))


# -- parked-doc shards (cold-doc eviction / quarantine parking) ---------------

PARK_FORMAT = 'automerge-tpu-parked-docs@1'
# tiered container (ISSUE 12): a v2 shard's payloads may carry a
# base64-armored per-doc STATE snapshot ('state') in place of — or, for
# a compacted doc, instead of — the full change history ('changes').
# v1 shards (full-log payloads only) keep writing byte-identically, and
# the reader accepts both versions.
PARK_FORMAT_V2 = 'automerge-tpu-parked-docs@2'


def write_park_shard(path, docs):
    """Persist one eviction batch's parked docs as a checksummed shard:
    ``docs`` is ``{doc_id: payload}`` where each payload carries the
    doc's ``clock``, buffered ``queued`` changes, an optional
    ``quarantine`` record and either its full change history
    (``changes``) or a base64-armored state snapshot (``state`` — the
    tiered form for compacted docs). Written atomically — a parked
    doc's shard is the doc's ONLY durable copy once a checkpoint
    snapshots the fleet without it. Full-log-only shards keep the v1
    format stamp (byte-compatible with pre-tier readers)."""
    tiered = any(isinstance(p, dict) and p.get('state') is not None
                 for p in docs.values())
    atomic_write_bytes(path, pack_snapshot(json.dumps(
        {'format': PARK_FORMAT_V2 if tiered else PARK_FORMAT,
         'docs': docs},
        separators=(',', ':'))))


def read_park_shard(path):
    """Load a :func:`write_park_shard` artifact (either container
    version); returns the ``{doc_id: payload}`` map. Raises
    :class:`~automerge_tpu_torch.snapshot.SnapshotCorruptError` naming the
    failure on truncation/bit rot/format mismatch."""
    with open(path, 'rb') as f:
        payload = unpack_snapshot(f.read())
    try:
        obj = json.loads(payload)
    except ValueError as err:
        raise SnapshotCorruptError(
            f'park shard is not valid JSON ({err})') from None
    if not isinstance(obj, dict) or \
            obj.get('format') not in (PARK_FORMAT, PARK_FORMAT_V2):
        raise SnapshotCorruptError('not a parked-docs shard')
    docs = obj.get('docs')
    if not isinstance(docs, dict):
        raise SnapshotCorruptError(
            "park shard: missing field 'docs'")
    return docs


def read_snapshot_file(path):
    """Read + validate a :func:`write_snapshot_file` artifact."""
    with open(path, 'rb') as f:
        return unpack_snapshot(f.read())


# -- flight-recorder incident files -------------------------------------------

def dump_incident(recorder, dir_path, kind, **meta):
    """Dump a :class:`~automerge_tpu_torch.utils.metrics.FlightRecorder`'s
    retained events to ``<dir_path>/incidents/incident-<seq>-<kind>.
    jsonl`` — ONE file per incident, written through
    :func:`atomic_write_bytes` like any snapshot, so an incident file
    is never torn. A trigger record (``event='incident'`` with
    ``kind`` + ``meta``) is the file's guaranteed LAST line, so the
    file itself names what fired it. Returns the path."""
    inc_dir = os.path.join(dir_path, 'incidents')
    os.makedirs(inc_dir, exist_ok=True)
    # max existing seq + 1, NOT file count + 1: an operator pruning an
    # old incident must never make the next dump overwrite a newer one
    seq = 1 + max(
        (int(m.group(1)) for m in
         (re.match(r'incident-(\d+)-.*\.jsonl$', n)
          for n in os.listdir(inc_dir)) if m),
        default=0)
    path = os.path.join(inc_dir, f'incident-{seq:04d}-{kind}.jsonl')
    trigger = {'event': 'incident', 'kind': kind, 'ts': time.time(),
               'mono': time.perf_counter(), **meta}
    # the trigger rides to the file as dump()'s locally-appended last
    # line — appending it to the shared ring FIRST would let a
    # concurrent emit (the async applier thread) land after it and
    # displace it from the tail. The ring still gets the mark (below)
    # so later incidents' files show this one in their history.
    recorder.dump(path, trigger=trigger)
    recorder(trigger)
    metrics.bump('incidents_dumped')
    return path


def load_incident(path):
    """Read a :func:`dump_incident` file back: ``(events, trigger)``
    where ``trigger`` is the final ``event='incident'`` record naming
    what fired the dump (None for a pre-trigger or hand-made file).
    The inverse operators and tools consume — ``tools/trace_report.py``
    turns the same lines into a Chrome-trace file."""
    events = []
    with open(path, 'r', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    trigger = events[-1] if events and \
        events[-1].get('event') == 'incident' else None
    return events, trigger


class ChangeJournal:
    """Append-only change journal with per-record length+CRC framing.

    One record per applied batch: ``{'changes': {doc_id: [change,
    ...]}}`` as JSON, preceded by an 8-byte length+CRC header. Appends
    fsync by default (crash consistency is the point; pass
    ``fsync=False`` to trade safety for throughput). :meth:`replay`
    yields the decoded records and STOPS at the first invalid one — a
    crash can only tear the tail, so everything before it is intact; a
    mid-file CRC mismatch (bit rot) also stops replay but is counted
    under ``snapshot_checksum_failures``."""

    def __init__(self, path, fsync=True):
        self.path = path
        self.fsync = fsync
        self._f = open(path, 'ab')
        # memory accounting: journal file bytes (gauge + watermark) —
        # an append-only WAL that never checkpoints is a disk leak a
        # dashboard should see long before the filesystem does
        self.bytes = self._f.tell()
        self._publish_bytes()

    def _publish_bytes(self):
        metrics.set_gauge('mem_journal_bytes', self.bytes)
        metrics.ratchet('mem_journal_peak_bytes', self.bytes)

    def append(self, record):
        payload = json.dumps(record, separators=(',', ':')).encode()
        self._f.write(_REC_HEADER.pack(len(payload),
                                       zlib.crc32(payload)) + payload)
        self.bytes += _REC_HEADER.size + len(payload)
        self._publish_bytes()
        self._f.flush()
        if self.fsync:
            # journal fsync is the durable write path's latency floor:
            # the observe series feeds quantile('journal_fsync_ms')
            # for fleet_status() and the bench's p50/p99 keys
            t0 = time.perf_counter()
            os.fsync(self._f.fileno())
            metrics.observe('journal_fsync_ms',
                            (time.perf_counter() - t0) * 1e3)

    def close(self):
        self._f.close()

    def reset(self):
        """Truncate after a checkpoint: the snapshot now covers every
        journaled record."""
        self._f.truncate(0)
        self._f.seek(0)
        self.bytes = 0
        self._publish_bytes()
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    @classmethod
    def replay(cls, path):
        """Yield every intact record of the journal at ``path`` in
        append order, tolerating a torn tail."""
        for record, _ in cls._scan(path):
            yield record

    @classmethod
    def _scan(cls, path):
        """Yield ``(record, end_offset)`` for every intact record — the
        offset lets recovery TRUNCATE a torn/corrupt tail, so records
        appended after a recovery are not stranded behind it."""
        try:
            with open(path, 'rb') as f:
                data = f.read()
        except FileNotFoundError:
            return
        pos = 0
        while pos + _REC_HEADER.size <= len(data):
            length, crc = _REC_HEADER.unpack_from(data, pos)
            payload = data[pos + _REC_HEADER.size:
                           pos + _REC_HEADER.size + length]
            if len(payload) < length:
                return                       # torn tail: crash mid-append
            if zlib.crc32(payload) != crc:
                metrics.bump('snapshot_checksum_failures')
                return                       # bit rot: stop before it
            try:
                record = json.loads(payload)
            except ValueError:
                metrics.bump('snapshot_checksum_failures')
                return
            pos += _REC_HEADER.size + length
            yield record, pos


class DurableDocSet:
    """Crash-consistent wrapper around a snapshot-capable DocSet.

    Every :meth:`apply_changes_batch` appends the batch to the journal
    BEFORE applying (WAL ordering; replay is idempotent thanks to the
    engines' duplicate tolerance), :meth:`checkpoint` writes the
    fleet's packed snapshot atomically and truncates the journal, and
    :meth:`recover` rebuilds snapshot + journal tail after a crash.
    Everything else (``get_doc``, ``register_handler``, materialize,
    ...) proxies to the wrapped DocSet, so a
    :class:`~automerge_tpu_torch.sync.connection.Connection` can be handed
    the durable wrapper directly."""

    SNAPSHOT_FILE = 'snapshot.amtpu'
    JOURNAL_FILE = 'journal.amtpu'

    def __init__(self, doc_set, dir_path, fsync=True):
        os.makedirs(dir_path, exist_ok=True)
        self.doc_set = doc_set
        self.dir_path = dir_path
        self.journal = ChangeJournal(
            os.path.join(dir_path, self.JOURNAL_FILE), fsync=fsync)

    # -- the durable write path ---------------------------------------------

    def apply_changes_batch(self, changes_by_doc, **kwargs):
        self.journal.append({'changes': changes_by_doc})
        return self.doc_set.apply_changes_batch(changes_by_doc,
                                                **kwargs)

    applyChangesBatch = apply_changes_batch

    def apply_changes(self, doc_id, changes):
        self.journal.append({'changes': {doc_id: changes}})
        return self.doc_set.apply_changes(doc_id, changes)

    applyChanges = apply_changes

    def apply_wire(self, data, doc_ids=None):
        """WAL the wire path too, so it replays byte-identically
        (without this, changes acknowledged over a WireConnection
        would vanish in a crash — the dict path was journaled, the
        columnar path was not). v1 payloads are UTF-8 JSON and journal
        as text; columnar v2/v3 containers are binary and journal
        base64-armored (the journal record framing is JSON)."""
        from .wire import COLUMNAR_MAGIC, COLUMNAR_MAGIC_V3
        if isinstance(data, (bytes, bytearray)) and \
                bytes(data[:4]) in (COLUMNAR_MAGIC, COLUMNAR_MAGIC_V3):
            import base64
            self.journal.append(
                {'wireb64': base64.b64encode(bytes(data)).decode(
                    'ascii'), 'docs': doc_ids})
        else:
            if isinstance(data, (bytes, bytearray)):
                text = bytes(data).decode('utf-8')
            else:
                text = data
            self.journal.append({'wire': text, 'docs': doc_ids})
        return self.doc_set.apply_wire(data, doc_ids=doc_ids)

    applyWire = apply_wire

    def apply_states(self, payload_by_doc):
        """WAL the state-bootstrap path (tiered doc storage): an
        absorbed state snapshot must survive a crash exactly like an
        acknowledged change — the binary payloads journal
        base64-armored and replay through ``apply_states`` on
        recover."""
        import base64
        self.journal.append(
            {'states': {doc_id: base64.b64encode(
                bytes(payload)).decode('ascii')
                for doc_id, payload in payload_by_doc.items()}})
        return self.doc_set.apply_states(payload_by_doc)

    applyStates = apply_states

    def apply_state(self, doc_id, payload):
        return self.apply_states({doc_id: payload}).get(doc_id)

    applyState = apply_state

    def checkpoint(self):
        """Atomic fleet checkpoint: packed snapshot to a tmp file,
        fsync, rename, THEN journal truncate — a crash between the two
        replays already-checkpointed changes, which the duplicate
        tolerance drops."""
        write_snapshot_file(
            os.path.join(self.dir_path, self.SNAPSHOT_FILE),
            self.doc_set.save_snapshot())
        self.journal.reset()

    def close(self):
        self.journal.close()

    @classmethod
    def recover(cls, dir_path, doc_set_factory, load_snapshot=None,
                fsync=True, flight_recorder=None):
        """Rebuild after a crash: load the checkpoint if one exists
        (``load_snapshot(payload_bytes)``), else start from
        ``doc_set_factory()``, then replay the journal tail through
        ``apply_changes_batch``. Returns the new :class:`DurableDocSet`
        (its journal keeps the replayed tail until the next
        :meth:`checkpoint`). With a ``flight_recorder`` (subscribed to
        the metrics bus before the call), the recovery dumps the
        recorder's retained pre-crash/replay events as an incident
        file under ``<dir_path>/incidents/`` — the black box of what
        happened in the seconds before the crash."""
        snap_path = os.path.join(dir_path, cls.SNAPSHOT_FILE)
        doc_set = None
        if load_snapshot is not None and os.path.exists(snap_path):
            doc_set = load_snapshot(read_snapshot_file(snap_path))
        if doc_set is None:
            doc_set = doc_set_factory()
        journal_path = os.path.join(dir_path, cls.JOURNAL_FILE)
        # journaled batches may include a poisoned doc (the journal is
        # written BEFORE the apply): replay under per-doc isolation
        # when the doc set supports it, so recovery re-quarantines the
        # poison instead of dying on it
        kwargs = {'isolate': True} \
            if hasattr(doc_set, 'quarantined') else {}
        valid_end = 0
        n_replayed = 0
        for record, end in ChangeJournal._scan(journal_path):
            n_replayed += 1
            if 'states' in record:
                # state-bootstrap records (tiered doc storage) replay
                # through the same absorb path; apply_states isolates
                # per doc internally
                import base64
                doc_set.apply_states(
                    {doc_id: base64.b64decode(b64)
                     for doc_id, b64 in record['states'].items()})
            elif 'wire' in record or 'wireb64' in record:
                # wire-path record: replay the raw payload through the
                # fused path; a poisoned doc falls back to the dict
                # batch under per-doc isolation (the fused apply rolls
                # back store-intact), exactly like WireConnection
                if 'wireb64' in record:
                    import base64
                    raw = base64.b64decode(record['wireb64'])
                else:
                    raw = record['wire'].encode('utf-8')
                try:
                    doc_set.apply_wire(raw, doc_ids=record['docs'])
                except Exception:
                    if 'wireb64' in record:
                        from .wire import columnar_container_to_changes
                        per_doc = columnar_container_to_changes(raw)
                    else:
                        per_doc = json.loads(record['wire'])
                    doc_set.apply_changes_batch(
                        dict(zip(record['docs'] or
                                 [f'doc-{i}'
                                  for i in range(len(per_doc))],
                                 per_doc)), **kwargs)
            else:
                doc_set.apply_changes_batch(record['changes'],
                                            **kwargs)
            valid_end = end
        # drop the torn/corrupt tail NOW: appends after recovery must
        # land on a replayable journal, not be stranded behind garbage
        # a second crash would stop the next replay at
        try:
            if os.path.getsize(journal_path) > valid_end:
                with open(journal_path, 'r+b') as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
        except FileNotFoundError:
            pass
        out = cls.__new__(cls)
        out.doc_set = doc_set
        out.dir_path = dir_path
        out.journal = ChangeJournal(journal_path, fsync=fsync)
        if flight_recorder is not None:
            dump_incident(flight_recorder, dir_path, 'recovery',
                          replayed_records=n_replayed)
        return out

    # -- proxy --------------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.doc_set, name)
