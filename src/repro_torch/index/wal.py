"""Mutation write-ahead log: crash-safe durability for the live index
(a copy of ``repro.index.wal``, which is NumPy only: the on-disk format,
the op codes and the replay rules are the reference's, byte for byte, so
a log written by either package replays in the other).

Every ``LiveIndex`` mutation (``add``/``delete``/``merge_delta``)
appends one fsync'd record *before* the in-memory state changes, so a
process killed at any mutation boundary can be rebuilt exactly:

    snapshot (IndexRegistry.save)  +  replay of records with
    seq > snapshot.seq             ==  the uncrashed LiveIndex

Replay is bit-identical — external ids are allocated sequentially from
the restored ``next_id``, cluster assignment is deterministic, and
``merge_delta`` is a pure function of (index, delta) state — so the
recovered index serves the same top-k ids, probe counts and φ history
as the run that never crashed (tests/test_torch_wal.py).

On-disk format (little-endian, append-only):

    file magic  ``EEWAL001`` (8 bytes)
    record      ``\\xa5Z`` | op u8 | seq u64 | payload_len u32 | crc32 u32
                | payload (``np.save`` bytes: f32 (m,d) vecs for add,
                  i64 ids for delete, empty for merge)

A crash mid-append leaves a truncated final record: replay drops the
torn tail and reports it.  A bad magic/CRC *before* the tail means real
corruption and raises :class:`WALCorruptError` with the file offset.

Epoch records (background re-clustering, ``repro_torch.index.rebuild``): a
rebuild brackets itself in the log with ``REBUILD_BEGIN`` /
``REBUILD_COMMIT`` / ``REBUILD_ABORT`` records (payload: i64
``[epoch, seq]``).  They are *fences*, not mutations — replay skips
them — but they drive two guarantees:

* ``REBUILD_COMMIT`` is the atomic publish point of the two-phase
  rebuild: the staged candidate snapshot becomes the recovery base the
  instant the commit record is durable (``IndexRegistry.recover``
  redoes the promote if the crash hit between commit and rename).
* An *open* epoch (``BEGIN`` without ``COMMIT``/``ABORT``) pins every
  record newer than its fence sequence: ``truncate_upto`` refuses to
  compact past it, so the catch-up replay that the rebuild needs can
  never lose records to a concurrent compaction.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

FILE_MAGIC = b"EEWAL001"
_REC_MAGIC = b"\xa5Z"
_HDR = struct.Struct("<2sBQII")          # magic, op, seq, len, crc

OP_ADD, OP_DELETE, OP_MERGE = 1, 2, 3
OP_REBUILD_BEGIN, OP_REBUILD_COMMIT, OP_REBUILD_ABORT = 4, 5, 6
_OP_NAMES = {OP_ADD: "add", OP_DELETE: "delete", OP_MERGE: "merge",
             OP_REBUILD_BEGIN: "rebuild_begin",
             OP_REBUILD_COMMIT: "rebuild_commit",
             OP_REBUILD_ABORT: "rebuild_abort"}
#: ops that mutate index state (replayed); the rest are epoch fences
MUTATION_OPS = (OP_ADD, OP_DELETE, OP_MERGE)
EPOCH_OPS = (OP_REBUILD_BEGIN, OP_REBUILD_COMMIT, OP_REBUILD_ABORT)


class WALCorruptError(RuntimeError):
    """The log is damaged beyond the tolerated torn tail."""


@dataclass(frozen=True)
class WALRecord:
    seq: int
    op: int
    payload: Optional[np.ndarray]        # None for merge

    @property
    def op_name(self) -> str:
        return _OP_NAMES[self.op]

    @property
    def epoch(self) -> Optional[int]:
        """Epoch number carried by a rebuild fence record (else None)."""
        if self.op in EPOCH_OPS and self.payload is not None \
                and self.payload.size:
            return int(np.asarray(self.payload).ravel()[0])
        return None


@dataclass
class ReplayReport:
    applied: int = 0
    skipped: int = 0
    torn_tail: bool = False
    last_seq: int = 0
    epoch_records: int = 0               # rebuild fences seen (not applied)
    rebuild_promoted: bool = False       # recover redid a commit's promote
    rebuild_aborted: bool = False        # recover aborted an open rebuild


def _encode_payload(arr: Optional[np.ndarray]) -> bytes:
    if arr is None:
        return b""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _decode_payload(raw: bytes) -> Optional[np.ndarray]:
    if not raw:
        return None
    return np.load(io.BytesIO(raw), allow_pickle=False)


class MutationWAL:
    """Append-only fsync'd mutation log (one writer, many readers).

    Group commit (high mutation rates): ``group_commit_n > 1`` defers
    the fsync until that many records are pending, ``group_commit_ms``
    until that much wall time has passed since the first pending
    record (checked on the next append/flush — the API is synchronous,
    there is no background flusher).  Records are still *written* (and
    OS-visible to ``scan``) immediately; only durability is batched.
    ``flush()`` forces the fsync, and is called automatically on
    ``close`` and before ``truncate_upto`` — callers force it at
    merge/snapshot boundaries so a snapshot never outruns its log.
    Crash semantics are unchanged: the tail of the file is at worst a
    batch of whole records plus one torn record, and replay already
    tolerates a torn tail; durable-loss is bounded by the group window
    instead of zero.  Defaults (``group_commit_n=1``) keep the classic
    fsync-per-append behavior.
    """

    def __init__(self, path: str, *, fsync: bool = True,
                 group_commit_n: int = 1, group_commit_ms: float = 0.0,
                 clock=None):
        import time as _time
        self.path = path
        self.fsync = fsync
        self.group_commit_n = max(1, int(group_commit_n))
        self.group_commit_ms = float(group_commit_ms)
        self._now = clock or _time.monotonic
        self._pending = 0            # records written but not fsync'd
        self._group_t0: Optional[float] = None
        self.fsyncs = 0              # accounting (tests/benchmarks)
        self.last_scan_torn = False
        self._durable_seq: Optional[int] = None   # see note_durable()
        size = os.path.getsize(path) if os.path.exists(path) else -1
        if 0 < size < len(FILE_MAGIC):
            # crash during creation: no record can fit, safe to reset
            os.truncate(path, 0)
            size = 0
        self._f = open(path, "ab")
        if size <= 0:
            self._f.write(FILE_MAGIC)
            self._sync()
        else:
            with open(path, "rb") as f:
                if f.read(len(FILE_MAGIC)) != FILE_MAGIC:
                    raise WALCorruptError(
                        f"{path}: bad file magic — not a mutation WAL "
                        f"(expected {FILE_MAGIC!r}); refusing to append")

    # -- write ---------------------------------------------------------------
    def _sync(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
            self.fsyncs += 1
        self._pending = 0
        self._group_t0 = None

    def append(self, op: int, seq: int,
               payload: Optional[np.ndarray] = None, *,
               force: bool = False) -> None:
        """Append one record.  ``force`` fsyncs regardless of the
        group-commit window (merge/snapshot boundaries)."""
        if op not in _OP_NAMES:
            raise ValueError(f"unknown WAL op {op}")
        raw = _encode_payload(payload)
        hdr = _HDR.pack(_REC_MAGIC, op, seq, len(raw), zlib.crc32(raw))
        self._f.write(hdr + raw)         # single write: tail is one record
        self._pending += 1
        if self._group_t0 is None:
            self._group_t0 = self._now()
        due = (force or self._pending >= self.group_commit_n
               or (self.group_commit_ms > 0
                   and (self._now() - self._group_t0) * 1000.0
                   >= self.group_commit_ms))
        if due:
            self._sync()
        else:
            self._f.flush()              # OS-visible, not yet durable

    def flush(self) -> None:
        """Force any pending group-commit batch to disk."""
        if self._pending:
            self._sync()
        else:
            self._f.flush()

    def note_durable(self, seq: int) -> None:
        """Record that a snapshot covering every record with sequence
        ``<= seq`` is durable on disk.  ``truncate_upto`` clamps its
        cut to this fence, so a caller passing a too-new sequence (a
        compaction racing a snapshot, or running mid-recovery) can
        never drop records that replay still needs.  Callers invoke it
        after ``IndexRegistry.save`` lands; ``recover`` sets it from
        the snapshot it restored."""
        if self._durable_seq is None or seq > self._durable_seq:
            self._durable_seq = int(seq)

    def close(self) -> None:
        if not self._f.closed:
            self.flush()                 # never drop a pending batch
            self._f.close()

    def __enter__(self) -> "MutationWAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read ----------------------------------------------------------------
    def scan(self) -> List[WALRecord]:
        """All complete records, oldest first.

        Tolerates a truncated final record (crash mid-append) — sets
        ``last_scan_torn`` — but raises :class:`WALCorruptError` on a
        damaged record that is *followed* by more data.
        """
        self._f.flush()
        out: List[WALRecord] = []
        self.last_scan_torn = False
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            if f.read(len(FILE_MAGIC)) != FILE_MAGIC:
                raise WALCorruptError(
                    f"{self.path}: bad file magic — expected "
                    f"{FILE_MAGIC!r} (file written by MutationWAL)")
            while True:
                off = f.tell()
                hdr = f.read(_HDR.size)
                if not hdr:
                    break
                if len(hdr) < _HDR.size:
                    self.last_scan_torn = True
                    break
                magic, op, seq, plen, crc = _HDR.unpack(hdr)
                if magic != _REC_MAGIC or op not in _OP_NAMES:
                    raise WALCorruptError(
                        f"{self.path}: bad record header at byte {off} "
                        f"(magic={magic!r} op={op}); the log is corrupt "
                        f"before its tail — restore from an older "
                        f"snapshot or truncate the file at that offset")
                raw = f.read(plen)
                if len(raw) < plen:
                    self.last_scan_torn = True
                    break
                if zlib.crc32(raw) != crc:
                    if off + _HDR.size + plen >= size:
                        self.last_scan_torn = True   # torn tail payload
                        break
                    raise WALCorruptError(
                        f"{self.path}: CRC mismatch in record at byte "
                        f"{off} (seq={seq}, op={_OP_NAMES[op]}) with "
                        f"valid data after it — the log is corrupt")
                out.append(WALRecord(seq, op, _decode_payload(raw)))
        return out

    # -- replay --------------------------------------------------------------
    def replay_into(self, live) -> ReplayReport:
        """Re-apply every record newer than ``live.seq`` (the snapshot
        sequence number) onto a restored LiveIndex, in order."""
        rep = ReplayReport()
        records = self.scan()
        rep.torn_tail = self.last_scan_torn
        live._replaying = True
        try:
            for rec in records:
                if rec.op not in MUTATION_OPS:
                    rep.epoch_records += 1    # rebuild fence, not a mutation
                    continue
                if rec.seq <= live.seq:
                    rep.skipped += 1
                    continue
                if rec.seq != live.seq + 1:
                    raise WALCorruptError(
                        f"{self.path}: sequence gap — record seq="
                        f"{rec.seq} but index is at seq={live.seq}; a "
                        f"record is missing (log truncated mid-stream?)")
                if rec.op == OP_ADD:
                    live.add(rec.payload)
                elif rec.op == OP_DELETE:
                    live.delete(rec.payload)
                else:
                    live.merge_delta()
                rep.applied += 1
        finally:
            live._replaying = False
        rep.last_seq = live.seq
        return rep

    # -- maintenance ---------------------------------------------------------
    def open_epoch_fences(self, records=None) -> List[int]:
        """Fence sequences of rebuilds that are in flight (a
        ``REBUILD_BEGIN`` with no matching ``COMMIT``/``ABORT``)."""
        begun, closed = {}, set()
        for r in (self.scan() if records is None else records):
            if r.op == OP_REBUILD_BEGIN:
                pl = np.asarray(r.payload).ravel()
                begun[int(pl[0])] = int(pl[1]) if pl.size > 1 else r.seq
            elif r.op in (OP_REBUILD_COMMIT, OP_REBUILD_ABORT):
                closed.add(r.epoch)
        return [f for e, f in begun.items() if e not in closed]

    def truncate_upto(self, seq: int) -> int:
        """Drop records with ``seq <=`` the given snapshot sequence
        (log compaction after a successful snapshot).  Returns the
        number of records kept.  Atomic: rewrite + rename.

        Guarded: the cut is clamped to (a) the last sequence reported
        durable via :meth:`note_durable` and (b) the fence of any open
        rebuild epoch, so compaction can never drop a record that
        snapshot recovery or an in-flight rebuild's catch-up replay
        still needs — even when the caller passes a sequence from the
        future (e.g. a compaction interleaved with recovery).  Fence
        records of open epochs are always kept; fences of resolved
        epochs compact away with the mutations they bracket."""
        self.flush()                     # batch must land before rewrite
        records = self.scan()
        cut = int(seq)
        if self._durable_seq is not None:
            cut = min(cut, self._durable_seq)
        fences = self.open_epoch_fences(records)
        if fences:
            cut = min(cut, min(fences))
        open_epochs = set()
        begun, closed = set(), set()
        for r in records:
            if r.op == OP_REBUILD_BEGIN:
                begun.add(r.epoch)
            elif r.op in (OP_REBUILD_COMMIT, OP_REBUILD_ABORT):
                closed.add(r.epoch)
        open_epochs = begun - closed
        keep = [r for r in records
                if r.seq > cut
                or (r.op in EPOCH_OPS and r.epoch in open_epochs)]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(FILE_MAGIC)
            for r in keep:
                raw = _encode_payload(r.payload)
                f.write(_HDR.pack(_REC_MAGIC, r.op, r.seq, len(raw),
                                  zlib.crc32(raw)) + raw)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        return len(keep)
