"""Crash-safe durability for the streaming index: write-ahead log + recovery.

The ``StreamingIndex`` delta tier lives in host memory, so before this
module a process crash silently lost every mutation since the last
compaction. Durability follows the classic LSM recipe:

  WAL        every ``insert``/``delete`` is appended (and optionally
             fsync'd) to an append-only log *before* it is applied in
             memory. Records are CRC-framed, so a torn final write — the
             normal crash artifact — is detected and discarded instead of
             being replayed as garbage. Segments rotate at a size
             threshold so snapshot-obsolete history can be pruned by
             deleting whole files.
  snapshot   ``StreamingIndex.save_snapshot`` serializes the full index
             state (compacted-tier device arrays, planner inputs, delta
             tier, id allocator, the WAL high-water mark) to a temp file
             and publishes it with ``os.replace`` — the POSIX atomic
             rename, so a crash mid-snapshot leaves the previous snapshot
             intact and a reader never observes a half-written file.
  recovery   :func:`recover` restores the newest snapshot (if any) and
             replays the WAL tail strictly after the snapshot's high-water
             mark, truncating at the first torn/corrupt record. Because
             replay re-applies the surviving mutation prefix in original
             order — including any delta-full synchronous compactions,
             which are deterministic functions of that order — the
             recovered index is *bit-identical* to a never-crashed index
             that applied the same prefix (pinned by
             ``tests/test_torch_stream.py``).

Record frame (little-endian)::

    magic u32 | lsn u64 | kind u8 | payload_len u32 | payload | crc32 u32

The CRC covers ``lsn..payload``; LSNs are globally monotone across
segments, so the snapshot high-water mark is a single integer. Replay
stops at EOF, a short frame, a bad magic, a bad CRC, or a non-monotone
LSN — whichever comes first — and reports how many trailing bytes were
discarded. WAL fsync latency, append/byte counters, truncation events and
recovery seconds all land in the ``repro_torch.obs`` registry.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry, resolve

WAL_MAGIC = 0x57414C31          # "WAL1"
KIND_INSERT = 1
KIND_DELETE = 2

_HEADER = struct.Struct("<IQBI")     # magic, lsn, kind, payload_len
_CRC = struct.Struct("<I")
_INSERT_HEAD = struct.Struct("<qddI")  # ext_id, s, t, dim
_DELETE_PAYLOAD = struct.Struct("<q")  # ext_id

SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".log"
SNAPSHOT_NAME = "snapshot.npz"


class CorruptSnapshotError(ValueError):
    """A snapshot file failed an integrity check: its recorded digest does
    not match the bytes on disk, or the npz payload itself is unreadable.
    Raised by ``StreamingIndex.restore`` and caught by the segmented tier's
    recovery path, which quarantines the damaged segment instead of
    aborting the whole recovery."""


def file_digest(path: str) -> str:
    """CRC32 of the file bytes as 8 hex chars — the digest recorded in the
    segmented manifest and verified by ``restore(expect_digest=...)``. CRC32
    matches the WAL's own framing strength: this detects media corruption,
    not adversaries."""
    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


@dataclasses.dataclass
class WalRecord:
    """One decoded mutation."""

    lsn: int
    kind: int                      # KIND_INSERT | KIND_DELETE
    ext_id: int
    s: float = 0.0
    t: float = 0.0
    vec: Optional[np.ndarray] = None


@dataclasses.dataclass
class ReplayReport:
    """What a replay/scan pass saw (also kept as ``wal.last_replay``)."""

    records: int = 0               # valid records yielded
    last_lsn: int = 0              # highest valid LSN seen
    truncated: bool = False        # a torn/corrupt tail was found
    truncated_segment: Optional[str] = None
    truncated_offset: int = 0      # valid-prefix length of that segment
    reason: str = ""               # why the scan stopped early


def _segment_name(seq: int) -> str:
    return f"{SEGMENT_PREFIX}{seq:08d}{SEGMENT_SUFFIX}"


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it are durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:               # platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def encode_insert(lsn: int, ext_id: int, s: float, t: float,
                  vec: np.ndarray) -> bytes:
    vec = np.ascontiguousarray(vec, dtype=np.float32)
    payload = _INSERT_HEAD.pack(int(ext_id), float(s), float(t),
                                vec.size) + vec.tobytes()
    return _frame(lsn, KIND_INSERT, payload)


def encode_delete(lsn: int, ext_id: int) -> bytes:
    return _frame(lsn, KIND_DELETE, _DELETE_PAYLOAD.pack(int(ext_id)))


def _frame(lsn: int, kind: int, payload: bytes) -> bytes:
    head = _HEADER.pack(WAL_MAGIC, lsn, kind, len(payload))
    crc = zlib.crc32(head[4:] + payload) & 0xFFFFFFFF
    return head + payload + _CRC.pack(crc)


def _decode_one(buf: bytes, off: int) -> Tuple[Optional[WalRecord], int, str]:
    """Decode one frame at ``off``. Returns (record | None, next_off, reason);
    a None record means the tail from ``off`` on is torn/corrupt."""
    if off + _HEADER.size > len(buf):
        return None, off, "short header" if off < len(buf) else "eof"
    magic, lsn, kind, plen = _HEADER.unpack_from(buf, off)
    if magic != WAL_MAGIC:
        return None, off, "bad magic"
    end = off + _HEADER.size + plen + _CRC.size
    if end > len(buf):
        return None, off, "short payload"
    payload = buf[off + _HEADER.size: off + _HEADER.size + plen]
    (crc,) = _CRC.unpack_from(buf, off + _HEADER.size + plen)
    want = zlib.crc32(buf[off + 4: off + _HEADER.size] + payload) & 0xFFFFFFFF
    if crc != want:
        return None, off, "bad crc"
    if kind == KIND_INSERT:
        if plen < _INSERT_HEAD.size:
            return None, off, "bad insert payload"
        ext, s, t, dim = _INSERT_HEAD.unpack_from(payload, 0)
        raw = payload[_INSERT_HEAD.size:]
        if len(raw) != 4 * dim:
            return None, off, "bad insert payload"
        vec = np.frombuffer(raw, dtype=np.float32).copy()
        return WalRecord(lsn, kind, ext, s, t, vec), end, ""
    if kind == KIND_DELETE:
        if plen != _DELETE_PAYLOAD.size:
            return None, off, "bad delete payload"
        (ext,) = _DELETE_PAYLOAD.unpack_from(payload, 0)
        return WalRecord(lsn, kind, ext), end, ""
    return None, off, "unknown kind"


class WriteAheadLog:
    """Append-only, CRC-framed, segment-rotated mutation log.

    ``sync`` picks the durability/throughput point: ``"always"`` fsyncs
    every append (full durability — the default), ``"rotate"`` fsyncs only
    on segment rotation and close, ``"never"`` leaves flushing to the OS.
    Thread-safe; opening an existing directory scans for the valid tail,
    physically truncates any torn final record, and continues LSNs from
    the highest valid one.
    """

    def __init__(
        self,
        dir: str,
        *,
        segment_bytes: int = 1 << 20,
        sync: str = "always",
        registry: Optional[MetricsRegistry] = None,
    ):
        if sync not in ("always", "rotate", "never"):
            raise ValueError(f"sync={sync!r} not in ('always','rotate','never')")
        self.dir = dir
        self.segment_bytes = int(segment_bytes)
        self.sync = sync
        self._reg = resolve(registry)
        self._lock = threading.Lock()
        os.makedirs(dir, exist_ok=True)
        self.last_replay: Optional[ReplayReport] = None
        self.truncated_on_open = False
        segs = self.segments()
        self._last_lsn = 0
        if segs:
            rep = self._scan(segs, after_lsn=0, yield_records=None)
            self._last_lsn = rep.last_lsn
            if rep.truncated and rep.truncated_segment is not None:
                self.truncated_on_open = True
                self._truncate_segment(
                    rep.truncated_segment, rep.truncated_offset, rep.reason
                )
            self._seq = int(segs[-1][len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
        else:
            self._seq = 0
        self._fh = open(self._seg_path(self._seq), "ab")

    # --- introspection --------------------------------------------------------

    @property
    def last_lsn(self) -> int:
        with self._lock:
            return self._last_lsn

    def segments(self) -> List[str]:
        """Sorted segment file names currently on disk."""
        return sorted(
            f for f in os.listdir(self.dir)
            if f.startswith(SEGMENT_PREFIX) and f.endswith(SEGMENT_SUFFIX)
        )

    @property
    def active_segment_path(self) -> str:
        """Path of the segment currently receiving appends (fault tests
        tear this one)."""
        return self._seg_path(self._seq)

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, _segment_name(seq))

    # --- append ---------------------------------------------------------------

    def append_insert(self, ext_id: int, s: float, t: float,
                      vec: np.ndarray) -> int:
        with self._lock:
            lsn = self._last_lsn + 1
            self._append(encode_insert(lsn, ext_id, s, t, vec), "insert")
            self._last_lsn = lsn
            return lsn

    def append_delete(self, ext_id: int) -> int:
        with self._lock:
            lsn = self._last_lsn + 1
            self._append(encode_delete(lsn, ext_id), "delete")
            self._last_lsn = lsn
            return lsn

    def _append(self, frame: bytes, kind: str) -> None:
        if self._fh.tell() >= self.segment_bytes:
            self._rotate_locked()
        self._fh.write(frame)
        self._fh.flush()
        if self.sync == "always":
            t0 = time.perf_counter()
            os.fsync(self._fh.fileno())
            self._reg.histogram(
                "repro_wal_fsync_seconds", "WAL fsync latency per append",
                buckets=LATENCY_BUCKETS_S,
            ).observe(time.perf_counter() - t0)
        self._reg.counter(
            "repro_wal_appends_total", "WAL records appended"
        ).inc(kind=kind)
        self._reg.counter(
            "repro_wal_bytes_total", "WAL bytes appended"
        ).inc(len(frame))

    def rotate(self) -> None:
        """Force a segment rotation (normally size-triggered)."""
        with self._lock:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._fh.flush()
        if self.sync != "never":
            os.fsync(self._fh.fileno())
        self._fh.close()
        self._seq += 1
        self._fh = open(self._seg_path(self._seq), "ab")
        _fsync_dir(self.dir)
        self._reg.counter(
            "repro_wal_segment_rotations_total", "WAL segment rotations"
        ).inc()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                if self.sync != "never":
                    os.fsync(self._fh.fileno())
                self._fh.close()

    # --- replay ---------------------------------------------------------------

    def replay(self, after_lsn: int = 0) -> Iterator[WalRecord]:
        """Yield valid records with ``lsn > after_lsn`` in LSN order,
        stopping at the first torn/corrupt record (the report lands in
        ``self.last_replay``). Safe on a closed or foreign WAL directory."""
        records: List[WalRecord] = []
        rep = self._scan(self.segments(), after_lsn, yield_records=records)
        self.last_replay = rep
        if rep.truncated:
            self._reg.counter(
                "repro_wal_truncated_records_total",
                "torn/corrupt WAL tails discarded during replay",
            ).inc()
        return iter(records)

    def _scan(self, segs: List[str], after_lsn: int,
              yield_records: Optional[List[WalRecord]]) -> ReplayReport:
        """Walk segments in order, validating frames. A corruption anywhere
        invalidates everything after it (LSNs are strictly monotone, so a
        later segment cannot be trusted past a broken earlier one)."""
        rep = ReplayReport()
        prev_lsn = 0
        for name in segs:
            path = os.path.join(self.dir, name)
            with open(path, "rb") as fh:
                buf = fh.read()
            off = 0
            while True:
                rec, off2, reason = _decode_one(buf, off)
                if rec is None:
                    if reason != "eof":
                        rep.truncated = True
                        rep.truncated_segment = name
                        rep.truncated_offset = off
                        rep.reason = reason
                        return rep
                    break
                if rec.lsn <= prev_lsn:
                    rep.truncated = True
                    rep.truncated_segment = name
                    rep.truncated_offset = off
                    rep.reason = "non-monotone lsn"
                    return rep
                prev_lsn = rec.lsn
                rep.last_lsn = rec.lsn
                if rec.lsn > after_lsn:
                    rep.records += 1
                    if yield_records is not None:
                        yield_records.append(rec)
                off = off2
        return rep

    def _truncate_segment(self, name: str, keep: int, reason: str) -> None:
        """Physically drop a torn tail so future appends start at a clean
        frame boundary; later segments (untrusted past the break) are
        removed."""
        segs = self.segments()
        cut = segs.index(name)
        path = os.path.join(self.dir, name)
        with open(path, "r+b") as fh:
            fh.truncate(keep)
            fh.flush()
            os.fsync(fh.fileno())
        for later in segs[cut + 1:]:
            os.remove(os.path.join(self.dir, later))
        _fsync_dir(self.dir)
        self._reg.counter(
            "repro_wal_truncated_records_total",
            "torn/corrupt WAL tails discarded during replay",
        ).inc()

    # --- pruning --------------------------------------------------------------

    def prune(self, upto_lsn: int) -> int:
        """Delete whole segments whose records are all covered by a snapshot
        (``max lsn <= upto_lsn``). Returns the number removed. The active
        segment is never removed."""
        removed = 0
        with self._lock:
            for name in self.segments():
                path = os.path.join(self.dir, name)
                if os.path.abspath(path) == os.path.abspath(self._fh.name):
                    break
                with open(path, "rb") as fh:
                    buf = fh.read()
                off, max_lsn = 0, 0
                while True:
                    rec, off, reason = _decode_one(buf, off)
                    if rec is None:
                        break
                    max_lsn = rec.lsn
                if max_lsn > upto_lsn:
                    break
                os.remove(path)
                removed += 1
            if removed:
                _fsync_dir(self.dir)
        return removed


# --- recovery orchestration ----------------------------------------------------


@dataclasses.dataclass
class RecoveryReport:
    """Outcome of :func:`recover`."""

    snapshot_found: bool
    snapshot_epoch: int
    records_replayed: int
    truncated: bool                # replay hit a torn/corrupt tail
    last_lsn: int                  # index high-water mark after replay
    recovery_seconds: float
    live_count: int


def recover(
    dir: str,
    *,
    wal: Optional[WriteAheadLog] = None,
    registry: Optional[MetricsRegistry] = None,
    **index_kwargs,
):
    """Restore a ``StreamingIndex`` from ``dir``: newest snapshot (if any)
    plus the WAL tail after its high-water mark.

    ``index_kwargs`` construct the index when no snapshot exists (first
    boot) — they must match the crashed process's construction arguments;
    ``device`` (in ``index_kwargs``) also places a restored snapshot.
    Passing ``wal`` reuses an already-open log (its torn tail was truncated
    at open); otherwise one is opened on ``dir`` with default settings.
    Returns ``(index, RecoveryReport)``; the index has the WAL attached, so
    serving can resume appending immediately.
    """
    from repro_torch.stream.index import StreamingIndex

    reg = resolve(registry)
    t0 = time.perf_counter()
    own_wal = wal is None
    if own_wal:
        wal = WriteAheadLog(dir, registry=registry)
    snap_path = os.path.join(dir, SNAPSHOT_NAME)
    if os.path.exists(snap_path):
        restore_kwargs = {
            key: index_kwargs[key]
            for key in ("policy", "build_kwargs", "device") if key in index_kwargs
        }
        index = StreamingIndex.restore(snap_path, **restore_kwargs)
        snapshot_found = True
    else:
        index = StreamingIndex(**index_kwargs)
        snapshot_found = False
    snap_epoch = index.epoch
    # replay strictly after the snapshot high-water mark, WITHOUT logging:
    # these records are already durable
    replayed = 0
    for rec in wal.replay(after_lsn=index.wal_lsn):
        index.apply_record(rec)
        replayed += 1
    rep = wal.last_replay
    index.attach_wal(wal)
    seconds = time.perf_counter() - t0
    reg.histogram(
        "repro_wal_recovery_seconds",
        "snapshot restore + WAL replay wall clock",
        buckets=LATENCY_BUCKETS_S,
    ).observe(seconds)
    reg.histogram(
        "repro_recovery_seconds",
        "crash-recovery wall clock (monolithic or per segment)",
        buckets=LATENCY_BUCKETS_S,
    ).observe(seconds, tier="stream")
    reg.counter(
        "repro_wal_replayed_records_total", "WAL records replayed at recovery"
    ).inc(replayed)
    return index, RecoveryReport(
        snapshot_found=snapshot_found,
        snapshot_epoch=snap_epoch,
        records_replayed=replayed,
        truncated=bool(rep and rep.truncated) or wal.truncated_on_open,
        last_lsn=index.wal_lsn,
        recovery_seconds=seconds,
        live_count=index.live_count,
    )
