"""Coordinated per-segment durability for the segmented streaming tier
(a copy of the JAX package's ``scale/durability.py`` with ``device``
threaded through to every restored cell).

One index directory, one WAL per grid cell, one CRC-framed manifest::

    <root>/MANIFEST                      framed JSON (see below)
    <root>/seg-0000/wal-00000000.log     cell 0's WriteAheadLog segments
    <root>/seg-0000/snapshot-00000003.npz  generation-named cell snapshot
    <root>/seg-0001/...

The manifest is the **root of trust**: a little JSON document framed as
``magic u32 | payload_len u32 | payload | crc32 u32`` and published with
the same tmp → fsync → ``os.replace`` → dir-fsync idiom the snapshots
use, recording per segment the snapshot file name, its CRC32 file digest
and the WAL LSN that snapshot embeds, plus everything needed to
reconstruct the index shell (relation, dim, capacities, build knobs, the
grid's rank/value edges).

Consistency rule — what makes a multi-segment checkpoint *coordinated*:

1. every cell snapshots to a **new generation-named file** (the previous
   generation stays on disk untouched);
2. the manifest referencing the new generation is published atomically —
   this rename is the checkpoint's commit point;
3. only **after** the manifest is durable are the per-cell WALs pruned
   and the previous generation's snapshot files deleted.

A crash anywhere before step 2 leaves the old manifest + old snapshots +
un-pruned WALs: recovery restores the old generation and replays the full
per-cell WAL tails, landing bit-identical to a never-crashed index. A
crash after step 2 recovers the new generation the same way. There is no
window in which the manifest references state that is not durable.

Recovery (:func:`recover_segmented`) rebuilds every cell concurrently:
open the cell WAL (torn tails are physically truncated at open), restore
the manifest's snapshot with its digest verified, replay the WAL records
after the snapshot's embedded LSN through ``apply_record`` — the same
deterministic replay contract as the monolithic ``repro_torch.stream.wal
.recover``. A cell whose snapshot fails its integrity check falls back to
a full WAL replay when the log still holds the complete history (LSN 1
onward — i.e. it was never pruned); if the history is gone too, the cell
is **quarantined**: recovery completes, searches stay correct over the
surviving segments (flagged ``missing_segments``), and the background
rebuild path (``SegmentedStreamingIndex.maybe_rebuild``) keeps trying to
restore it. WAL corruption alone never quarantines — the CRC framing
localizes it and the valid prefix is replayed (exactly the monolithic
semantics).
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry, resolve
from repro_torch.stream.wal import CorruptSnapshotError, WriteAheadLog, _fsync_dir

MANIFEST_NAME = "MANIFEST"
MANIFEST_MAGIC = 0x5345474D            # "SEGM"
_MAN_HEADER = struct.Struct("<II")     # magic, payload_len
_MAN_CRC = struct.Struct("<I")

SEGDIR_PREFIX = "seg-"
SNAP_PREFIX = "snapshot-"
SNAP_SUFFIX = ".npz"


class CorruptManifestError(ValueError):
    """The manifest failed its CRC/framing check. Unlike a single bad
    snapshot (quarantine one cell, keep serving), the manifest is the root
    of trust for the whole directory — recovery cannot proceed past it."""


def segment_dir(root: str, cell: int) -> str:
    return os.path.join(root, f"{SEGDIR_PREFIX}{cell:04d}")


def snapshot_name(generation: int) -> str:
    return f"{SNAP_PREFIX}{generation:08d}{SNAP_SUFFIX}"


# --- manifest I/O ---------------------------------------------------------------


def write_manifest(root: str, manifest: dict) -> str:
    """Atomically publish ``manifest`` as ``<root>/MANIFEST`` — the
    checkpoint commit point (tmp → fsync → rename → dir-fsync)."""
    payload = json.dumps(manifest, sort_keys=True).encode("utf-8")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    frame = (_MAN_HEADER.pack(MANIFEST_MAGIC, len(payload)) + payload
             + _MAN_CRC.pack(crc))
    path = os.path.join(root, MANIFEST_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(frame)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(root)
    return path


def read_manifest(root: str) -> dict:
    """Read + verify ``<root>/MANIFEST``. Raises ``FileNotFoundError`` when
    absent and :class:`CorruptManifestError` when the framing, CRC, or JSON
    payload is damaged."""
    path = os.path.join(root, MANIFEST_NAME)
    with open(path, "rb") as fh:
        buf = fh.read()
    if len(buf) < _MAN_HEADER.size + _MAN_CRC.size:
        raise CorruptManifestError(f"{path}: short manifest ({len(buf)} B)")
    magic, plen = _MAN_HEADER.unpack_from(buf, 0)
    if magic != MANIFEST_MAGIC:
        raise CorruptManifestError(f"{path}: bad magic {magic:#x}")
    end = _MAN_HEADER.size + plen
    if end + _MAN_CRC.size != len(buf):
        raise CorruptManifestError(f"{path}: framed length mismatch")
    payload = buf[_MAN_HEADER.size:end]
    (crc,) = _MAN_CRC.unpack_from(buf, end)
    if crc != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise CorruptManifestError(f"{path}: bad crc")
    try:
        return json.loads(payload.decode("utf-8"))
    except ValueError as exc:
        raise CorruptManifestError(f"{path}: bad json payload: {exc}")


def grid_to_manifest(grid) -> dict:
    """JSON-serializable form of a ``SegmentGrid`` (the value edges carry
    ±inf, which Python's json round-trips as ``Infinity``)."""
    return {
        "edges_x": [int(v) for v in grid.edges_x],
        "edges_y": [int(v) for v in grid.edges_y],
        "vals_x": [float(v) for v in grid.vals_x],
        "vals_y": [float(v) for v in grid.vals_y],
    }


def grid_from_manifest(g: dict):
    from repro_torch.scale.partition import SegmentGrid

    return SegmentGrid(
        edges_x=np.asarray(g["edges_x"], np.int64),
        edges_y=np.asarray(g["edges_y"], np.int64),
        vals_x=np.asarray(g["vals_x"], np.float64),
        vals_y=np.asarray(g["vals_y"], np.float64),
    )


# --- recovery -------------------------------------------------------------------


@dataclasses.dataclass
class SegmentRecovery:
    """One cell's recovery outcome."""

    cell: int
    snapshot_found: bool
    records_replayed: int
    truncated: bool                # the cell WAL had a torn/corrupt tail
    quarantined: bool
    reason: str                    # why quarantined / which fallback ran
    last_lsn: int
    live_count: int


@dataclasses.dataclass
class SegmentedRecoveryReport:
    """Outcome of :func:`recover_segmented`."""

    generation: int
    segments: List[SegmentRecovery]
    quarantined: List[int]
    records_replayed: int
    recovery_seconds: float
    live_count: int


def _recover_cell(
    root: str,
    cell: int,
    entry: dict,
    sub_kwargs: dict,
    *,
    wal_sync: str,
    wal_segment_bytes: int,
    registry: Optional[MetricsRegistry],
):
    """Recover one cell → ``(sub, wal_or_None, SegmentRecovery)``.

    Quarantine (sub = fresh empty placeholder, wal = None) happens ONLY
    when the snapshot is corrupt AND the WAL no longer holds the full
    history; plain WAL damage truncates to the valid prefix — the
    monolithic surviving-prefix semantics, per cell.
    """
    from repro_torch.stream.index import StreamingIndex

    seg = segment_dir(root, cell)
    os.makedirs(seg, exist_ok=True)
    wal = WriteAheadLog(
        seg, sync=wal_sync, segment_bytes=wal_segment_bytes,
        registry=registry,
    )
    restore_kwargs = {
        key: sub_kwargs[key] for key in ("policy", "build_kwargs", "device")
    }
    snap = entry.get("snapshot")
    reason = ""
    index = None
    snapshot_found = False
    if snap is not None:
        try:
            index = StreamingIndex.restore(
                os.path.join(seg, snap),
                expect_digest=entry.get("digest"), **restore_kwargs,
            )
            snapshot_found = True
        except (CorruptSnapshotError, FileNotFoundError) as exc:
            # fall back to a full WAL replay iff the log still holds the
            # complete history (never pruned: first surviving LSN is 1)
            first = next(iter(wal.replay(after_lsn=0)), None)
            if first is None and int(entry.get("lsn", 0)) == 0:
                index = StreamingIndex(**sub_kwargs)
                reason = f"corrupt snapshot, empty history: {exc}"
            elif first is not None and first.lsn == 1:
                index = StreamingIndex(**sub_kwargs)
                reason = f"corrupt snapshot, full WAL replay: {exc}"
            else:
                wal.close()
                placeholder = StreamingIndex(**sub_kwargs)
                return placeholder, None, SegmentRecovery(
                    cell=cell, snapshot_found=False, records_replayed=0,
                    truncated=wal.truncated_on_open, quarantined=True,
                    reason=f"corrupt snapshot, WAL history pruned: {exc}",
                    last_lsn=0, live_count=0,
                )
    else:
        index = StreamingIndex(**sub_kwargs)
    replayed = 0
    for rec in wal.replay(after_lsn=index.wal_lsn):
        index.apply_record(rec)
        replayed += 1
    rep = wal.last_replay
    index.attach_wal(wal)
    return index, wal, SegmentRecovery(
        cell=cell, snapshot_found=snapshot_found,
        records_replayed=replayed,
        truncated=bool(rep and rep.truncated) or wal.truncated_on_open,
        quarantined=False, reason=reason,
        last_lsn=index.wal_lsn, live_count=index.live_count,
    )


def recover_segmented(
    root: str,
    *,
    policy=None,
    build_kwargs: Optional[dict] = None,
    registry: Optional[MetricsRegistry] = None,
    max_workers: Optional[int] = None,
    wal_sync: str = "always",
    wal_segment_bytes: int = 1 << 20,
    device=None,
):
    """Rebuild a ``SegmentedStreamingIndex`` from its durability directory.

    Returns ``(index, SegmentedRecoveryReport)``. Cells recover
    **concurrently** (snapshot restore + tail replay are independent per
    cell); integrity-failed cells are quarantined, not fatal — the index
    comes back serving correct results over the survivors and
    ``maybe_rebuild`` keeps working on the rest. Orphan snapshot files
    from a checkpoint that crashed before its manifest publish are
    garbage-collected here (the manifest is the root of trust — anything
    it does not reference is dead). Every cell is restored onto ``device``
    (``None`` = the card), passed explicitly to each worker thread.
    """
    from repro_torch.scale.stream import SegmentedStreamingIndex

    reg = resolve(registry)
    t0 = time.perf_counter()
    man = read_manifest(root)
    grid = grid_from_manifest(man["grid"])
    C = grid.num_cells
    entries = man["segments"]
    if len(entries) != C:
        raise CorruptManifestError(
            f"{root}: manifest has {len(entries)} segments, grid has {C}"
        )
    idx = SegmentedStreamingIndex(
        int(man["dim"]), str(man["relation"]), grid,
        node_capacity=int(man["node_capacity"]),
        delta_capacity=int(man["delta_capacity"]),
        edge_capacity=int(man["edge_capacity"]),
        M=int(man["M"]), Z=int(man["Z"]), K_p=int(man["K_p"]),
        policy=policy, build_kwargs=build_kwargs, device=device,
    )
    idx._bind_storage(
        root, generation=int(man["generation"]), wal_sync=wal_sync,
        wal_segment_bytes=wal_segment_bytes, registry=registry,
    )

    def one(cell: int):
        return _recover_cell(
            root, cell, entries[cell], idx._sub_kwargs(cell),
            wal_sync=wal_sync, wal_segment_bytes=wal_segment_bytes,
            registry=registry,
        )

    workers = max(1, min(max_workers or 8, C))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(one, range(C)))

    segs: List[SegmentRecovery] = []
    for cell, (sub, wal, rec) in enumerate(results):
        sub._on_epoch_swap = idx._swap_observer(cell)
        idx.subs[cell] = sub
        idx._wals[cell] = wal
        segs.append(rec)
        if rec.quarantined:
            idx._quarantine(cell, rec.reason, stash=False)
        else:
            _gc_snapshots(segment_dir(root, cell),
                          keep=entries[cell].get("snapshot"))
    seconds = time.perf_counter() - t0
    replayed = sum(r.records_replayed for r in segs)
    reg.histogram(
        "repro_recovery_seconds",
        "crash-recovery wall clock (monolithic or per segment)",
        buckets=LATENCY_BUCKETS_S,
    ).observe(seconds, tier="segmented")
    reg.counter(
        "repro_wal_replayed_records_total", "WAL records replayed at recovery"
    ).inc(replayed)
    quarantined = sorted(idx.quarantined)
    reg.gauge(
        "repro_segments_quarantined", "segments currently quarantined"
    ).set(len(quarantined))
    return idx, SegmentedRecoveryReport(
        generation=int(man["generation"]),
        segments=segs,
        quarantined=quarantined,
        records_replayed=replayed,
        recovery_seconds=seconds,
        live_count=idx.live_count,
    )


def _gc_snapshots(seg_dir: str, *, keep: Optional[str]) -> int:
    """Remove snapshot files in ``seg_dir`` other than ``keep`` (older
    generations after a successful checkpoint; orphans from a crashed
    one). Returns the number removed."""
    removed = 0
    try:
        names = os.listdir(seg_dir)
    except FileNotFoundError:
        return 0
    for name in names:
        if (name.startswith(SNAP_PREFIX) and name.endswith(SNAP_SUFFIX)
                and name != keep):
            os.remove(os.path.join(seg_dir, name))
            removed += 1
    if removed:
        _fsync_dir(seg_dir)
    return removed
