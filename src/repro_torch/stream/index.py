"""LSM-style streaming UDG: online inserts/deletes over an epoch-swapped
compacted tier plus a mutable delta tier.

Two tiers, one static serving shape:

  compacted   an immutable UDG (``LabeledGraph`` built by ``build_udg``)
              exported at fixed node/edge capacity, with a live mask for
              tombstoned nodes (soft delete: dead nodes still route the
              beam but never surface);
  delta       an append-only ``DeltaBuffer`` at fixed capacity, scanned
              brute-force through the gather scorer (B3).

Mutations are cheap O(1) host ops. When the mutable fraction (delta objects
+ graph tombstones) crosses the policy threshold, compaction rebuilds the
UDG from (compacted ∪ delta − tombstones) and atomically swaps the epoch.
The build can run on a background thread (``begin_compaction`` →
``build_epoch`` → ``finish_compaction``); queries keep serving epoch N and
mutations keep landing (inserts beyond the snapshot watermark stay in the
delta, deletes are re-applied to epoch N+1 at swap), so nothing is lost and
deleted objects can never resurface.

The index lives on one device (``device=None``: the card), where its
rebuilds run the wave constructor and its searches the kernels; a search
may name another device (``device="cpu"``: the plain versions) and stages
the index there too. Snapshots keep the JAX package's file layout (array
names and dtypes), so either package restores the other's.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.build import build_udg
from repro_torch.core.entry import EntryTable
from repro_torch.core.predicates import get_relation
from repro_torch.device import resolve_device
from repro_torch.exec import (
    PlannerConfig,
    QueryPlan,
    SelectivityEstimator,
    default_planner_config,
    export_planned_graph,
    mask_entry_points,
    plan_queries,
)
from repro_torch.kernels.ref import warp_dot
from repro_torch.obs.metrics import BYTES_BUCKETS, LATENCY_BUCKETS_S, resolve
from repro_torch.obs.stats import stats_to_host
from repro_torch.search.batched import prepare_states_extended
from repro_torch.search.device_graph import RANK_LIMIT, DeviceGraph
from repro_torch.stream.delta import DeltaBuffer, query_key_state
from repro_torch.stream.search import (
    delta_norms,
    planned_streaming_search_core,
    streaming_search_core,
)
from repro_torch.stream.wal import (
    KIND_DELETE,
    KIND_INSERT,
    SNAPSHOT_NAME,
    CorruptSnapshotError,
    _fsync_dir,
    file_digest,
)


@dataclasses.dataclass
class CompactionPolicy:
    """Rebuild when the mutable fraction crosses ``max_delta_fraction``.

    mutable fraction = (live delta objects + graph tombstones) / live total;
    ``min_mutations`` suppresses thrashing on tiny indexes.
    """

    max_delta_fraction: float = 0.25
    min_mutations: int = 64

    def should_compact(self, delta_live: int, graph_dead: int, total_live: int) -> bool:
        mutable = delta_live + graph_dead
        if mutable < self.min_mutations:
            return False
        return mutable > self.max_delta_fraction * max(total_live, 1)


@dataclasses.dataclass
class CompactionReport:
    epoch: int
    n_live: int
    build_seconds: float
    swap_seconds: float
    delta_drained: int
    tombstones_cleared: int


@dataclasses.dataclass
class _CompactionJob:
    """Snapshot of the live set at ``begin_compaction`` time."""

    vectors: np.ndarray
    s: np.ndarray
    t: np.ndarray
    ext: np.ndarray
    delta_watermark: int
    delta_consumed: int
    tombstones: int
    graph: object = None          # LabeledGraph, filled by build_epoch
    entry: object = None          # EntryTable
    build_seconds: float = 0.0


def _empty_device_graph(dim: int, node_capacity: int, edge_capacity: int,
                        relation: str, packed: bool) -> DeviceGraph:
    """Epoch-0 compacted tier: no nodes, no grids, every query falls through
    to the delta scan (entry lookup yields ep = -1). ``packed`` must match
    the layout every later epoch will export, so the search sees one label
    shape across swaps."""
    # all-zero rectangles in whichever layout later epochs will use —
    # built directly (packing zeros just wastes a full int32 allocation)
    return DeviceGraph(
        vectors=np.zeros((node_capacity, dim), dtype=np.float32),
        nbr=np.full((node_capacity, edge_capacity), -1, dtype=np.int32),
        labels=(None if packed
                else np.zeros((node_capacity, edge_capacity, 4), np.int32)),
        U_X=np.empty(0, dtype=np.float64),
        U_Y=np.empty(0, dtype=np.float64),
        entry_node=np.empty(0, dtype=np.int32),
        entry_y_rank=np.empty(0, dtype=np.int32),
        relation=relation,
        norms=np.zeros(node_capacity, dtype=np.float32),
        plabels=(np.zeros((node_capacity, edge_capacity, 2), np.uint32)
                 if packed else None),
    )


def _graph_states(dg: DeviceGraph, s_q: np.ndarray, t_q: np.ndarray):
    """``prepare_states_extended`` with an empty-grid guard (epoch 0)."""
    if dg.U_X.shape[0] == 0 or dg.U_Y.shape[0] == 0:
        B = np.asarray(s_q).shape[0]
        return (np.zeros((B, 2), np.int32), np.full(B, -1, np.int32),
                np.ones(B, bool))
    return prepare_states_extended(dg, s_q, t_q)


class StreamingIndex:
    """Online insert/delete/query over an epoch-swapped UDG + delta tier.

    All shapes entering the search are fixed by ``node_capacity`` /
    ``edge_capacity`` / ``delta_capacity`` at construction, so an epoch
    swap changes no device tensor's shape.
    """

    def __init__(
        self,
        dim: int,
        relation: str,
        *,
        node_capacity: int = 4096,
        delta_capacity: int = 512,
        edge_capacity: int = 128,
        M: int = 16,
        Z: int = 64,
        K_p: int = 8,
        policy: Optional[CompactionPolicy] = None,
        build_kwargs: Optional[dict] = None,
        id_start: int = 0,
        id_stride: int = 1,
        wal: Optional[object] = None,
        on_epoch_swap: Optional[object] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.relation = relation
        self._rel = get_relation(relation)
        self.node_capacity = node_capacity
        self.delta_capacity = delta_capacity
        self.edge_capacity = edge_capacity
        self.policy = policy or CompactionPolicy()
        # pad_nodes pins the wave constructor's device-table shape to the
        # serving capacity, whatever the live count. build_udg's auto
        # dispatch picks the wave constructor (its searches on the index's
        # device) once the live set is large enough; pass batched=True/False
        # in build_kwargs to force a strategy.
        self._build_kwargs = dict(M=M, Z=Z, K_p=K_p, pad_nodes=node_capacity,
                                  device=self.device)
        self._build_kwargs.update(build_kwargs or {})

        self._lock = threading.RLock()
        self._epoch = 0
        # label layout is a *construction-time* decision so every epoch
        # exports the same shapes:
        # canonical grids never exceed the live-node count <= node_capacity,
        # so capacities within the 16-bit rank budget always pack
        self._packed_labels = node_capacity <= RANK_LIMIT
        self._dg = _empty_device_graph(
            dim, node_capacity, edge_capacity, relation,
            packed=self._packed_labels,
        )
        # device-resident immutables of the current epoch live in the
        # DeviceGraph's memoized .device(dev) bundles (swapped as a unit)
        self._graph_n = 0
        self._graph_live = np.zeros(node_capacity, dtype=bool)
        self._graph_ext = np.full(node_capacity, -1, dtype=np.int64)
        self._graph_s = np.zeros(node_capacity, dtype=np.float64)
        self._graph_t = np.zeros(node_capacity, dtype=np.float64)
        self._delta = DeltaBuffer(dim, delta_capacity, self._rel)
        # device snapshot of the mutable arrays (live/ext + delta segment
        # and its norms) per device, rebuilt lazily after a mutation so
        # read-heavy serving re-uses one upload per device
        self._dev_mut: Dict[str, tuple] = {}
        self._ext2loc: Dict[int, Tuple[str, int]] = {}
        # id namespace: shard s of S uses ids s, s+S, s+2S, ... so external
        # ids stay globally unique across a sharded deployment.
        self._next_id = id_start
        self._id_stride = id_stride
        self._job_active = False
        self._pending_deletes: list[int] = []
        # durability (repro_torch.stream.wal): with a WriteAheadLog attached,
        # every acknowledged mutation is appended (commit point = the WAL
        # append) so a crash loses at most unacknowledged work. Existing
        # log contents are assumed already reflected in this object's
        # state — cold-start recovery goes through ``repro_torch.stream.wal
        # .recover``, which replays the tail *before* attaching.
        self._wal = wal
        self._applied_lsn = wal.last_lsn if wal is not None else 0
        # epoch-swap observer: called with the CompactionReport after each
        # swap, OUTSIDE the index lock (a slow observer must not block
        # mutations; a segmented tier tracks segment-local swaps with it).
        self._on_epoch_swap = on_epoch_swap

    # --- introspection --------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def live_count(self) -> int:
        with self._lock:
            return len(self._ext2loc)

    @property
    def graph_dead(self) -> int:
        with self._lock:
            return self._graph_n - int(
                np.count_nonzero(self._graph_live[: self._graph_n])
            )

    @property
    def delta_fraction(self) -> float:
        with self._lock:
            total = max(len(self._ext2loc), 1)
            return (self._delta.live_count + self.graph_dead) / total

    def live_ids(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(self._ext2loc), dtype=np.int64)

    def snapshot_live(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(vectors, s, t, ext_ids) of the current live set — the oracle a
        from-scratch rebuild would index."""
        with self._lock:
            gl = np.flatnonzero(self._graph_live[: self._graph_n])
            dl = self._delta.live_slots()
            vec = np.concatenate(
                [self._dg.vectors[gl], self._delta.vectors[dl]], axis=0
            )
            s = np.concatenate([self._graph_s[gl], self._delta.s[dl]])
            t = np.concatenate([self._graph_t[gl], self._delta.t[dl]])
            ext = np.concatenate([self._graph_ext[gl], self._delta.ext_ids[dl]])
            return vec, s, t, ext.astype(np.int64)

    # --- mutations ------------------------------------------------------------

    def _apply_insert(self, vec: np.ndarray, s: float, t: float, ext: int) -> int:
        """Apply one insert with a pre-assigned external id (lock held).
        Shared by the public ``insert`` and WAL replay; may trigger a
        synchronous flush-compaction when the delta is full — a
        deterministic function of the mutation order, so replay reproduces
        it bit-for-bit."""
        if self._delta.full:
            if self._job_active:
                raise RuntimeError(
                    "delta buffer full while a compaction is in flight; "
                    "increase delta_capacity or finish the compaction"
                )
            self.compact()
        slot = self._delta.append(vec, float(s), float(t), ext)
        self._ext2loc[ext] = ("d", slot)
        self._dev_mut = {}
        return slot

    def _apply_delete(self, ext_id: int) -> bool:
        """Apply one tombstone (lock held); shared with WAL replay."""
        loc = self._ext2loc.pop(int(ext_id), None)
        if loc is None:
            return False
        tier, i = loc
        if tier == "g":
            self._graph_live[i] = False
        else:
            self._delta.tombstone(i)
        if self._job_active:
            self._pending_deletes.append(int(ext_id))
        self._dev_mut = {}
        return True

    def insert(self, vec: np.ndarray, s: float, t: float) -> int:
        """Insert one object; returns its external id. O(1) host work; may
        trigger a synchronous flush-compaction when the delta is full.
        With a WAL attached the mutation is appended (and fsync'd, per the
        log's sync policy) before the id is returned — the commit point."""
        with self._lock:
            ext = self._next_id
            self._next_id += self._id_stride
            self._apply_insert(vec, s, t, ext)
            if self._wal is not None:
                self._applied_lsn = self._wal.append_insert(
                    ext, float(s), float(t), np.asarray(vec, np.float32)
                )
            return ext

    def insert_batch(self, vecs: np.ndarray, s: np.ndarray, t: np.ndarray) -> np.ndarray:
        return np.array(
            [self.insert(vecs[i], s[i], t[i]) for i in range(len(vecs))],
            dtype=np.int64,
        )

    def delete(self, ext_id: int) -> bool:
        """Tombstone one object. Returns False for unknown/already-deleted
        (no-op deletes are not logged)."""
        with self._lock:
            if not self._apply_delete(ext_id):
                return False
            if self._wal is not None:
                self._applied_lsn = self._wal.append_delete(int(ext_id))
            return True

    # --- durability (repro_torch.stream.wal) --------------------------------

    @property
    def wal_lsn(self) -> int:
        """High-water mark: LSN of the last mutation reflected in memory."""
        with self._lock:
            return self._applied_lsn

    def attach_wal(self, wal) -> None:
        """Start logging future mutations to ``wal``. Existing log records
        are assumed already applied (``recover`` replays before attaching)."""
        with self._lock:
            self._wal = wal

    def apply_record(self, rec) -> None:
        """Re-apply one replayed ``WalRecord`` WITHOUT re-logging it (it is
        already durable). Advances the id allocator past replayed inserts so
        post-recovery inserts never collide."""
        with self._lock:
            if rec.kind == KIND_INSERT:
                self._apply_insert(rec.vec, rec.s, rec.t, int(rec.ext_id))
                if int(rec.ext_id) >= self._next_id:
                    self._next_id = int(rec.ext_id) + self._id_stride
            elif rec.kind == KIND_DELETE:
                self._apply_delete(int(rec.ext_id))
            else:
                raise ValueError(f"unknown WAL record kind {rec.kind!r}")
            self._applied_lsn = int(rec.lsn)

    def save_snapshot(self, path: str, *, prune_wal: bool = True) -> str:
        """Crash-consistent snapshot of the full index state.

        Serializes the compacted-tier device arrays (bit-exact — restore
        never rebuilds the graph, so recovered searches run on *identical*
        arrays), the planner's rank inputs, the delta tier, the id
        allocator and the WAL high-water mark to ``path`` (a file, or a
        directory that gets the canonical ``snapshot.npz`` name). The
        write goes to a temp file first and is published with
        ``os.replace`` — atomic on POSIX — so a crash mid-snapshot leaves
        the previous snapshot intact. Mutations are blocked for the
        duration (the state + high-water mark must be mutually
        consistent). With a WAL attached, segments fully covered by the
        snapshot are pruned afterwards (``prune_wal=False`` keeps them —
        parity tests replay the full history). Returns the snapshot path.
        """
        if os.path.isdir(path):
            path = os.path.join(path, SNAPSHOT_NAME)
        with self._lock:
            dg = self._dg
            pl = dg.planner
            bk = self._build_kwargs
            arrays = dict(
                dg_vectors=dg.vectors, dg_nbr=dg.nbr,
                dg_UX=dg.U_X, dg_UY=dg.U_Y,
                dg_entry_node=dg.entry_node,
                dg_entry_y_rank=dg.entry_y_rank,
                dg_norms=dg.norms,
                graph_live=self._graph_live, graph_ext=self._graph_ext,
                graph_s=self._graph_s, graph_t=self._graph_t,
                d_vectors=self._delta.vectors, d_s=self._delta.s,
                d_t=self._delta.t, d_labels=self._delta.labels,
                d_ext=self._delta.ext_ids, d_live=self._delta.live,
                relation=np.array(self.relation),
                meta=np.array([
                    self.dim, self.node_capacity, self.delta_capacity,
                    self.edge_capacity, self._epoch, self._graph_n,
                    self._next_id, self._id_stride, self._applied_lsn,
                    self._delta.size,
                    int(bk.get("M", 16)), int(bk.get("Z", 64)),
                    int(bk.get("K_p", 8)),
                ], dtype=np.int64),
            )
            if dg.plabels is not None:
                arrays["dg_plabels"] = dg.plabels
            else:
                arrays["dg_labels"] = dg.labels
            if pl is not None:
                # estimator state in original node order (its CSR keeps a
                # permutation): rebuild-from-these-inputs is deterministic,
                # so the restored planner routes queries identically
                xr = np.empty(pl.n, np.int64)
                yr = np.empty(pl.n, np.int64)
                xr[pl._ids] = pl._xr
                yr[pl._ids] = pl._yr
                arrays["pl_xr"] = xr
                arrays["pl_yr"] = yr
                arrays["pl_meta"] = np.array(
                    [pl.num_x, pl.num_y, pl.buckets], np.int64
                )
            t0 = time.perf_counter()
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                np.savez(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            _fsync_dir(os.path.dirname(os.path.abspath(path)))
            reg = resolve(None)
            reg.histogram(
                "repro_snapshot_bytes", "snapshot file size",
                buckets=BYTES_BUCKETS,
            ).observe(os.path.getsize(path))
            reg.histogram(
                "repro_snapshot_seconds", "snapshot serialize+fsync wall clock",
                buckets=LATENCY_BUCKETS_S,
            ).observe(time.perf_counter() - t0)
            if prune_wal and self._wal is not None:
                self._wal.prune(self._applied_lsn)
        return path

    @classmethod
    def restore(
        cls,
        path: str,
        *,
        policy: Optional[CompactionPolicy] = None,
        build_kwargs: Optional[dict] = None,
        expect_digest: Optional[str] = None,
        device=None,
    ) -> "StreamingIndex":
        """Reconstruct an index from a :meth:`save_snapshot` file.

        The compacted tier is restored from the serialized device arrays
        (no rebuild), the planner from its serialized rank inputs, so a
        restored index serves bit-identical results to the instance that
        saved the snapshot. ``policy``/``build_kwargs`` should match the
        original construction (they are not part of the snapshot beyond
        M/Z/K_p). Cold-start recovery — snapshot + WAL tail — goes through
        ``repro_torch.stream.wal.recover``. ``device`` places the index.

        The graph tier's cached norms are summed again from its vectors in
        the scorers' order (as ``export_device_graph`` sums them), so a
        snapshot written by either package restores to the norms this
        package's own export would carry; every other array is taken as
        written.

        ``expect_digest`` (from the segmented manifest) is verified against
        the file bytes before parsing; a mismatch — or an unreadable npz
        payload — raises :class:`repro_torch.stream.wal.CorruptSnapshotError`,
        the typed signal the segmented recovery path quarantines on.
        """
        if expect_digest is not None:
            got = file_digest(path)
            if got != expect_digest:
                raise CorruptSnapshotError(
                    f"{path}: digest {got} != recorded {expect_digest}"
                )
        try:
            with np.load(path, allow_pickle=False) as z:
                data = {name: z[name] for name in z.files}
        except CorruptSnapshotError:
            raise
        except Exception as exc:      # zipfile/numpy parse errors on a
            # flipped byte surface as a typed integrity failure, not a
            # cryptic BadZipFile deep inside recovery
            raise CorruptSnapshotError(f"{path}: unreadable snapshot: {exc}")
        (dim, ncap, dcap, ecap, epoch, graph_n, next_id, stride, lsn,
         d_size, M, Z, K_p) = (int(x) for x in data["meta"])
        relation = str(data["relation"].item())
        idx = cls(
            dim, relation, node_capacity=ncap, delta_capacity=dcap,
            edge_capacity=ecap, M=M, Z=Z, K_p=K_p, policy=policy,
            build_kwargs=build_kwargs, id_start=next_id, id_stride=stride,
            device=device,
        )
        packed = "dg_plabels" in data
        if packed != idx._packed_labels:
            raise ValueError(
                "snapshot label layout (packed=%s) does not match the "
                "construction-time layout for node_capacity=%d" %
                (packed, ncap)
            )
        if data["dg_UX"].size == 0:
            dg = idx._dg     # epoch-0 empty graph from the constructor
        else:
            planner = None
            if "pl_xr" in data:
                num_x, num_y, buckets = (int(x) for x in data["pl_meta"])
                planner = SelectivityEstimator(
                    data["pl_xr"], data["pl_yr"], num_x, num_y,
                    buckets=buckets,
                )
            vectors = data["dg_vectors"]
            rows = torch.from_numpy(vectors)
            dg = DeviceGraph(
                vectors=vectors, nbr=data["dg_nbr"],
                labels=data.get("dg_labels"),
                U_X=data["dg_UX"], U_Y=data["dg_UY"],
                entry_node=data["dg_entry_node"],
                entry_y_rank=data["dg_entry_y_rank"],
                relation=relation,
                norms=warp_dot(rows, rows).numpy(),
                planner=planner, plabels=data.get("dg_plabels"),
            )
            dg.device(idx.device)
        delta = DeltaBuffer(dim, dcap, idx._rel)
        delta.vectors[:] = data["d_vectors"]
        delta.s[:] = data["d_s"]
        delta.t[:] = data["d_t"]
        delta.labels[:] = data["d_labels"]
        delta.ext_ids[:] = data["d_ext"]
        delta.live[:] = data["d_live"].astype(bool)
        delta.size = d_size
        graph_live = data["graph_live"].astype(bool)
        graph_ext = data["graph_ext"].astype(np.int64)
        ext2loc: Dict[int, Tuple[str, int]] = {}
        for i in np.flatnonzero(graph_live[:graph_n]):
            ext2loc[int(graph_ext[i])] = ("g", int(i))
        for slot in delta.live_slots():
            ext2loc[int(delta.ext_ids[slot])] = ("d", int(slot))
        idx._dg = dg
        idx._graph_n = graph_n
        idx._graph_live = graph_live
        idx._graph_ext = graph_ext
        idx._graph_s = data["graph_s"].astype(np.float64)
        idx._graph_t = data["graph_t"].astype(np.float64)
        idx._delta = delta
        idx._ext2loc = ext2loc
        idx._dev_mut = {}
        idx._epoch = epoch
        idx._next_id = next_id
        idx._applied_lsn = lsn
        return idx

    # --- compaction -----------------------------------------------------------

    def should_compact(self) -> bool:
        with self._lock:
            return self.policy.should_compact(
                self._delta.live_count, self.graph_dead, len(self._ext2loc)
            )

    def begin_compaction(self) -> _CompactionJob:
        """Snapshot the live set. Mutations after this point keep landing in
        the current epoch and are replayed onto the next at swap time."""
        with self._lock:
            if self._job_active:
                raise RuntimeError("compaction already in flight")
            watermark = self._delta.size
            gl = np.flatnonzero(self._graph_live[: self._graph_n])
            dl = self._delta.live_slots(upto=watermark)
            job = _CompactionJob(
                vectors=np.concatenate(
                    [self._dg.vectors[gl], self._delta.vectors[dl]], axis=0
                ),
                s=np.concatenate([self._graph_s[gl], self._delta.s[dl]]),
                t=np.concatenate([self._graph_t[gl], self._delta.t[dl]]),
                ext=np.concatenate(
                    [self._graph_ext[gl], self._delta.ext_ids[dl]]
                ).astype(np.int64),
                delta_watermark=watermark,
                delta_consumed=int(dl.size),
                tombstones=self.graph_dead,
            )
            self._job_active = True
            self._pending_deletes = []
            return job

    def build_epoch(self, job: _CompactionJob) -> _CompactionJob:
        """Rebuild the UDG on the snapshot. Lock-free: safe on a background
        thread while the current epoch keeps serving."""
        n_live = job.vectors.shape[0]
        if n_live > self.node_capacity:
            raise RuntimeError(
                f"live set {n_live} exceeds node_capacity {self.node_capacity}"
            )
        t0 = time.perf_counter()
        if n_live > 0:
            g, _ = build_udg(
                job.vectors, job.s, job.t, self.relation, **self._build_kwargs
            )
            job.graph = g
            job.entry = EntryTable(g)
        job.build_seconds = time.perf_counter() - t0
        return job

    def finish_compaction(self, job: _CompactionJob) -> CompactionReport:
        """Atomically swap in epoch N+1 (the only step that blocks queries)."""
        with self._lock:
            t0 = time.perf_counter()
            n_new = job.vectors.shape[0]
            if job.graph is not None:
                # stages the new epoch's device bundle eagerly: the swap is
                # the write point, queries only ever read it
                dg = export_planned_graph(
                    job.graph,
                    job.entry,
                    node_capacity=self.node_capacity,
                    edge_capacity=self.edge_capacity,
                    packed_labels=self._packed_labels,
                    device=self.device,
                )
            else:
                dg = _empty_device_graph(
                    self.dim, self.node_capacity, self.edge_capacity,
                    self.relation, packed=self._packed_labels,
                )
            graph_live = np.zeros(self.node_capacity, dtype=bool)
            graph_live[:n_new] = True
            graph_ext = np.full(self.node_capacity, -1, dtype=np.int64)
            graph_ext[:n_new] = job.ext
            graph_s = np.zeros(self.node_capacity, dtype=np.float64)
            graph_t = np.zeros(self.node_capacity, dtype=np.float64)
            graph_s[:n_new] = job.s
            graph_t[:n_new] = job.t

            # fresh delta: replay post-watermark live inserts
            old = self._delta
            delta = DeltaBuffer(self.dim, self.delta_capacity, self._rel)
            ext2loc: Dict[int, Tuple[str, int]] = {
                int(e): ("g", i) for i, e in enumerate(job.ext)
            }
            for slot in old.live_slots():
                if slot < job.delta_watermark:
                    continue
                ns = delta.append(
                    old.vectors[slot], old.s[slot], old.t[slot],
                    int(old.ext_ids[slot]),
                )
                ext2loc[int(old.ext_ids[slot])] = ("d", ns)
            # replay deletes that raced the build
            for ext in self._pending_deletes:
                loc = ext2loc.pop(ext, None)
                if loc is None:
                    continue
                tier, i = loc
                if tier == "g":
                    graph_live[i] = False
                else:
                    delta.tombstone(i)

            self._dg = dg
            dg.device(self.device)
            self._graph_n = n_new
            self._graph_live = graph_live
            self._graph_ext = graph_ext
            self._graph_s = graph_s
            self._graph_t = graph_t
            self._delta = delta
            self._ext2loc = ext2loc
            self._dev_mut = {}
            self._epoch += 1
            self._job_active = False
            self._pending_deletes = []
            report = CompactionReport(
                epoch=self._epoch,
                n_live=len(ext2loc),
                build_seconds=job.build_seconds,
                swap_seconds=time.perf_counter() - t0,
                delta_drained=job.delta_consumed,
                tombstones_cleared=job.tombstones,
            )
        if self._on_epoch_swap is not None:
            self._on_epoch_swap(report)
        return report

    def abort_compaction(self) -> None:
        """Abandon an in-flight compaction job (e.g. after a build failure);
        the current epoch stays live and mutations proceed normally."""
        with self._lock:
            self._job_active = False
            self._pending_deletes = []

    def compact(self) -> CompactionReport:
        """Synchronous compaction: snapshot, rebuild, swap."""
        job = self.begin_compaction()
        try:
            self.build_epoch(job)
        except BaseException:
            self.abort_compaction()
            raise
        return self.finish_compaction(job)

    def maybe_compact(self) -> Optional[CompactionReport]:
        if self.should_compact() and not self._job_active:
            return self.compact()
        return None

    # --- queries ----------------------------------------------------------------

    def _device_mutables(self, dev: torch.device) -> tuple:
        """The mutable arrays on ``dev`` (lock held): graph live mask and
        external ids, the delta segment and its norms. Uploaded once per
        mutation and device."""
        key = str(dev)
        if key not in self._dev_mut:
            live = self._graph_live.copy()
            ext = np.where(live, self._graph_ext, -1).astype(np.int32)
            seg = self._delta.device_segment()

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            dvec = put(seg.vectors)
            self._dev_mut[key] = (
                put(live), put(ext), dvec, put(seg.labels), put(seg.slot_ids),
                put(seg.ext_ids), delta_norms(dvec),
            )
        return self._dev_mut[key]

    def search(
        self,
        q: np.ndarray,
        s_q,
        t_q,
        *,
        k: int = 10,
        beam: int = 64,
        max_iters: Optional[int] = None,
        fused: bool = True,
        plan: str = "auto",
        planner_config: Optional[PlannerConfig] = None,
        return_stats: bool = False,
        device=None,
    ) -> Tuple[np.ndarray, ...]:
        """Two-tier search; returns (external ids [B, k], sq dists [B, k]),
        -1 padded. A 1-D query vector is treated as a batch of one.
        ``return_stats=True`` appends a host ``repro_torch.obs.SearchStats``
        (graph-tier traversal counters + per-query ``delta_valid``).

        ``plan="auto"`` routes the graph tier through the selectivity-aware
        executor (per-query graph / wide-beam / brute-valid);
        ``plan="graph"`` is the pre-planner behavior (parity oracle);
        ``plan="wide"`` forces the widened beam. The delta tier is scanned
        brute-force either way. ``device`` (``None``: the index's) is where
        the search runs; ``"cpu"`` runs the plain versions."""
        if plan not in ("auto", "graph", "wide"):
            raise ValueError(f"plan={plan!r} not in ('auto', 'graph', 'wide')")
        dev = self.device if device is None else resolve_device(device)
        q = np.asarray(q, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
            s_q = np.asarray([s_q], dtype=np.float64)
            t_q = np.asarray([t_q], dtype=np.float64)
        else:
            s_q = np.asarray(s_q, dtype=np.float64)
            t_q = np.asarray(t_q, dtype=np.float64)
        if k > beam:
            raise ValueError(f"k={k} > beam={beam}")

        with self._lock:
            # one epoch's consistent snapshot: the DeviceGraph's bundle is
            # swapped as a unit by finish_compaction, and the mutable arrays
            # are re-uploaded only after a mutation
            dg = self._dg
            didx = dg.device(dev)
            labels = dg.serving_labels(fused=fused, device=dev)
            *mut, dnorms = self._device_mutables(dev)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        states, ep, invalid = _graph_states(dg, s_q, t_q)
        dstate = query_key_state(self._rel, s_q, t_q)
        mi = max_iters if max_iters is not None else 2 * beam
        if plan == "graph":
            out = streaming_search_core(
                didx.table, didx.nbr, labels, *mut, put(q), put(states), put(ep),
                put(dstate), k=k, beam=beam, max_iters=mi, fused=fused,
                norms=didx.norms, dnorms=dnorms, stats=return_stats,
            )
        else:
            cfg = planner_config or default_planner_config()
            if plan == "wide":
                # forced wide needs only the invalid mask: no estimator pass
                plans = np.where(
                    invalid, np.int32(QueryPlan.BRUTE_VALID),
                    np.int32(QueryPlan.GRAPH_WIDE),
                ).astype(np.int32)
                bf_ids = np.full(
                    (states.shape[0], cfg.brute_max_valid), -1, np.int32
                )
            else:
                pb = plan_queries(dg.planner, states, invalid, config=cfg)
                plans, bf_ids = pb.plans, pb.bf_ids
            ep_graph, ep_wide = mask_entry_points(ep, plans)
            wide_beam = max(beam * cfg.wide_beam_scale, beam)
            out = planned_streaming_search_core(
                didx.table, didx.nbr, labels, *mut, put(q), put(states),
                put(ep_graph), put(ep_wide), put(bf_ids), put(plans),
                put(dstate), k=k, beam=beam, wide_beam=wide_beam,
                max_iters=mi, wide_max_iters=mi * cfg.wide_beam_scale,
                fused=fused, wide_expand=cfg.wide_expand if fused else 1,
                norms=didx.norms, dnorms=dnorms, stats=return_stats,
            )
        ids = out[0].cpu().numpy()
        d = out[1].cpu().numpy()
        if return_stats:
            st = stats_to_host(out[2])
            if single:
                return ids[0], d[0], st
            return ids, d, st
        if single:
            return ids[0], d[0]
        return ids, d
