"""Segmented streaming tier: segment-local compaction over routed inserts
(the JAX package's ``scale/stream.py`` on the port's ``StreamingIndex``).

One ``StreamingIndex`` per dominance-space grid cell, fronted by the same
value-space router the batch index uses. The properties this buys at
scale:

* **segment-local epoch swap** — a hot cell compacts (rebuild + atomic
  swap) without touching any other segment's epoch; the rest of the
  index keeps serving its current graphs untouched. ``epochs()`` and the
  ``swap_counts`` observer (wired through ``StreamingIndex``'s
  ``on_epoch_swap`` hook) make the locality observable and testable.
* **globally unique external ids** — sub-index ``c`` of ``C`` draws ids
  from the arithmetic progression ``c, c + C, c + 2C, …`` (the existing
  ``id_start``/``id_stride`` namespace), so ``delete``/lookup route by
  ``ext_id mod C`` with no id map.
* **uniform capacities** — every sub-index shares one
  ``node_capacity``/``edge_capacity``/``delta_capacity``, so every
  segment's device tensors keep one shape across epoch swaps and the flat
  ``device_stack()`` concatenates them.
* **segment-local durability and failure isolation** — with a
  ``storage_dir`` every cell gets its own ``WriteAheadLog`` (commit point
  = the per-cell append) under one index directory, ``save_snapshot``
  runs a coordinated multi-segment checkpoint whose commit point is an
  atomic CRC-framed manifest publish, and ``recover`` rebuilds all cells
  concurrently from the newest consistent generation plus per-cell WAL
  tails (``repro_torch.scale.durability``). A cell whose snapshot fails its
  integrity check — or that faults at runtime — is **quarantined**:
  masked out of routing, searches stay correct over the survivors
  (flagged via ``missing_segments``), and ``maybe_rebuild`` restores it
  with exponential backoff.

Inserts route by *transformed value* (``SegmentGrid.assign_values`` —
correct for values off the construction-time canonical grid, which is the
normal streaming case); queries route by the value-space corner test
(``route_values``), which over-selects but never drops a valid object —
the identical invariant the batch router is property-tested under.
Insert boundaries are hardened: non-finite intervals or vectors are
rejected before routing (``assign_values``' searchsorted would silently
mis-route a NaN into an arbitrary cell).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.predicates import get_relation
from repro_torch.data.synthetic import validate_intervals
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry, resolve
from repro_torch.scale.partition import SegmentGrid
from repro_torch.search.device_graph import SegmentStack
from repro_torch.stream.index import CompactionPolicy, CompactionReport, StreamingIndex


class SegmentedStreamingIndex:
    """Router + per-cell ``StreamingIndex`` fleet; one public mutation/query
    surface with segment-local compaction, durability, and quarantine.

    Every sub-index lives on ``device`` (``None``: the card), including the
    ones that recovery, quarantine and rebuilds create."""

    def __init__(
        self,
        dim: int,
        relation: str,
        grid: SegmentGrid,
        *,
        node_capacity: int = 4096,
        delta_capacity: int = 512,
        edge_capacity: int = 128,
        M: int = 16,
        Z: int = 64,
        K_p: int = 8,
        policy: Optional[CompactionPolicy] = None,
        build_kwargs: Optional[dict] = None,
        storage_dir: Optional[str] = None,
        wal_sync: str = "always",
        wal_segment_bytes: int = 1 << 20,
        registry: Optional[MetricsRegistry] = None,
        rebuild_backoff_s: float = 0.05,
        rebuild_backoff_max_s: float = 5.0,
        rebuild_backoff_seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.relation = relation
        self._rel = get_relation(relation)
        self.grid = grid
        self.node_capacity = int(node_capacity)
        self.delta_capacity = int(delta_capacity)
        self.edge_capacity = int(edge_capacity)
        self._M, self._Z, self._K_p = int(M), int(Z), int(K_p)
        self._policy = policy
        self._build_kwargs = build_kwargs
        self._reg = resolve(registry)
        self._registry = registry
        C = grid.num_cells
        self.swap_counts = [0] * C  # per-segment epoch swaps observed
        self._stack: Optional[SegmentStack] = None
        self.subs: List[StreamingIndex] = [
            StreamingIndex(
                on_epoch_swap=self._swap_observer(ci), **self._sub_kwargs(ci)
            )
            for ci in range(C)
        ]
        # --- durability + quarantine state ---------------------------------
        self.storage_dir: Optional[str] = None
        self.generation = 0
        self._wals: List[Optional[object]] = [None] * C
        self._wal_sync = wal_sync
        self._wal_segment_bytes = int(wal_segment_bytes)
        self.quarantined: Set[int] = set()
        self.quarantine_reasons: Dict[int, str] = {}
        self._q_src: Dict[int, StreamingIndex] = {}
        self._q_fails: Dict[int, int] = {}
        self._q_retry_at: Dict[int, float] = {}
        # rebuild backoff mirrors the compaction backoff policy: exponential
        # with full seeded jitter, capped at rebuild_backoff_max_s
        self._rebuild_backoff_s = float(rebuild_backoff_s)
        self._rebuild_backoff_max_s = float(rebuild_backoff_max_s)
        self._backoff_rng = np.random.default_rng(rebuild_backoff_seed)
        if storage_dir is not None:
            self._init_storage(storage_dir)

    def _sub_kwargs(self, cell: int) -> dict:
        """Construction kwargs for cell ``cell``'s sub-index — also the
        recipe recovery and rebuild use to re-create it."""
        return dict(
            dim=self.dim, relation=self.relation,
            node_capacity=self.node_capacity,
            delta_capacity=self.delta_capacity,
            edge_capacity=self.edge_capacity,
            M=self._M, Z=self._Z, K_p=self._K_p,
            policy=self._policy, build_kwargs=self._build_kwargs,
            id_start=cell, id_stride=self.grid.num_cells, device=self.device,
        )

    def _swap_observer(self, cell: int):
        def note(report: CompactionReport) -> None:
            self.swap_counts[cell] += 1
            # segment-local stack patch: only the swapped cell's slice of
            # the flat device bundle restages; every other part keeps its
            # existing device buffers (identity pinned in tests)
            if self._stack is not None:
                self._stack.set_segment(cell, *self._stack_part(cell))
        return note

    def _stack_part(self, cell: int):
        """One segment's current compacted-tier export + live external-id
        table (a consistent snapshot under the sub-index lock)."""
        sub = self.subs[cell]
        with sub._lock:
            dg = sub._dg
            gids = np.where(
                sub._graph_live, sub._graph_ext, -1
            ).astype(np.int32)
        return dg, gids

    def device_stack(self) -> SegmentStack:
        """Flat stacked device bundle over every segment's compacted tier
        (lazily built; ``on_epoch_swap`` patches ONLY the swapped
        segment's slice — never a fleet-wide rebuild). Part ``gids`` are
        live external ids, so the flat-graph layout matches the batch
        tier's scheduler contract."""
        if self._stack is None:
            st = SegmentStack(
                node_capacity=self.node_capacity,
                edge_capacity=self.edge_capacity,
                device=self.device,
            )
            for ci in range(self.num_segments):
                st.append_segment(*self._stack_part(ci))
            self._stack = st
        return self._stack

    # --- durability -----------------------------------------------------------

    def _init_storage(self, root: str) -> None:
        """Create a fresh durability directory: per-cell WALs attached to
        every sub (commit point = the cell append) and a generation-0
        manifest. Refuses a directory that already holds a manifest —
        reopening existing state must go through :meth:`recover`, which
        replays it instead of silently logging over it."""
        from repro_torch.scale.durability import (
            segment_dir,
            write_manifest,
        )
        from repro_torch.stream.wal import WriteAheadLog

        os.makedirs(root, exist_ok=True)
        if os.path.exists(os.path.join(root, "MANIFEST")):
            raise RuntimeError(
                f"{root}: existing segmented durability directory — "
                "use SegmentedStreamingIndex.recover(dir) instead"
            )
        for ci in range(self.num_segments):
            seg = segment_dir(root, ci)
            os.makedirs(seg, exist_ok=True)
            wal = WriteAheadLog(
                seg, sync=self._wal_sync,
                segment_bytes=self._wal_segment_bytes,
                registry=self._registry,
            )
            self._wals[ci] = wal
            self.subs[ci].attach_wal(wal)
        self.storage_dir = root
        self.generation = 0
        write_manifest(root, self._manifest_dict(0, [
            {"snapshot": None, "digest": None, "lsn": 0}
            for _ in range(self.num_segments)
        ]))

    def _bind_storage(
        self, root: str, *, generation: int, wal_sync: str,
        wal_segment_bytes: int, registry: Optional[MetricsRegistry],
    ) -> None:
        """Adopt an existing durability directory (recovery path — WALs are
        opened and attached per cell by ``recover_segmented``)."""
        self.storage_dir = root
        self.generation = int(generation)
        self._wal_sync = wal_sync
        self._wal_segment_bytes = int(wal_segment_bytes)
        self._registry = registry
        self._reg = resolve(registry)

    def _manifest_dict(self, generation: int, entries: List[dict]) -> dict:
        from repro_torch.scale.durability import grid_to_manifest

        return {
            "generation": int(generation),
            "relation": self.relation,
            "dim": int(self.dim),
            "node_capacity": self.node_capacity,
            "delta_capacity": self.delta_capacity,
            "edge_capacity": self.edge_capacity,
            "M": self._M, "Z": self._Z, "K_p": self._K_p,
            "grid": grid_to_manifest(self.grid),
            "segments": entries,
        }

    def save_snapshot(self) -> int:
        """Coordinated multi-segment checkpoint; returns the new generation.

        Per cell: ``StreamingIndex.save_snapshot`` to a NEW
        generation-named file (the previous generation stays untouched)
        with the cell's applied LSN captured under the same lock. Then ONE
        atomic manifest publish — the commit point — and only after it is
        durable are the per-cell WALs pruned and old generations deleted.
        A crash anywhere before the publish recovers the previous
        generation + full WAL tails; after it, the new one. Quarantined
        cells keep their previous manifest entry (their storage, if any,
        is the rebuild source — never overwritten by a placeholder).
        """
        from repro_torch.scale.durability import (
            _gc_snapshots,
            read_manifest,
            segment_dir,
            snapshot_name,
            write_manifest,
        )
        from repro_torch.stream.wal import file_digest

        if self.storage_dir is None:
            raise RuntimeError("no storage_dir bound; nothing to snapshot to")
        gen = self.generation + 1
        prev = read_manifest(self.storage_dir)["segments"]
        entries: List[dict] = []
        for ci, sub in enumerate(self.subs):
            if ci in self.quarantined:
                entries.append(prev[ci])
                continue
            name = snapshot_name(gen)
            path = os.path.join(segment_dir(self.storage_dir, ci), name)
            with sub._lock:     # snapshot + its LSN, mutually consistent
                sub.save_snapshot(path, prune_wal=False)
                lsn = sub._applied_lsn
            entries.append({
                "snapshot": name, "digest": file_digest(path),
                "lsn": int(lsn),
            })
        write_manifest(self.storage_dir, self._manifest_dict(gen, entries))
        self.generation = gen
        # post-publish housekeeping — safe to lose to a crash (recovery
        # GCs orphans and prune is idempotent)
        for ci in range(self.num_segments):
            if ci in self.quarantined:
                continue
            wal = self._wals[ci]
            if wal is not None:
                wal.prune(int(entries[ci]["lsn"]))
            _gc_snapshots(segment_dir(self.storage_dir, ci),
                          keep=entries[ci]["snapshot"])
        return gen

    @classmethod
    def recover(
        cls,
        root: str,
        *,
        policy: Optional[CompactionPolicy] = None,
        build_kwargs: Optional[dict] = None,
        registry: Optional[MetricsRegistry] = None,
        max_workers: Optional[int] = None,
        wal_sync: str = "always",
        wal_segment_bytes: int = 1 << 20,
        device=None,
    ):
        """Rebuild from a durability directory — ``(index, report)``. See
        :func:`repro_torch.scale.durability.recover_segmented`."""
        from repro_torch.scale.durability import recover_segmented

        return recover_segmented(
            root, policy=policy, build_kwargs=build_kwargs,
            registry=registry, max_workers=max_workers, wal_sync=wal_sync,
            wal_segment_bytes=wal_segment_bytes, device=device,
        )

    # --- quarantine + self-healing --------------------------------------------

    def _quarantine(self, cell: int, reason: str, *, stash: bool = True) -> None:
        if cell in self.quarantined:
            return
        old = self.subs[cell]
        wal = self._wals[cell]
        if wal is not None:
            try:
                wal.close()
            except OSError:
                pass
        self._wals[cell] = None
        if stash:
            # keep the pre-quarantine object: without storage it is the
            # only rebuild source (its host arrays survive a device-side
            # poison)
            self._q_src[cell] = old
        placeholder = StreamingIndex(**self._sub_kwargs(cell))
        placeholder._on_epoch_swap = self._swap_observer(cell)
        self.subs[cell] = placeholder
        self.quarantined.add(cell)
        self.quarantine_reasons[cell] = reason
        self._q_fails[cell] = 0
        self._q_retry_at[cell] = time.monotonic()
        if self._stack is not None:
            # scrub the slice so the poisoned rows can never surface, even
            # through a stale mask (same shapes and dtypes)
            self._stack.blank_segment(cell)
        self._reg.counter(
            "repro_segment_quarantines_total", "segments quarantined"
        ).inc()
        self._reg.gauge(
            "repro_segments_quarantined", "segments currently quarantined"
        ).set(len(self.quarantined))

    def quarantine_segment(self, cell: int, reason: str = "operator") -> None:
        """Isolate one cell: close its WAL, mask it out of routing, blank
        its device slice. Searches keep answering correctly over the
        survivors (``missing_segments`` flags the gap);
        :meth:`maybe_rebuild` works on lifting it."""
        self._quarantine(int(cell), reason, stash=True)

    def _lift_quarantine(self, cell: int, sub: StreamingIndex,
                         wal) -> None:
        sub._on_epoch_swap = self._swap_observer(cell)
        self.subs[cell] = sub
        self._wals[cell] = wal
        self.quarantined.discard(cell)
        self.quarantine_reasons.pop(cell, None)
        self._q_src.pop(cell, None)
        self._q_fails.pop(cell, None)
        self._q_retry_at.pop(cell, None)
        if self._stack is not None:
            self._stack.set_segment(cell, *self._stack_part(cell))
        self._reg.counter(
            "repro_segment_rebuilds_total", "quarantined segments restored"
        ).inc()
        self._reg.gauge(
            "repro_segments_quarantined", "segments currently quarantined"
        ).set(len(self.quarantined))

    def _rebuild_segment(self, cell: int) -> None:
        """One rebuild attempt (raises on failure — the caller backs off).

        With storage bound, the cell re-recovers from its own directory
        (digest-verified snapshot + WAL tail — authoritative, includes
        mutations the in-memory copy may have lost). Without storage, the
        live set of the stashed pre-quarantine object is re-applied with
        its original external ids."""
        from repro_torch.scale.durability import _recover_cell, read_manifest

        if self.storage_dir is not None:
            entry = read_manifest(self.storage_dir)["segments"][cell]
            sub, wal, rec = _recover_cell(
                self.storage_dir, cell, entry, self._sub_kwargs(cell),
                wal_sync=self._wal_sync,
                wal_segment_bytes=self._wal_segment_bytes,
                registry=self._registry,
            )
            if rec.quarantined:
                raise RuntimeError(f"cell {cell} storage still bad: "
                                   f"{rec.reason}")
            self._lift_quarantine(cell, sub, wal)
            return
        src = self._q_src.get(cell)
        if src is None:
            raise RuntimeError(
                f"cell {cell}: no storage and no in-memory rebuild source"
            )
        from repro_torch.stream.wal import KIND_INSERT, WalRecord

        vec, s, t, ext = src.snapshot_live()
        sub = StreamingIndex(**self._sub_kwargs(cell))
        # ascending ext id == original per-cell insertion order (ids are
        # handed out monotonically per cell), so the rebuild is the
        # deterministic fresh-index oracle over the live set
        for j, i in enumerate(np.argsort(ext)):
            sub.apply_record(WalRecord(
                lsn=j + 1, kind=KIND_INSERT, ext_id=int(ext[i]),
                s=float(s[i]), t=float(t[i]), vec=vec[i],
            ))
        self._lift_quarantine(cell, sub, None)

    def maybe_rebuild(self) -> Dict[int, bool]:
        """Poll the rebuild ladder: one attempt per quarantined cell whose
        backoff deadline has passed. Exponential backoff with full seeded
        jitter (the compaction backoff policy) on failure. Returns
        {cell: succeeded} for the cells attempted this call."""
        out: Dict[int, bool] = {}
        now = time.monotonic()
        for cell in sorted(self.quarantined):
            if now < self._q_retry_at.get(cell, 0.0):
                continue
            try:
                self._rebuild_segment(cell)
            except Exception:
                fails = self._q_fails.get(cell, 0) + 1
                self._q_fails[cell] = fails
                delay = min(
                    self._rebuild_backoff_s * (2 ** (fails - 1)),
                    self._rebuild_backoff_max_s,
                )
                delay *= 0.5 + 0.5 * self._backoff_rng.random()
                self._q_retry_at[cell] = time.monotonic() + delay
                out[cell] = False
            else:
                out[cell] = True
        return out

    # --- introspection --------------------------------------------------------

    @property
    def num_segments(self) -> int:
        return len(self.subs)

    @property
    def live_count(self) -> int:
        return sum(sub.live_count for sub in self.subs)

    def epochs(self) -> List[int]:
        """Per-segment epoch numbers — segment-local by construction."""
        return [sub.epoch for sub in self.subs]

    def live_ids(self) -> np.ndarray:
        parts = [sub.live_ids() for sub in self.subs]
        return np.sort(np.concatenate(parts)) if parts else np.empty(0, np.int64)

    # --- mutations ------------------------------------------------------------

    def _route_cells(
        self, vecs: np.ndarray, s: np.ndarray, t: np.ndarray, what: str
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Validated batched insert routing — ``(vecs f32, s, t, cell)``.

        NaN/Inf endpoints or vector components are rejected BEFORE
        ``assign_values``: searchsorted on a NaN silently lands in an
        arbitrary cell, which would both mis-route the object and poison
        that segment's distances."""
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        s, t = validate_intervals(s, t, what=what)
        if vecs.ndim != 2 or vecs.shape != (s.shape[0], self.dim):
            raise ValueError(
                f"{what}: vectors {vecs.shape} do not match "
                f"({s.shape[0]}, {self.dim})"
            )
        if not np.all(np.isfinite(vecs)):
            raise ValueError(f"{what}: non-finite vector components")
        X, Y = self._rel.transform_data(s, t)
        cell = self.grid.assign_values(X, Y)
        bad = sorted(set(int(c) for c in np.unique(cell))
                     & self.quarantined)
        if bad:
            raise RuntimeError(
                f"{what}: segment(s) {bad} are quarantined — inserts "
                "cannot be acknowledged until rebuilt (ids could collide "
                "with the lost state)"
            )
        return vecs, s, t, cell

    def insert(self, vec: np.ndarray, s: float, t: float) -> int:
        """Route by transformed value, insert into the owning segment;
        returns the globally unique external id. Non-finite intervals or
        vector components are rejected at this boundary."""
        vec = np.asarray(vec, dtype=np.float32).reshape(1, -1)
        vecs, s_a, t_a, cell = self._route_cells(
            vec, [s], [t], "SegmentedStreamingIndex.insert"
        )
        return self.subs[int(cell[0])].insert(
            vecs[0], float(s_a[0]), float(t_a[0])
        )

    def insert_batch(
        self, vecs: np.ndarray, s: np.ndarray, t: np.ndarray
    ) -> np.ndarray:
        """Batched insert: ONE vectorized transform + grid assignment for
        the whole batch (no per-row ``_cell_of`` round trips), then
        per-cell appends in row order — ids are identical to the
        row-by-row path because each cell's arrival order is preserved."""
        vecs, s_a, t_a, cell = self._route_cells(
            vecs, s, t, "SegmentedStreamingIndex.insert_batch"
        )
        out = np.empty(cell.shape[0], dtype=np.int64)
        for ci in np.unique(cell):
            rows = np.flatnonzero(cell == ci)
            sub = self.subs[int(ci)]
            for r in rows:
                out[r] = sub.insert(vecs[r], float(s_a[r]), float(t_a[r]))
        return out

    def delete(self, ext_id: int) -> bool:
        """Id-namespace routing: segment = ``ext_id mod num_segments``.
        Deletes routed to a quarantined cell return False (the id is not
        reachable; its tombstone lands when the cell is rebuilt from its
        authoritative storage)."""
        return self.subs[int(ext_id) % self.num_segments].delete(ext_id)

    def maybe_compact(self) -> Dict[int, CompactionReport]:
        """Poll every segment's compaction policy; segments compact (and
        epoch-swap) INDEPENDENTLY — the returned dict maps the cell ids
        that actually swapped to their reports."""
        out: Dict[int, CompactionReport] = {}
        for ci, sub in enumerate(self.subs):
            if ci in self.quarantined:
                continue
            rep = sub.maybe_compact()
            if rep is not None:
                out[ci] = rep
        return out

    # --- queries --------------------------------------------------------------

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
        return_partial: bool = False,
    ):
        """Routed two-tier search — ``(ext ids [B, k] int64, d [B, k])``.

        Value-space routing skips whole segments no query row can
        intersect (recall-safe corner test); routed segments run their
        normal streaming search and the per-segment top-k merge by the
        ground-truth ``(distance, id)`` tie rule. External ids are
        globally unique across segments, so the merge needs no dedup.

        Quarantined segments are masked out of the route — the answer is
        the correct top-k over the surviving segments. A segment that
        RAISES during its search is quarantined on the spot (fault
        isolation: one bad cell degrades coverage, never availability).
        ``return_partial=True`` appends a
        :class:`repro_torch.scale.segmented.PartialSearchInfo` whose
        ``missing_segments`` lists the quarantined cells this batch would
        have routed to. Every sub-index searches on the index's device.
        """
        from repro_torch.scale.segmented import PartialSearchInfo

        q = np.asarray(q, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
            s_q = np.asarray([s_q], dtype=np.float64)
            t_q = np.asarray([t_q], dtype=np.float64)
        else:
            s_q = np.asarray(s_q, dtype=np.float64)
            t_q = np.asarray(t_q, dtype=np.float64)
        B = q.shape[0]
        x_q, y_q = self._rel.query_map(s_q, t_q)
        route = self.grid.route_values(x_q, y_q)  # [B, C] bool

        missing = [ci for ci in sorted(self.quarantined)
                   if route[:, ci].any()]
        all_ids = np.full((B, 0), -1, dtype=np.int64)
        all_d = np.full((B, 0), np.inf, dtype=np.float32)
        for ci, sub in enumerate(self.subs):
            if ci in self.quarantined or not route[:, ci].any():
                continue
            try:
                ids_c, d_c = sub.search(
                    q, s_q, t_q, k=k, beam=beam, max_iters=max_iters,
                    fused=fused, plan=plan,
                )
            except Exception as exc:      # noqa: BLE001 — fault isolation:
                # whatever broke this segment must not take down the index
                self._quarantine(ci, f"search fault: {exc!r}")
                missing.append(ci)
                continue
            ids_c = np.asarray(ids_c, dtype=np.int64)
            d_c = np.where(ids_c >= 0, np.asarray(d_c, np.float32), np.inf)
            all_ids = np.concatenate([all_ids, ids_c], axis=1)
            all_d = np.concatenate([all_d, d_c], axis=1)

        if all_ids.shape[1] == 0:
            ids = np.full((B, k), -1, dtype=np.int64)
            d = np.full((B, k), np.inf, dtype=np.float32)
        else:
            pad = max(k - all_ids.shape[1], 0)
            if pad:
                all_ids = np.pad(all_ids, ((0, 0), (0, pad)),
                                 constant_values=-1)
                all_d = np.pad(all_d, ((0, 0), (0, pad)),
                               constant_values=np.inf)
            order = np.lexsort((all_ids, all_d))[:, :k]
            ids = np.take_along_axis(all_ids, order, axis=1)
            d = np.take_along_axis(all_d, order, axis=1).astype(np.float32)
        if single:
            ids, d = ids[0], d[0]
        if return_partial:
            info = PartialSearchInfo(
                degraded=bool(missing), missing_segments=sorted(missing),
            )
            return ids, d, info
        return ids, d
