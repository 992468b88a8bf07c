"""Segmented UDG: per-segment subgraphs + coarse routing + int8/rerank.

The scale-out form of the index (the JAX package's ``scale/segmented.py``
on torch). The normalized dominance space is partitioned by
:class:`repro_torch.scale.partition.SegmentGrid`; every non-empty cell
becomes a *segment* holding an independent UDG subgraph over its members,
exported in the packed-label device layout with one uniform node and edge
capacity. Queries flow through three stages:

1. **route** — the grid's corner test selects the cells a query's
   dominance rectangle can intersect at all (recall-safe: over-selects,
   never drops — see ``partition.py``), then each routed segment's
   ``SelectivityEstimator`` refines with its histogram upper bound
   (``hi == 0`` ⇒ the segment provably holds no valid object ⇒ skip).
   Routing is host numpy on the global canonical grids, as the
   reference's, so the route masks are the reference's bit for bit.
2. **execute** — the routed (query, segment) pairs become one worklist,
   run as ONE ``exec.executor.worklist_exec_core`` call over the flat
   :class:`repro_torch.search.SegmentStack` (``scheduler=True``), padded to
   a quarter-octave bucket (``worklist_capacity``) so the worklist shapes
   equal the reference's. ``scheduler=False`` runs one
   ``execute_batch(row_mask=...)`` per routed segment and folds them one
   after another: the bit-exact parity oracle.
3. **merge + rerank** — per-segment top-``fetch`` results fold into one
   top-``fetch`` through ``ops.topk_merge`` (B2), then an exact f32
   **rerank tail** re-scores the fused candidates against the original
   vectors on the host and keeps the top-k by (distance, id), the ground
   truth's tie rule, so int8 residency changes candidate generation only.

On the card every search launches the kernels through ``ops`` (B1 and B2
each iteration, B3 on BRUTE_VALID rows, B4 with ``fused=False``); on CPU
tensors the plain versions run. Nothing is compiled per shape, so the
reference's jit-cache counters (``merge_fold_cache_size``,
``worklist_exec_cache_size``) have no counterpart; :func:`dispatch_count`
and the kernels' launch counts show that a batch is one dispatch.

Segment membership is disjoint, so global ids never collide in the merge;
distances from int8 segments are dequantized-row distances and are
replaced by exact f32 distances whenever ``rerank=True`` (the default).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.build_batched import _bucket, build_graphs_concurrent
from repro_torch.core.predicates import DominanceSpace, RelationMapping, get_relation
from repro_torch.device import resolve_device
from repro_torch.exec import (
    PlannerConfig,
    QueryPlan,
    default_planner_config,
    execute_batch,
    export_planned_graph,
    mask_entry_points,
    plan_queries,
    planned_graph_from_numpy,
    worklist_exec_core,
)
from repro_torch.exec.executor import PLANS
from repro_torch.kernels import ops
from repro_torch.obs.metrics import resolve
from repro_torch.obs.stats import SearchStats, combine_stats, init_search_stats, stats_to_host
from repro_torch.scale.partition import SegmentGrid, canonicalize_batch
from repro_torch.search.batched import prepare_states_extended
from repro_torch.search.device_graph import RANK_LIMIT, SegmentStack


@dataclasses.dataclass
class Segment:
    """One dominance-space cell's resident subgraph."""

    cell: int            # flattened grid cell id
    ids: np.ndarray      # [m] int64 global object ids (ascending)
    dg: object           # DeviceGraph over the segment's members
    report: object       # its wave-build report (None when carried over)


@dataclasses.dataclass
class PartialSearchInfo:
    """Degradation flag attached to a search answer when segments are
    quarantined: the answer is the correct top-k over every SURVIVING
    segment; ``missing_segments`` lists the quarantined segment indices
    the batch's route would have touched."""

    degraded: bool
    missing_segments: List[int]


# process-wide dispatch tally: the scheduler issues ONE dispatch per batch
# whatever the routed-segment mix, the loop one per routed segment
_dispatch_count = 0


def dispatch_count() -> int:
    """Device dispatches issued by ``SegmentedIndex.search`` so far in this
    process (scheduler: 1 a batch; loop: 1 a routed segment)."""
    return _dispatch_count


def _note_dispatch() -> None:
    global _dispatch_count
    _dispatch_count += 1


def worklist_capacity(w: int) -> int:
    """Quarter-octave bucketed worklist capacity (floor 8): the padded
    ``[W]`` length the scheduler dispatches with. Buckets are the powers of
    two plus the 1.25/1.5/1.75 intermediate steps (8, 10, 12, 14, 16, 20,
    24, 28, 32, 40, ...), so padding waste stays under 25 %, and the
    worklist shapes equal the reference's."""
    w = max(int(w), 8)
    p = 1 << (w - 1).bit_length()   # next power of two >= w
    h = p >> 1
    for cap in (h + h // 4, h + h // 2, h + 3 * h // 4):
        if w <= cap:
            return cap
    return p


def _host_stats(st) -> SearchStats:
    return SearchStats(*(torch.as_tensor(np.asarray(x)) for x in st))


class SegmentedIndex:
    """Scale-out UDG: routed per-segment subgraphs behind one search API.

    Build with :func:`build_segmented_index` (or carry a JAX-built one over
    with :func:`segmented_index_from_numpy`); query with :meth:`search`.
    The index lives on ``device`` (``None``: the card); a search may name
    another (``device="cpu"``: the plain versions) and stages a stack there.
    """

    def __init__(
        self,
        relation: RelationMapping,
        grid: SegmentGrid,
        space: DominanceSpace,
        segments: Sequence[Segment],
        vectors: np.ndarray,
        *,
        node_capacity: int,
        edge_capacity: int,
        quantized: bool,
        packed: bool,
        device=None,
    ):
        self.relation = relation
        self.grid = grid
        self.space = space
        self.segments = list(segments)
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n = int(self.vectors.shape[0])
        self.node_capacity = int(node_capacity)
        self.edge_capacity = int(edge_capacity)
        self.quantized = bool(quantized)
        self.packed = bool(packed)
        self.device = resolve_device(device)
        # dedup sentinel for the merge fold: any bound strictly above every
        # global id (a power of two, as the reference's)
        self._n_sentinel = 1 << max(int(self.n).bit_length(), 1)
        self._stacks: dict = {}
        self.quarantined: set = set()

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def device_stack(self, device=None) -> SegmentStack:
        """Memoized flat stack over all segments on ``device`` (``None``:
        the index's), built on the first scheduler dispatch there and reused
        for every batch after. Quarantined segments' slices are blank."""
        dev = self.device if device is None else resolve_device(device)
        st = self._stacks.get(str(dev))
        if st is None:
            st = SegmentStack(node_capacity=self.node_capacity,
                              edge_capacity=self.edge_capacity, device=dev)
            for si, seg in enumerate(self.segments):
                st.append_segment(seg.dg, seg.ids)
                if si in self.quarantined:
                    st.blank_segment(si)
            self._stacks[str(dev)] = st
        return st

    def segment_sizes(self) -> np.ndarray:
        return np.array([seg.ids.shape[0] for seg in self.segments], dtype=np.int64)

    # --- quarantine -----------------------------------------------------------

    def _quarantine_gauge(self) -> None:
        resolve(None).gauge(
            "repro_segments_quarantined", "segments currently quarantined"
        ).set(len(self.quarantined), tier="batch")

    def quarantine_segment(self, si: int, reason: str = "operator") -> None:
        """Mask segment ``si`` out of every future route and scrub its
        staged slices. The worklist simply gets fewer rows; searches stay
        correct over the survivors and ``return_partial=True`` reports the
        gap."""
        si = int(si)
        if si in self.quarantined:
            return
        self.quarantined.add(si)
        for st in self._stacks.values():
            st.blank_segment(si)
        self._quarantine_gauge()

    def lift_quarantine(self, si: int) -> None:
        """Restore segment ``si`` (its host export is intact: quarantine only
        masked routing and blanked the staged slices)."""
        si = int(si)
        if si not in self.quarantined:
            return
        self.quarantined.discard(si)
        seg = self.segments[si]
        for st in self._stacks.values():
            st.set_segment(si, seg.dg, seg.ids)
        self._quarantine_gauge()

    # --- routing --------------------------------------------------------------

    def _query_states(self, s_q, t_q):
        """Transformed + globally canonicalized batch — (x_q, y_q, a, c,
        valid)."""
        s_q = np.asarray(s_q, dtype=np.float64).reshape(-1)
        t_q = np.asarray(t_q, dtype=np.float64).reshape(-1)
        x_q, y_q = self.relation.query_map(s_q, t_q)
        a, c, valid = canonicalize_batch(self.space, x_q, y_q)
        return np.asarray(x_q, np.float64), np.asarray(y_q, np.float64), a, c, valid

    def _cells_to_segments(self, cells: np.ndarray) -> np.ndarray:
        route = np.zeros((cells.shape[0], self.num_segments), dtype=bool)
        for si, seg in enumerate(self.segments):
            route[:, si] = cells[:, seg.cell]
        return route

    def coarse_route(self, s_q, t_q) -> Tuple[np.ndarray, np.ndarray]:
        """Grid-level routing — ``(route [B, num_segments] bool, valid)``,
        columns in ``self.segments`` order. Over-selection is expected;
        dropping a valid object is a bug."""
        _, _, a, c, valid = self._query_states(s_q, t_q)
        return self._cells_to_segments(self.grid.route_ranks(a, c, valid)), valid

    def _refine_route(self, route: np.ndarray, x_q: np.ndarray, y_q: np.ndarray) -> np.ndarray:
        """AND each routed column with the segment planner's ``hi > 0``
        (``hi`` is a true upper bound on the segment-local valid count, so
        ``hi == 0`` segments are provably empty for the query)."""
        out = route.copy()
        for si, seg in enumerate(self.segments):
            col = out[:, si]
            if not col.any():
                continue
            dg = seg.dg
            a_loc = np.searchsorted(dg.U_X, x_q, side="left").astype(np.int64)
            c_loc = (np.searchsorted(dg.U_Y, y_q, side="right") - 1).astype(np.int64)
            _, hi = dg.planner.count_bounds(a_loc, c_loc)
            out[:, si] = col & (hi > 0)
        return out

    # --- search ---------------------------------------------------------------

    def search(
        self,
        q: np.ndarray,
        s_q: np.ndarray,
        t_q: np.ndarray,
        *,
        k: int = 10,
        beam: int = 64,
        fetch_k: Optional[int] = None,
        rerank: bool = True,
        plan: str = "auto",
        config: Optional[PlannerConfig] = None,
        fused: bool = True,
        expand: int = 1,
        max_iters: Optional[int] = None,
        return_route: bool = False,
        return_partial: bool = False,
        scheduler: bool = True,
        stats: bool = False,
        device=None,
    ):
        """Routed top-k over all segments — ``(ids [B, k] int64, d [B, k])``.

        ``fetch_k`` is the per-segment candidate width fed to the merge fold
        (default ``2k`` when the int8 rerank tail is on, else ``k``);
        ``rerank=True`` replaces resident-layout distances with exact f32
        distances over the fused candidates and re-sorts by (distance, id).
        ``return_route`` appends the refined ``[B, num_segments]`` routing
        mask, ``return_partial`` a :class:`PartialSearchInfo`, ``stats=True``
        a per-query host ``SearchStats`` (always last).

        ``scheduler=True`` (default) runs the routed mix as ONE
        ``worklist_exec_core`` dispatch over the flat stack;
        ``scheduler=False`` keeps the per-segment loop, the bit-exact parity
        oracle (results AND stats identical). ``device`` (``None``: the
        index's) is where the search runs."""
        dev = self.device if device is None else resolve_device(device)
        q = np.asarray(q, dtype=np.float32)
        s_q = np.asarray(s_q, dtype=np.float64).reshape(-1)
        t_q = np.asarray(t_q, dtype=np.float64).reshape(-1)
        B = q.shape[0]
        fetch = int(fetch_k) if fetch_k is not None else (
            2 * k if (rerank and self.quantized) else k)
        fetch = max(fetch, k)
        beam_eff = max(beam, fetch)
        cfg = config or default_planner_config()
        x_q, y_q, a, c, valid = self._query_states(s_q, t_q)
        route = self._cells_to_segments(self.grid.route_ranks(a, c, valid))
        # quarantined segments drop out of the route BEFORE refinement: the
        # worklist just has fewer rows, the answer is exact over survivors
        missing = [si for si in sorted(self.quarantined) if route[:, si].any()]
        if self.quarantined:
            route[:, sorted(self.quarantined)] = False
        route = self._refine_route(route, x_q, y_q)

        if scheduler:
            ids, d, st = self._search_worklist(
                q, s_q, t_q, route, fetch=fetch, beam_eff=beam_eff,
                max_iters=max_iters, fused=fused, expand=expand, plan=plan,
                config=cfg, stats=stats, dev=dev,
            )
        else:
            ids, d, st = self._search_loop(
                q, s_q, t_q, route, fetch=fetch, beam_eff=beam_eff,
                max_iters=max_iters, fused=fused, expand=expand, plan=plan,
                config=cfg, stats=stats, dev=dev,
            )
        if rerank:
            ids, d = self._rerank_exact(q, ids, d, k)
        else:
            ids, d = ids[:, :k], d[:, :k]
        out = (ids.astype(np.int64), d.astype(np.float32))
        if return_route:
            out += (route,)
        if return_partial:
            out += (PartialSearchInfo(degraded=bool(missing), missing_segments=missing),)
        if stats:
            out += (st,)
        return out

    def _search_loop(self, q, s_q, t_q, route, *, fetch, beam_eff, max_iters,
                     fused, expand, plan, config, stats, dev):
        """The per-segment loop: one ``execute_batch(row_mask=...)`` per
        routed segment, folded into a running top-``fetch`` in segment
        order."""
        B = q.shape[0]
        acc_ids = torch.full((B, fetch), -1, dtype=torch.int32, device=dev)
        acc_d = torch.full((B, fetch), float("inf"), dtype=torch.float32, device=dev)
        acc_st = None
        for si, seg in enumerate(self.segments):
            mask = route[:, si]
            if not mask.any():
                continue
            _note_dispatch()
            out_s = execute_batch(
                seg.dg, q, s_q, t_q, k=fetch, beam=beam_eff, max_iters=max_iters,
                fused=fused, expand=expand, plan=plan, config=config,
                row_mask=mask, packed=self.packed, stats=stats, device=dev,
            )
            loc_ids, loc_d = out_s[0], out_s[1]
            if stats:
                acc_st = out_s[-1] if acc_st is None else stats_to_host(
                    combine_stats(_host_stats(acc_st), _host_stats(out_s[-1])))
            m = seg.ids.shape[0]
            glob = np.where(loc_ids >= 0, seg.ids[np.clip(loc_ids, 0, m - 1)],
                            -1).astype(np.int32)
            acc_ids, acc_d = ops.topk_merge(
                acc_d, acc_ids, torch.as_tensor(loc_d, device=dev),
                torch.as_tensor(glob, device=dev), n=self._n_sentinel)
        st = None
        if stats:
            if acc_st is None:
                mi = max_iters if max_iters is not None else 2 * beam_eff
                acc_st = stats_to_host(init_search_stats(B, mi * config.wide_beam_scale))
            st = acc_st
        return acc_ids.cpu().numpy(), acc_d.cpu().numpy(), st

    def _search_worklist(self, q, s_q, t_q, route, *, fetch, beam_eff, max_iters,
                         fused, expand, plan, config, stats, dev):
        """One-dispatch scheduler body — ``(ids [B, fetch] int32 global,
        d [B, fetch] f32, stats | None)``.

        Host side: per routed segment, slice the routed query rows,
        canonicalize on the segment grid and plan them (row-independent, so
        plans match the loop's full-batch ``row_mask`` call exactly), then
        concatenate segment-major into one ``[W]`` worklist padded to
        ``worklist_capacity(W)``. Device side: one ``worklist_exec_core``
        call over the memoized flat stack."""
        if plan not in PLANS:
            raise ValueError(f"plan={plan!r} not in {PLANS}")
        B = q.shape[0]
        cfg = config
        mi = max_iters if max_iters is not None else 2 * beam_eff
        wide_mi = mi * cfg.wide_beam_scale
        wide_beam = max(beam_eff * cfg.wide_beam_scale, beam_eff)
        wide_expand = min(cfg.wide_expand if fused else 1, wide_beam)

        qids, segs, sts, eps_g, eps_w, bfs, pls = [], [], [], [], [], [], []
        for si, seg in enumerate(self.segments):
            rows = np.flatnonzero(route[:, si])
            if rows.size == 0:
                continue
            dg = seg.dg
            st_loc, ep, inv = prepare_states_extended(dg, s_q[rows], t_q[rows])
            w = rows.shape[0]
            if plan == "auto":
                pb = plan_queries(dg.planner, st_loc, inv, config=cfg)
                pl, bf = pb.plans, pb.bf_ids
            elif plan in ("graph", "wide"):
                forced = QueryPlan.GRAPH if plan == "graph" else QueryPlan.GRAPH_WIDE
                pl = np.full(w, int(forced), dtype=np.int32)
                bf = np.full((w, cfg.brute_max_valid), -1, dtype=np.int32)
            else:  # forced brute: exact lists; width unified over the whole
                # worklist below (extra -1 columns are dead candidates)
                pl = np.full(w, int(QueryPlan.BRUTE_VALID), dtype=np.int32)
                bf = [np.empty(0, np.int32) if inv[j]
                      else dg.planner.exact_valid_ids(int(st_loc[j, 0]), int(st_loc[j, 1]))
                      for j in range(w)]
            ep_g, ep_w = mask_entry_points(ep, pl)
            qids.append(rows.astype(np.int32))
            segs.append(np.full(w, si, dtype=np.int32))
            sts.append(st_loc)
            eps_g.append(ep_g)
            eps_w.append(ep_w)
            bfs.append(bf)
            pls.append(pl)

        if not qids:
            # empty worklist: nothing routed anywhere, no device dispatch
            st = stats_to_host(init_search_stats(B, wide_mi)) if stats else None
            return (np.full((B, fetch), -1, dtype=np.int32),
                    np.full((B, fetch), np.inf, dtype=np.float32), st)

        qid = np.concatenate(qids)
        seg_arr = np.concatenate(segs)
        states = np.concatenate(sts, axis=0).astype(np.int32)
        ep_g = np.concatenate(eps_g)
        ep_w = np.concatenate(eps_w)
        plans = np.concatenate(pls)
        if plan == "brute":
            lists = [lst for bl in bfs for lst in bl]
            cap = max(int(max((lst.shape[0] for lst in lists), default=1)), 1)
            cap = 1 << (cap - 1).bit_length()
            bf = np.full((len(lists), cap), -1, dtype=np.int32)
            for i, lst in enumerate(lists):
                bf[i, : lst.shape[0]] = lst
        else:
            bf = np.concatenate(bfs, axis=0).astype(np.int32)

        W0 = qid.shape[0]
        pad = worklist_capacity(W0) - W0
        if pad:
            # padding items: query row B (scattered into a dropped row),
            # segment 0, no entry points, empty brute lists -> no work
            qid = np.concatenate([qid, np.full(pad, B, np.int32)])
            seg_arr = np.concatenate([seg_arr, np.zeros(pad, np.int32)])
            states = np.concatenate([states, np.zeros((pad, 2), np.int32)], axis=0)
            ep_g = np.concatenate([ep_g, np.full(pad, -1, np.int32)])
            ep_w = np.concatenate([ep_w, np.full(pad, -1, np.int32)])
            bf = np.concatenate([bf, np.full((pad, bf.shape[1]), -1, np.int32)], axis=0)
            plans = np.concatenate([plans, np.full(pad, int(QueryPlan.GRAPH), np.int32)])

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        stack = self.device_stack(dev)
        _note_dispatch()
        out = worklist_exec_core(
            stack.flat("table"), stack.flat("nbr"),
            stack.flat_labels(fused=fused, packed=self.packed), stack.flat("gids"),
            put(q), put(qid), put(seg_arr), put(states), put(ep_g), put(ep_w),
            put(bf), put(plans),
            k=fetch, beam=beam_eff, wide_beam=wide_beam, max_iters=mi,
            wide_max_iters=wide_mi, expand=expand, wide_expand=wide_expand,
            norms=stack.flat("norms"), scales=stack.flat("scales"), fused=fused,
            stats=stats, node_cap=self.node_capacity, n_sentinel=self._n_sentinel,
        )
        st = stats_to_host(out[2]) if stats else None
        return out[0].cpu().numpy(), out[1].cpu().numpy(), st

    def _rerank_exact(self, q: np.ndarray, ids: np.ndarray, d: np.ndarray,
                      k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Float32 exact-rerank tail over the fused candidates, host numpy
        exactly as the reference computes it: gather the original f32 rows,
        re-score ``‖v − q‖²`` (an f32 einsum) and select top-k by
        ``(distance, id)`` with ``np.lexsort``, the ground truth's tie rule."""
        safe = np.clip(ids, 0, self.n - 1)
        vv = self.vectors[safe]                       # [B, L, D] f32
        diff = vv - q[:, None, :]
        d_ex = np.einsum("bld,bld->bl", diff, diff).astype(np.float32)
        d_ex = np.where(ids >= 0, d_ex, np.float32(np.inf))
        order = np.lexsort((ids, d_ex))               # per-row (d, id) sort
        sel = order[:, :k]
        return np.take_along_axis(ids, sel, axis=1), np.take_along_axis(d_ex, sel, axis=1)

    # --- accounting -----------------------------------------------------------

    def nbytes_by_component(self) -> dict:
        """Aggregated at-rest (host) bytes: per-segment ``DeviceGraph``
        components summed key-wise, plus the router's state under
        ``"router"``. The sum equals :meth:`nbytes` exactly. The staged
        stack's device bytes are ``device_stack().nbytes_by_component()``."""
        agg: dict = {}
        for seg in self.segments:
            for key, v in seg.dg.nbytes_by_component().items():
                agg[key] = agg.get(key, 0) + v
        agg["router"] = self.grid.nbytes()
        return agg

    def nbytes(self) -> int:
        return sum(self.nbytes_by_component().values())


def build_segmented_index(
    vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    relation: str,
    *,
    cells_per_axis: int = 4,
    M: int = 16,
    Z: int = 64,
    K_p: int = 8,
    leap: str = "maxleap",
    patch: str = "full",
    wave: int = 256,
    lane: int = 8,
    quantize_int8: bool = True,
    planner_buckets: int = 64,
    device=None,
) -> SegmentedIndex:
    """Partition, build all segment subgraphs through one wave pipeline,
    export.

    Every non-empty grid cell becomes a segment; the per-segment UDGs are
    built by ``build_graphs_concurrent`` (each graph identical to its own
    wave build; the wave searches on ``device``, ``None`` = the card) and
    exported with a UNIFORM ``node_capacity`` (the largest segment,
    bucketed) and ``edge_capacity`` (the largest degree anywhere,
    lane-aligned), packed labels when every segment's grids fit the 16-bit
    rank budget, int8 rows by default (the rerank tail restores exact final
    ordering). The exports are staged on ``device``.
    """
    device = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    rel = get_relation(relation)
    X, Y = rel.transform_data(s, t)
    space = DominanceSpace.build(X, Y)
    xr, yr = space.ranks()
    grid = SegmentGrid.from_space(space, cells_per_axis)
    cell = grid.assign_ranks(xr, yr)

    members: List[np.ndarray] = []
    cells_used: List[int] = []
    for cc in np.unique(cell):
        members.append(np.flatnonzero(cell == cc).astype(np.int64))  # ascending
        cells_used.append(int(cc))

    node_cap = _bucket(max(int(ids.shape[0]) for ids in members))
    s = np.asarray(s, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    built = build_graphs_concurrent(
        [(vectors[ids], s[ids], t[ids]) for ids in members], relation,
        M=M, Z=Z, K_p=K_p, leap=leap, patch=patch, wave=wave,
        pad_nodes=node_cap, device=device,
    )

    # uniform lane-aligned edge capacity = the max natural degree anywhere
    E = lane
    fits = True
    for g, _ in built:
        deg = max((g.adj[u].size for u in range(g.n)), default=1)
        E = max(E, ((deg + lane - 1) // lane) * lane)
        fits &= (g.space.U_X.shape[0] <= RANK_LIMIT and g.space.U_Y.shape[0] <= RANK_LIMIT)

    segments = []
    for cc, ids, (g, rep) in zip(cells_used, members, built):
        dg = export_planned_graph(
            g, lane=lane, node_capacity=node_cap, edge_capacity=E,
            quantize_int8=quantize_int8, planner_buckets=planner_buckets,
            packed_labels=bool(fits), device=device,
        )
        segments.append(Segment(cell=cc, ids=ids, dg=dg, report=rep))

    return SegmentedIndex(
        rel, grid, space, segments, vectors, node_capacity=node_cap,
        edge_capacity=E, quantized=quantize_int8, packed=fits, device=device,
    )


def segmented_index_from_numpy(arrays: dict, segments: Sequence[dict], *,
                               device=None) -> SegmentedIndex:
    """A ``SegmentedIndex`` over another build's arrays, taken unchanged
    (e.g. the JAX package's), so both packages search the same index.

    ``arrays`` holds the index's fields: ``relation`` (its name), the f32
    ``vectors``, ``node_capacity``, ``edge_capacity``, the ``quantized``
    and ``packed`` flags, the grid's ``edges_x``/``edges_y``/``vals_x``/
    ``vals_y`` and the ``DominanceSpace``'s ``X``, ``Y``, ``U_X``, ``U_Y``. ``segments`` holds one dict per segment: ``cell``,
    ``ids`` and its export's fields with its planner state (what
    ``repro_torch.exec.planned_graph_from_numpy`` takes). Every export is
    staged on ``device`` (``None`` = the card)."""
    grid = SegmentGrid(
        edges_x=np.asarray(arrays["edges_x"], np.int64),
        edges_y=np.asarray(arrays["edges_y"], np.int64),
        vals_x=np.asarray(arrays["vals_x"], np.float64),
        vals_y=np.asarray(arrays["vals_y"], np.float64),
    )
    space = DominanceSpace(**{f: np.array(arrays[f], dtype=np.float64)
                              for f in ("X", "Y", "U_X", "U_Y")})
    segs = [Segment(cell=int(sd["cell"]), ids=np.array(sd["ids"], dtype=np.int64),
                    dg=planned_graph_from_numpy(sd, device=device), report=None)
            for sd in segments]
    return SegmentedIndex(
        get_relation(str(arrays["relation"])), grid, space, segs, arrays["vectors"],
        node_capacity=int(arrays["node_capacity"]),
        edge_capacity=int(arrays["edge_capacity"]),
        quantized=bool(arrays["quantized"]), packed=bool(arrays["packed"]),
        device=device,
    )
