"""Selectivity-aware batched executor: three strategies, one batch.

``execute_batch`` canonicalizes the batch, asks the planner for a per-query
strategy, and runs the whole batch through all three paths, as the
reference does (``executor.py:117-144``):

  * the ``GRAPH`` beam search, with entry points masked to -1 on every row
    planned elsewhere (a masked row's beam starts empty: zero work);
  * ``GRAPH_WIDE``, a second instantiation of the same search with the
    widened (beam, expand), masked the same way;
  * ``BRUTE_VALID``, a scan of the host-enumerated valid-id lists
    (``[B, brute_max_valid]`` int32, -1 padded — rows planned elsewhere are
    all padding);

then selects each row's result by its plan. ``plan="graph"`` bypasses the
planner; ``"wide"`` / ``"brute"`` force one strategy. Both graph strategies
run the search core's branch for the label layout and ``fused``
(``search.batched.search_core``); the brute strategy always scans with the
gather scorer over the cached norms.

The planner's estimator is built here, not in the search layer:
``export_planned_graph`` and ``planned_graph_from_numpy`` are the search
layer's exports with the estimator attached.

``stats=True`` merges the two graph searches' ``SearchStats`` by
``combine_stats``: each sees the rows planned elsewhere as masked (ep = -1,
zero work, exact-zero counters), and BRUTE_VALID rows stay all-zero.

``worklist_exec_core`` is the segmented tier's one dispatch: the planned
executor over a worklist of (query, segment) pairs on a flat
``SegmentStack``, folded per query by one ``ops.topk_merge``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.exec.bruteforce import brute_topk_impl, effective_norms
from repro_torch.exec.estimator import SelectivityEstimator
from repro_torch.exec.plan import (
    PlannerConfig,
    QueryPlan,
    default_planner_config,
    plan_queries,
)
from repro_torch.kernels import ops
from repro_torch.obs.stats import SearchStats, combine_stats, stats_to_host
from repro_torch.obs.trace import trace_span
from repro_torch.search.batched import LOOP_BLOCK, prepare_states_extended, search_core
from repro_torch.search.device_graph import device_graph_from_numpy, export_device_graph

PLANS = ("auto", "graph", "wide", "brute")


def export_planned_graph(g, et=None, *, planner_buckets: int = 64, **kwargs):
    """``search.export_device_graph`` of ``g`` with the planner's
    selectivity estimator (``planner_buckets``² histogram) attached."""
    planner = SelectivityEstimator.from_graph(g, buckets=planner_buckets)
    return export_device_graph(g, et, planner=planner, **kwargs)


def planned_graph_from_numpy(arrays: dict, *, device=None):
    """``search.device_graph_from_numpy`` with the estimator rebuilt from the
    same arrays (``estimator.STATE_FIELDS``; without ``cum``, no planner)."""
    planner = None
    if arrays.get("cum") is not None:
        planner = SelectivityEstimator.from_state(arrays)
    return device_graph_from_numpy(arrays, planner=planner, device=device)


def planned_exec_core(
    table: torch.Tensor,     # [n, D] f32 (or int8 with scales)
    nbr: torch.Tensor,       # [n, E] int32
    labels: torch.Tensor,    # [n, E, 2] packed words or [n, E, 4] int32
    q: torch.Tensor,         # [B, D] f32
    states: torch.Tensor,    # [B, 2] int32
    ep_graph: torch.Tensor,  # [B] int32 entry ids, -1 unless plan==GRAPH
    ep_wide: torch.Tensor,   # [B] int32 entry ids, -1 unless plan==GRAPH_WIDE
    bf_ids: torch.Tensor,    # [B, V] int32 valid ids, -1 unless plan==BRUTE
    plans: torch.Tensor,     # [B] int32 QueryPlan values
    *,
    k: int,
    beam: int,
    wide_beam: int,
    max_iters: int,
    wide_max_iters: int,
    expand: int = 1,
    wide_expand: int = 1,
    norms: torch.Tensor,
    scales: torch.Tensor | None = None,
    fused: bool = True,
    block: int = LOOP_BLOCK,
    stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """All three strategies over the batch + per-row plan select; with
    ``stats`` the merged ``SearchStats`` last."""
    out_g = search_core(
        table, nbr, labels, q, states, ep_graph, k=k, beam=beam,
        max_iters=max_iters, expand=expand, norms=norms, scales=scales,
        fused=fused, block=block, stats=stats,
    )
    out_w = search_core(
        table, nbr, labels, q, states, ep_wide, k=k, beam=wide_beam,
        max_iters=wide_max_iters, expand=wide_expand, norms=norms,
        scales=scales, fused=fused, block=block, stats=stats,
    )
    (ids_g, d_g), (ids_w, d_w) = out_g[:2], out_w[:2]
    with trace_span("exec.select"):
        nrm = effective_norms(table, scales, norms)
        ids_b, d_b = brute_topk_impl(table, nrm, q, bf_ids, k=k, scales=scales)
        sel = plans[:, None]
        graph, wide = sel == int(QueryPlan.GRAPH), sel == int(QueryPlan.GRAPH_WIDE)
        ids = torch.where(graph, ids_g, torch.where(wide, ids_w, ids_b))
        d = torch.where(graph, d_g, torch.where(wide, d_w, d_b))
    if stats:
        return ids, d, combine_stats(out_g[2], out_w[2])
    return ids, d


def worklist_exec_core(
    table: torch.Tensor,      # [S·node_cap, D] flat stacked storage
    nbr: torch.Tensor,        # [S·node_cap, E] int32, PRE-OFFSET by segment
                              # base (``SegmentStack``): traversal stays
                              # inside each row's segment
    labels: torch.Tensor,     # [S·node_cap, E, 2|4] segment-local rectangles
    gid_table: torch.Tensor,  # [S·node_cap] int32 flat node -> global object
                              # id (-1 on capacity padding rows)
    q: torch.Tensor,          # [B, D] f32, the original query batch
    qid: torch.Tensor,        # [W] int32 query row per work item (== B marks
                              # bucket padding, dropped by the scatter)
    seg_ids: torch.Tensor,    # [W] int32 segment per work item (0 on padding)
    states: torch.Tensor,     # [W, 2] int32 segment-local canonical states
    ep_graph: torch.Tensor,   # [W] int32 segment-LOCAL entry ids (-1 masked)
    ep_wide: torch.Tensor,    # [W] int32
    bf_ids: torch.Tensor,     # [W, V] int32 segment-local brute ids (-1 pad)
    plans: torch.Tensor,      # [W] int32 QueryPlan values
    *,
    k: int,
    beam: int,
    wide_beam: int,
    max_iters: int,
    wide_max_iters: int,
    expand: int = 1,
    wide_expand: int = 1,
    norms: torch.Tensor,
    scales: torch.Tensor | None = None,
    fused: bool = True,
    block: int = LOOP_BLOCK,
    stats: bool = False,
    node_cap: int,
    n_sentinel: int,
) -> Tuple[torch.Tensor, ...]:
    """One dispatch for a whole routed-segment worklist — ``(ids [B, k]
    int32 global, d [B, k])``, with ``stats`` a ``[B]`` ``SearchStats`` last.

    Each work item is one (query, segment) pair: its entry points and brute
    ids are offset to the flat row space, the planned executor runs over the
    ``[W]`` worklist, results map through ``gid_table`` and scatter into
    ``[B, S, k]`` (unrouted slots +inf / -1), and ONE ``ops.topk_merge`` over
    the segment-major ``[B, S·k]`` block folds them. That equals the
    per-segment sequential fold because global ids are unique across
    segments and the merge breaks ties by arrival order. Padding items
    (``qid == B``) scatter into a spare row that is dropped.

    With ``stats`` each worklist row's counters add into its query row (a
    query's per-segment searches are independent, so the sum equals the
    loop's ``combine_stats``); ``hit_max_iters`` is "any segment hit the
    cap", the hop tallies stay batch-summed."""
    B = q.shape[0]
    n_flat = table.shape[0]
    S = n_flat // node_cap
    base = seg_ids.to(torch.int32) * node_cap
    ep_g = torch.where(ep_graph >= 0, ep_graph + base, -1).to(torch.int32)
    ep_w = torch.where(ep_wide >= 0, ep_wide + base, -1).to(torch.int32)
    bf = torch.where(bf_ids >= 0, bf_ids + base[:, None], -1).to(torch.int32)
    q_w = q[qid.clamp(0, B - 1).long()]
    out = planned_exec_core(
        table, nbr, labels, q_w, states, ep_g, ep_w, bf, plans,
        k=k, beam=beam, wide_beam=wide_beam, max_iters=max_iters,
        wide_max_iters=wide_max_iters, expand=expand, wide_expand=wide_expand,
        norms=norms, scales=scales, fused=fused, block=block, stats=stats,
    )
    ids_f, d_w = out[0], out[1]
    glob = torch.where(ids_f >= 0, gid_table[ids_f.clamp(0, n_flat - 1).long()],
                       -1).to(torch.int32)
    row, seg = qid.long(), seg_ids.long()
    sc_d = torch.full((B + 1, S, k), float("inf"), dtype=torch.float32, device=q.device)
    sc_i = torch.full((B + 1, S, k), -1, dtype=torch.int32, device=q.device)
    sc_d[row, seg] = d_w
    sc_i[row, seg] = glob
    acc_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=q.device)
    acc_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    ids, d = ops.topk_merge(acc_d, acc_i, sc_d[:B].reshape(B, S * k),
                            sc_i[:B].reshape(B, S * k), n=n_sentinel)
    if not stats:
        return ids, d
    st = out[2]

    def scat(v):
        acc = torch.zeros(B + 1, dtype=torch.int32, device=q.device)
        return acc.index_add_(0, row, v.to(torch.int32))[:B]

    return ids, d, SearchStats(
        iters=scat(st.iters), expanded=scat(st.expanded),
        cand_total=scat(st.cand_total), cand_valid=scat(st.cand_valid),
        kept=scat(st.kept), visited=scat(st.visited),
        beam_occupancy=scat(st.beam_occupancy),
        hit_max_iters=scat(st.hit_max_iters) > 0,
        delta_valid=scat(st.delta_valid),
        hop_valid=st.hop_valid, hop_total=st.hop_total,
    )


def mask_entry_points(
    ep: np.ndarray, plans: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Split one entry-point vector into per-strategy padded copies."""
    ep = np.asarray(ep, dtype=np.int32)
    ep_graph = np.where(plans == int(QueryPlan.GRAPH), ep, -1).astype(np.int32)
    ep_wide = np.where(
        plans == int(QueryPlan.GRAPH_WIDE), ep, -1
    ).astype(np.int32)
    return ep_graph, ep_wide


def execute_batch(
    dg,
    q: np.ndarray,
    s_q: np.ndarray,
    t_q: np.ndarray,
    *,
    k: int = 10,
    beam: int = 64,
    max_iters: Optional[int] = None,
    expand: int = 1,
    fused: bool = True,
    plan: str = "auto",
    config: Optional[PlannerConfig] = None,
    return_plans: bool = False,
    packed: bool | None = None,
    stats: bool = False,
    row_mask: Optional[np.ndarray] = None,
    device=None,
    block: int = LOOP_BLOCK,
):
    """Planned end-to-end batched query over a ``DeviceGraph`` on ``device``
    (``None`` = the card).

    ``plan`` is ``"auto"`` (selectivity-aware, the default), ``"graph"``
    (the single-strategy parity oracle), ``"wide"`` or ``"brute"`` (forced
    strategies). ``fused=False`` runs both graph strategies on the unfused
    branch (dense candidate pre-gather, the wide one with expand 1, as the
    reference). ``row_mask`` (``[B]`` bool) drops rows by padding: a
    ``False`` row is treated as invalid and returns ``ids=-1 / d=+inf`` at
    no traversal cost. Returns numpy ``(ids [B, k], dists [B, k])``, plus the
    ``PlanBatch`` when ``return_plans`` is set (``None`` for the non-auto
    modes), plus a host ``SearchStats`` when ``stats`` is set (always last).
    ``packed`` picks the graph strategies' label layout as in
    ``batched_udg_search`` (``DeviceGraph.serving_labels``)."""
    if plan not in PLANS:
        raise ValueError(f"plan={plan!r} not in {PLANS}")
    with trace_span("exec.batch"):
        dev = resolve_device(device)
        config = config or default_planner_config()
        states, ep, invalid = prepare_states_extended(dg, s_q, t_q)
        B = states.shape[0]
        if row_mask is not None:
            row_mask = np.asarray(row_mask, dtype=bool).reshape(-1)
            if row_mask.shape[0] != B:
                raise ValueError(
                    f"row_mask has {row_mask.shape[0]} rows, batch has {B}"
                )
            invalid = invalid | ~row_mask
            ep = np.where(row_mask, ep, -1).astype(np.int32)
        if plan in ("auto", "brute") and dg.planner is None:
            raise ValueError(
                f"plan={plan!r} requires a DeviceGraph planner "
                "(export with repro_torch.exec.export_planned_graph)")
        if plan == "auto":
            pb = plan_queries(dg.planner, states, invalid, config=config)
            plans, bf_ids = pb.plans, pb.bf_ids
        else:
            pb = None
            with trace_span("exec.plan"):
                plans, bf_ids = _forced_plan(dg, plan, states, invalid, config)
        ep_graph, ep_wide = mask_entry_points(ep, plans)
        wide_beam = max(beam * config.wide_beam_scale, beam)
        wide_expand = config.wide_expand if fused else 1
        mi = max_iters if max_iters is not None else 2 * beam
        with trace_span("exec.stage"):
            labels = dg.serving_labels(fused=fused, packed=packed, device=dev)
            di = dg.device(dev)
            host = (np.asarray(q, dtype=np.float32), states, ep_graph, ep_wide, bf_ids, plans)
            staged = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in host]
        out = planned_exec_core(
            di.table, di.nbr, labels, *staged,
            k=k, beam=beam, wide_beam=wide_beam,
            max_iters=mi, wide_max_iters=mi * config.wide_beam_scale,
            expand=expand, wide_expand=min(wide_expand, wide_beam),
            norms=di.norms, scales=di.scales, fused=fused, block=block,
            stats=stats,
        )
        with trace_span("exec.fetch"):
            ret = (out[0].cpu().numpy(), out[1].cpu().numpy())
        if return_plans:
            ret += (pb,)
        if stats:
            ret += (stats_to_host(out[2]),)
        return ret


def _forced_plan(dg, plan, states, invalid, config):
    """(plans, bf_ids) of a forced strategy: ``"graph"`` / ``"wide"`` for
    every row, or ``"brute"`` with exact valid sets of ANY size, the
    capacity rounded up to a power of two."""
    B = states.shape[0]
    if plan in ("graph", "wide"):
        forced = QueryPlan.GRAPH if plan == "graph" else QueryPlan.GRAPH_WIDE
        plans = np.full(B, int(forced), dtype=np.int32)
        return plans, np.full((B, config.brute_max_valid), -1, dtype=np.int32)
    plans = np.full(B, int(QueryPlan.BRUTE_VALID), dtype=np.int32)
    lists = [
        np.empty(0, np.int32) if invalid[i]
        else dg.planner.exact_valid_ids(int(states[i, 0]), int(states[i, 1]))
        for i in range(B)
    ]
    cap = max(int(max((l.shape[0] for l in lists), default=1)), 1)
    cap = 1 << (cap - 1).bit_length()
    bf_ids = np.full((B, cap), -1, dtype=np.int32)
    for i, l in enumerate(lists):
        bf_ids[i, : l.shape[0]] = l
    return plans, bf_ids
