"""Two-tier streaming search: the graph tier, the delta scan, one merge.

One call searches both tiers of a ``StreamingIndex`` epoch and merges:

  graph tier   the lockstep beam search over the compacted UDG
               (``search_core`` asked for the full beam, or the planned
               executor), then tombstone-masked: deleted nodes still route
               the beam (soft delete) but never surface in results;
  delta tier   a masked brute-force scan of the fixed-capacity delta
               segment through the gather scorer (``ops.filter_dist_gather``,
               B3; ``fused=False``: the dense scorer ``ops.filter_dist``, B4,
               over the ``[B, C, d]`` broadcast of the segment), with slot
               ids as the gather indices and the label rectangles in
               monotone float-key space;
  merge        one stable ascending sort over ``[graph beam | delta]`` on
               ``d + 0.0`` (-0.0 ties +0.0, and the graph tier wins ties),
               keeping the best k, reporting external ids.

Every tensor has a capacity-fixed shape, so an epoch swap changes no shape.

The scorers take contiguous ``[B, C]`` ids and ``[B, C, 4]`` rectangles, so
the delta segment's ids and rectangles, the same for every query, are
materialized per batch (``expand(...).contiguous()``: 16 bytes a (query,
slot) pair for the rectangles). The delta's norms are summed in the
scorers' order (``ref.warp_dot``), as the export's cached norms are, so the
fused and unfused scans agree bit for bit; the reference sums them in f32
(``jnp.sum``), which may differ by an f32 ulp.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.exec.executor import planned_exec_core
from repro_torch.kernels import ops
from repro_torch.kernels.ref import warp_dot
from repro_torch.obs.stats import SearchStats
from repro_torch.search.batched import LOOP_BLOCK, search_core

INF = float("inf")


def delta_norms(dvec: torch.Tensor) -> torch.Tensor:
    """``‖v‖²`` of each delta row, summed as the export's cached norms are."""
    return warp_dot(dvec, dvec)


def two_tier_merge(
    ids_g: torch.Tensor,       # [B, L] graph-tier beam ids (node space)
    d_g: torch.Tensor,         # [B, L] graph-tier distances
    live: torch.Tensor,        # [N] bool
    ext_ids: torch.Tensor,     # [N] int32
    q: torch.Tensor,           # [B, d] f32
    dvec: torch.Tensor,        # [C, d] f32 delta tier
    dlab: torch.Tensor,        # [C, 4] int32
    dids: torch.Tensor,        # [C] int32
    dext: torch.Tensor,        # [C] int32
    dstate: torch.Tensor,      # [B, 2] int32
    *,
    k: int,
    fused: bool = True,
    dnorms: torch.Tensor | None = None,   # [C] f32 (``delta_norms``)
    st: SearchStats | None = None,        # graph-tier stats to annotate
) -> Tuple[torch.Tensor, ...]:
    """Tombstone-mask the graph beam, scan the delta tier, and merge to the
    best k external ids ``(ids [B, k] int32, d [B, k] f32)``. With a
    graph-tier ``st``, it is returned last with ``delta_valid`` set to each
    query's count of delta candidates passing the filter."""
    n = live.shape[0]
    B, d = q.shape
    C = dvec.shape[0]
    safe = ids_g.long().clamp(0, n - 1)
    ok = (ids_g >= 0) & live[safe]
    d_g = torch.where(ok, d_g, INF)
    eid_g = torch.where(ok, ext_ids[safe], -1)

    lab = dlab[None].expand(B, C, 4).contiguous()
    slot = dids[None].expand(B, C).contiguous()
    if fused:
        if dnorms is None:
            dnorms = delta_norms(dvec)
        dvis = torch.zeros((B, (C + 31) // 32), dtype=torch.int32, device=q.device)
        d_d = ops.filter_dist_gather(dvec, dnorms, q, slot, lab, dstate, dvis)
    else:
        cand = dvec[None].expand(B, C, d).contiguous()
        d_d = ops.filter_dist(q, cand, lab, dstate, slot)
    found = torch.isfinite(d_d)
    eid_d = torch.where(found, dext[None], -1)

    all_d = torch.cat([d_g, d_d], dim=1)
    all_e = torch.cat([eid_g, eid_d], dim=1)
    order = torch.sort(all_d + 0.0, dim=1, stable=True).indices[:, :k]
    out = (torch.gather(all_e, 1, order), torch.gather(all_d, 1, order))
    if st is not None:
        return out + (st._replace(delta_valid=found.sum(dim=1, dtype=torch.int32)),)
    return out


def streaming_search_core(
    table: torch.Tensor,       # [N, d] compacted tier (capacity-padded)
    nbr: torch.Tensor,         # [N, E] int32
    labels: torch.Tensor,      # [N, E, 2] packed words or [N, E, 4] int32
    live: torch.Tensor,        # [N] bool (False = tombstoned or padding)
    ext_ids: torch.Tensor,     # [N] int32 external id per node (-1 padding)
    dvec: torch.Tensor,        # [C, d] delta tier
    dlab: torch.Tensor,        # [C, 4] int32 key-space rectangles
    dids: torch.Tensor,        # [C] int32 slot ids (-1 = dead)
    dext: torch.Tensor,        # [C] int32 external ids (-1 = dead)
    q: torch.Tensor,           # [B, d]
    states: torch.Tensor,      # [B, 2] int32 canonical rank state (graph tier)
    ep: torch.Tensor,          # [B] int32 entry nodes (-1 = empty valid set)
    dstate: torch.Tensor,      # [B, 2] int32 float-key state (delta tier)
    *,
    k: int,
    beam: int,
    max_iters: int,
    fused: bool = True,
    norms: torch.Tensor,       # [N] f32 cached graph-tier norms
    dnorms: torch.Tensor | None = None,
    stats: bool = False,
    block: int = LOOP_BLOCK,
) -> Tuple[torch.Tensor, ...]:
    """The graph search (``plan="graph"``) and the delta scan, merged."""
    q = q.float()
    out = search_core(
        table, nbr, labels, q, states, ep, k=beam, beam=beam,
        max_iters=max_iters, norms=norms, fused=fused, block=block, stats=stats,
    )
    return two_tier_merge(
        out[0], out[1], live, ext_ids, q, dvec, dlab, dids, dext, dstate,
        k=k, fused=fused, dnorms=dnorms, st=out[2] if stats else None,
    )


def planned_streaming_search_core(
    table: torch.Tensor,       # [N, d] compacted tier (capacity-padded)
    nbr: torch.Tensor,         # [N, E] int32
    labels: torch.Tensor,      # [N, E, 2] packed words or [N, E, 4] int32
    live: torch.Tensor,        # [N] bool
    ext_ids: torch.Tensor,     # [N] int32
    dvec: torch.Tensor,        # [C, d] delta tier
    dlab: torch.Tensor,        # [C, 4] int32
    dids: torch.Tensor,        # [C] int32
    dext: torch.Tensor,        # [C] int32
    q: torch.Tensor,           # [B, d]
    states: torch.Tensor,      # [B, 2] int32 graph-tier rank state
    ep_graph: torch.Tensor,    # [B] int32 entry ids (-1 unless plan GRAPH)
    ep_wide: torch.Tensor,     # [B] int32 entry ids (-1 unless plan WIDE)
    bf_ids: torch.Tensor,      # [B, V] int32 brute valid ids (-1 padded)
    plans: torch.Tensor,       # [B] int32 QueryPlan values
    dstate: torch.Tensor,      # [B, 2] int32 delta-tier float-key state
    *,
    k: int,
    beam: int,
    wide_beam: int,
    max_iters: int,
    wide_max_iters: int,
    fused: bool = True,
    expand: int = 1,
    wide_expand: int = 1,
    norms: torch.Tensor,
    dnorms: torch.Tensor | None = None,
    stats: bool = False,
    block: int = LOOP_BLOCK,
) -> Tuple[torch.Tensor, ...]:
    """Planner-routed variant of :func:`streaming_search_core`: the graph
    tier runs through the planned executor (graph / wide / brute-valid),
    asked for ``beam`` candidates (not ``k``) so that tombstone masking has
    the same depth to draw on as the unplanned path; the delta scan and the
    merge are unchanged."""
    q = q.float()
    out = planned_exec_core(
        table, nbr, labels, q, states, ep_graph, ep_wide, bf_ids, plans,
        k=beam, beam=beam, wide_beam=wide_beam, max_iters=max_iters,
        wide_max_iters=wide_max_iters, fused=fused, expand=expand,
        wide_expand=wide_expand, norms=norms, block=block, stats=stats,
    )
    return two_tier_merge(
        out[0], out[1], live, ext_ids, q, dvec, dlab, dids, dext, dstate,
        k=k, fused=fused, dnorms=dnorms, st=out[2] if stats else None,
    )
