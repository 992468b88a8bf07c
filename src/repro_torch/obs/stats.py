"""Device-side traversal counters of the batched searches.

``SearchStats`` is an optional extra output of ``search_core``,
``planned_exec_core`` and the streaming searches, computed inside the loop
from values the loop already holds (the live mask, the scorer's candidate
distances, the merge's keep mask, the visited bitmap). The loop writes each
iteration's four per-row counts into one ``[max_iters, 4, B]`` tally on the
search's device (``accumulate_iteration``: four reductions, no host sync),
and ``finalize_stats`` folds the tally into the counters once. With
``stats=False`` (the default everywhere) none of this code runs.

Counting semantics, as the JAX package's ``obs/stats.py`` defines them:

  * ``iters[b]``        iterations in which query ``b`` expanded at least
                        one beam entry;
  * ``expanded[b]``     beam entries popped and expanded;
  * ``cand_total[b]``   neighbor slots examined (ids >= 0);
  * ``cand_valid[b]``   candidates passing the label and visited tests
                        (finite scorer distance);
  * ``kept[b]``         valid candidates surviving the intra-iteration
                        dedup (the merge's ``keep``);
  * ``visited[b]``      visited-set population at termination;
  * ``beam_occupancy[b]``  finite beam entries at termination;
  * ``hit_max_iters[b]``   the iteration cap cut the query off while it
                        still had unexpanded finite entries;
  * ``delta_valid[b]``  streaming only: delta-tier candidates passing the
                        filter;
  * ``hop_valid/hop_total[h]``  batch-summed valid / examined candidates
                        at iteration ``h``.

The port's loop runs iterations in blocks between two host tests of "any
row active" (``search/batched.py``), so it may run a few iterations after
every row has finished. In such an iteration, and in any iteration after a
row finished, the row's live mask is empty: it adds zero to every counter,
as the reference's loop, which stops at once, never runs it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import (
    COUNT_BUCKETS,
    FRACTION_BUCKETS,
    MetricsRegistry,
    resolve,
)


class SearchStats(NamedTuple):
    """Per-query traversal counters (+ batch-summed per-hop tallies): a
    NamedTuple of tensors (or, after :func:`stats_to_host`, numpy arrays)."""

    iters: torch.Tensor           # [B] int32
    expanded: torch.Tensor        # [B] int32
    cand_total: torch.Tensor      # [B] int32
    cand_valid: torch.Tensor      # [B] int32
    kept: torch.Tensor            # [B] int32
    visited: torch.Tensor         # [B] int32
    beam_occupancy: torch.Tensor  # [B] int32
    hit_max_iters: torch.Tensor   # [B] bool
    delta_valid: torch.Tensor     # [B] int32
    hop_valid: torch.Tensor       # [H] int32 (H = max_iters)
    hop_total: torch.Tensor       # [H] int32


# [B]-shaped fields (everything except the hop tallies)
PER_QUERY_FIELDS = (
    "iters", "expanded", "cand_total", "cand_valid", "kept", "visited",
    "beam_occupancy", "hit_max_iters", "delta_valid",
)


def init_search_stats(B: int, max_iters: int, device=None) -> SearchStats:
    """All-zero counters for a batch of ``B`` and an ``[max_iters]`` hop
    axis on ``device`` (the search's: the caller passes it)."""

    def zi(m):
        return torch.zeros(m, dtype=torch.int32, device=device)

    return SearchStats(
        iters=zi(B), expanded=zi(B), cand_total=zi(B), cand_valid=zi(B),
        kept=zi(B), visited=zi(B), beam_occupancy=zi(B),
        hit_max_iters=torch.zeros(B, dtype=torch.bool, device=device),
        delta_valid=zi(B), hop_valid=zi(max_iters), hop_total=zi(max_iters),
    )


def init_tally(B: int, max_iters: int, device=None) -> torch.Tensor:
    """The loop's zero tally ``[max_iters, 4, B]`` int32: each row's
    expanded entries, examined, valid and kept candidates at each
    iteration."""
    return torch.zeros((max_iters, 4, B), dtype=torch.int32, device=device)


def accumulate_iteration(
    tally: torch.Tensor,   # [max_iters, 4, B] int32 (``init_tally``)
    *,
    live: torch.Tensor,    # [B, M] bool: beam entries actually expanded
    nb: torch.Tensor,      # [B, M*E] int32 candidate ids (-1 = padding)
    d_new: torch.Tensor,   # [B, M*E] f32 scorer distances (inf = filtered)
    keep: torch.Tensor,    # [B, M*E] bool dedup survivors
    it: int,               # this iteration's index (< max_iters)
) -> torch.Tensor:
    """Write one loop iteration's per-row counts into ``tally[it]``, on the
    device; returns the tally."""
    row = tally[it]
    torch.sum(live, dim=1, dtype=torch.int32, out=row[0])
    torch.sum(nb >= 0, dim=1, dtype=torch.int32, out=row[1])
    torch.sum(torch.isfinite(d_new), dim=1, dtype=torch.int32, out=row[2])
    torch.sum(keep, dim=1, dtype=torch.int32, out=row[3])
    return tally


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (the SWAR count on the words'
    unsigned 32-bit value: torch has no popcount)."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def finalize_stats(
    tally: torch.Tensor,     # [max_iters, 4, B] int32 (``accumulate_iteration``)
    *,
    beam_d: torch.Tensor,    # [B, L] f32 final beam distances
    beam_exp: torch.Tensor,  # [B, L] bool final expansion flags
    visited: torch.Tensor,   # [B, W] int32 bitmap or [B, n] uint8 dense
) -> SearchStats:
    """The counters: the tally summed over iterations (per row) and over
    rows (per hop), and the termination-time fields (visited population,
    occupancy, stop cause)."""
    finite = torch.isfinite(beam_d)
    if visited.dtype == torch.int32:
        pop = popcount32(visited).sum(dim=1).to(torch.int32)
    else:
        pop = visited.sum(dim=1, dtype=torch.int32)
    per_row = tally.sum(dim=0, dtype=torch.int32)          # [4, B]
    per_hop = tally.sum(dim=2, dtype=torch.int32)          # [max_iters, 4]
    B = beam_d.shape[0]
    return SearchStats(
        iters=(tally[:, 0] > 0).sum(dim=0, dtype=torch.int32),
        expanded=per_row[0], cand_total=per_row[1], cand_valid=per_row[2],
        kept=per_row[3], visited=pop,
        beam_occupancy=finite.sum(dim=1, dtype=torch.int32),
        hit_max_iters=torch.any(~beam_exp & finite, dim=1),
        delta_valid=torch.zeros(B, dtype=torch.int32, device=beam_d.device),
        hop_valid=per_hop[:, 2].contiguous(), hop_total=per_hop[:, 1].contiguous(),
    )


def combine_stats(a: SearchStats, b: SearchStats) -> SearchStats:
    """Elementwise merge of two searches over DISJOINT row sets (the
    planner's graph and wide searches: a row masked out of one search adds
    exact zeros there, so addition is selection). Hop tallies are
    zero-padded to the longer iteration axis."""
    H = max(a.hop_valid.shape[0], b.hop_valid.shape[0])

    def pad(x):
        return torch.nn.functional.pad(x, (0, H - x.shape[0]))

    return SearchStats(
        iters=a.iters + b.iters,
        expanded=a.expanded + b.expanded,
        cand_total=a.cand_total + b.cand_total,
        cand_valid=a.cand_valid + b.cand_valid,
        kept=a.kept + b.kept,
        visited=a.visited + b.visited,
        beam_occupancy=a.beam_occupancy + b.beam_occupancy,
        hit_max_iters=a.hit_max_iters | b.hit_max_iters,
        delta_valid=a.delta_valid + b.delta_valid,
        hop_valid=pad(a.hop_valid) + pad(b.hop_valid),
        hop_total=pad(a.hop_total) + pad(b.hop_total),
    )


def stats_to_host(st: SearchStats) -> SearchStats:
    """Every counter as a numpy array (one copy to the host each)."""
    return SearchStats(*(
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in st))


def per_query_dict(st: SearchStats) -> dict:
    """The [B]-shaped fields as {name: int32 tensor}."""
    return {name: getattr(st, name).to(torch.int32) for name in PER_QUERY_FIELDS}


def record_search_stats(
    st,
    *,
    registry: Optional[MetricsRegistry] = None,
    n_real: Optional[int] = None,
) -> None:
    """Fold one batch's counters into the host metrics registry.

    ``st`` is a ``SearchStats`` (host or device) or a ``per_query_dict``.
    ``n_real`` truncates to the first rows when the batch carries sentinel
    padding, so no-op rows don't dilute the per-query histograms."""
    reg = resolve(registry)
    get = (st.get if isinstance(st, dict) else
           lambda name, default=None: getattr(st, name, default))

    def col(name):
        v = get(name)
        if v is None:
            return None
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return v[:n_real] if n_real is not None else v

    iters = col("iters")
    if iters is None or iters.size == 0:
        return
    expanded = col("expanded")
    cand_total = col("cand_total")
    cand_valid = col("cand_valid")
    reg.counter(
        "repro_search_queries_total", "queries with device counters recorded"
    ).inc(int(iters.size))
    for name, v in (
        ("repro_search_iterations_total", iters),
        ("repro_search_nodes_expanded_total", expanded),
        ("repro_search_candidates_examined_total", cand_total),
        ("repro_search_candidates_valid_total", cand_valid),
        ("repro_search_candidates_kept_total", col("kept")),
        ("repro_search_delta_candidates_valid_total", col("delta_valid")),
    ):
        if v is not None:
            reg.counter(name, "batched device traversal counter").inc(
                float(np.sum(v, dtype=np.int64))
            )
    for name, v in (
        ("repro_search_expanded_per_query", expanded),
        ("repro_search_visited_per_query", col("visited")),
        ("repro_search_beam_occupancy", col("beam_occupancy")),
    ):
        if v is not None:
            h = reg.histogram(name, "per-query traversal distribution",
                              buckets=COUNT_BUCKETS)
            h.observe_many(float(x) for x in v)
    if cand_total is not None and cand_valid is not None:
        frac = reg.histogram(
            "repro_search_valid_fraction",
            "valid candidates / examined candidates per query",
            buckets=FRACTION_BUCKETS,
        )
        mask = cand_total > 0
        frac.observe_many(
            (cand_valid[mask] / cand_total[mask]).astype(float)
        )
    hit = col("hit_max_iters")
    if hit is not None:
        term = reg.counter(
            "repro_search_terminations_total", "per-query stop cause"
        )
        hit = hit.astype(bool)
        started = iters > 0
        n_cap = int(np.count_nonzero(hit))
        n_conv = int(np.count_nonzero(~hit & started))
        n_empty = int(np.count_nonzero(~hit & ~started))
        if n_cap:
            term.inc(n_cap, cause="iteration_cap")
        if n_conv:
            term.inc(n_conv, cause="beam_converged")
        if n_empty:
            term.inc(n_empty, cause="no_entry")
