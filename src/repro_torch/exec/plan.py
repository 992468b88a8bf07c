"""Query plans: per-query execution-strategy selection from selectivity.

Graph search degrades under restrictive filters (few valid objects: entry
lookup misses, patch edges get sparse) while near-unfiltered queries waste
label tests; the fix — as in selectivity-aware hybrid systems (UNIFY,
ACORN) — is to pick the strategy per query from the *estimated* valid-set
size:

  ``BRUTE_VALID``  sparse filters: enumerate the exact valid set (the
                   estimator's small-count fallback) and scan just those
                   rows through the gather-fused kernel — exact by
                   construction, O(|V| * d) per query;
  ``GRAPH``        the common band: the paper's beam search as-is;
  ``GRAPH_WIDE``   the awkward middle: same search with a raised beam and
                   multi-expand, buying recall where the graph is navigable
                   but the valid region is thin.

Planning is conservative: thresholds compare against the histogram's *upper*
bound, so a query is only sent to ``BRUTE_VALID`` when its valid set
provably fits the brute path's static id capacity. Default thresholds live
in ``repro_torch.configs.udg_serve.UdgServeConfig`` (``planner_config()``).

A host numpy copy of the JAX package's planner, its metrics recording
(route counts, bound width and slack histograms) included.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from repro_torch.exec.estimator import SelectivityEstimator
from repro_torch.obs.metrics import COUNT_BUCKETS, get_registry
from repro_torch.obs.trace import trace_span


class QueryPlan(enum.IntEnum):
    """Execution strategy for one query (values are stable wire/device ids)."""

    BRUTE_VALID = 0
    GRAPH = 1
    GRAPH_WIDE = 2


PLAN_NAMES = {int(p): p.name for p in QueryPlan}


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Planner thresholds + static shapes of the planned execution step.

    ``brute_max_valid`` doubles as the padded id capacity of the brute path,
    so the dispatch shape never depends on data: a query is planned
    ``BRUTE_VALID`` only when the estimator's *upper* bound fits.
    ``wide_max_fraction`` is the upper-bound valid fraction below which a
    graph-navigable query still gets the widened beam. Serving surfaces
    resolve their defaults through :func:`default_planner_config` (the
    deployment's ``repro_torch.configs.udg_serve`` values); the field defaults
    below MUST stay numerically in sync with the ``planner_*`` fields
    there, so a directly-constructed ``PlannerConfig()`` (tests,
    calibration probes) measures the same thresholds serving runs with.
    """

    buckets: int = 64               # histogram resolution per rank axis
    brute_max_valid: int = 256      # hi <= this  -> BRUTE_VALID (and id cap)
    wide_max_fraction: float = 0.05  # hi <= frac*n -> GRAPH_WIDE
    wide_beam_scale: int = 2        # GRAPH_WIDE beam = beam * scale
    wide_expand: int = 2            # GRAPH_WIDE multi-expand (fused path)


def default_planner_config() -> PlannerConfig:
    """The serving deployment's thresholds — every serving surface that is
    not handed an explicit ``PlannerConfig`` resolves to this, so tuning
    ``repro_torch.configs.udg_serve.UdgServeConfig.planner_*`` actually
    changes dispatch."""
    from repro_torch.configs.udg_serve import CONFIG

    return CONFIG.planner_config()


@dataclasses.dataclass
class PlanBatch:
    """Host-side planning result for one fixed-shape query batch."""

    plans: np.ndarray      # [B] int32 QueryPlan values
    bf_ids: np.ndarray     # [B, brute_max_valid] int32 valid ids (-1 padded)
    count_lo: np.ndarray   # [B] histogram lower bounds
    count_hi: np.ndarray   # [B] histogram upper bounds

    def mix(self) -> dict:
        """{plan name: row count} — for logs/benchmarks."""
        return {
            PLAN_NAMES[int(p)]: int(np.count_nonzero(self.plans == int(p)))
            for p in QueryPlan
        }


def plan_queries(
    est: Optional[SelectivityEstimator],
    states: np.ndarray,          # [B, 2] int32 canonical rank states
    invalid: np.ndarray,         # [B] bool — canonicalization found no state
    *,
    config: PlannerConfig,
) -> PlanBatch:
    """Assign one ``QueryPlan`` per query and enumerate brute-path ids.

    Invalid rows (``canonicalize`` returned None — empty valid set) become
    ``BRUTE_VALID`` with an empty id list, which the executor turns into an
    empty top-K; they never touch the graph. With no estimator (e.g. an
    epoch-0 streaming tier with no compacted graph) every valid row falls
    back to ``GRAPH`` — today's behavior.
    """
    with trace_span("exec.plan"):
        return _plan(est, np.asarray(states), np.asarray(invalid, dtype=bool), config)


def _plan(est, states, invalid, config) -> PlanBatch:
    B = states.shape[0]
    plans = np.full(B, int(QueryPlan.GRAPH), dtype=np.int32)
    bf_ids = np.full((B, config.brute_max_valid), -1, dtype=np.int32)
    if est is None:
        plans[invalid] = int(QueryPlan.BRUTE_VALID)
        zeros = np.zeros(B, dtype=np.int64)
        return _record_plan_batch(PlanBatch(plans, bf_ids, zeros, zeros))
    a = states[:, 0].astype(np.int64)
    c = states[:, 1].astype(np.int64)
    lo, hi = est.count_bounds(a, c)
    lo = np.where(invalid, 0, lo)
    hi = np.where(invalid, 0, hi)
    wide_cut = max(
        config.brute_max_valid, config.wide_max_fraction * max(est.n, 1)
    )
    plans[hi <= wide_cut] = int(QueryPlan.GRAPH_WIDE)
    plans[hi <= config.brute_max_valid] = int(QueryPlan.BRUTE_VALID)
    plans[invalid] = int(QueryPlan.BRUTE_VALID)
    for i in np.flatnonzero(
        (plans == int(QueryPlan.BRUTE_VALID)) & ~invalid
    ):
        ids = est.exact_valid_ids(int(a[i]), int(c[i]))
        bf_ids[i, : ids.shape[0]] = ids  # |ids| <= hi <= brute_max_valid
    return _record_plan_batch(PlanBatch(plans, bf_ids, lo, hi))


def _record_plan_batch(pb: PlanBatch) -> PlanBatch:
    """Fold one planning result into the metrics registry: per-strategy
    route counts, count-bound width, and — on the brute rows, where the
    exact valid count is known — the observed slack of each bound."""
    with trace_span("exec.plan.record"):
        reg = get_registry()
        routes = reg.counter(
            "repro_planner_routes_total", "queries routed per execution strategy"
        )
        for name, cnt in pb.mix().items():
            if cnt:
                routes.inc(cnt, plan=name)
        width = reg.histogram(
            "repro_planner_bound_width",
            "estimator count-bound width (hi - lo) per query",
            buckets=COUNT_BUCKETS,
        )
        width.observe_many(pb.count_hi - pb.count_lo)
        brute = pb.plans == int(QueryPlan.BRUTE_VALID)
        if np.any(brute):
            actual = np.count_nonzero(pb.bf_ids[brute] >= 0, axis=1)
            slack = reg.histogram(
                "repro_planner_bound_slack",
                "bound minus exact valid count on brute-planned rows",
                buckets=COUNT_BUCKETS,
            )
            slack.observe_many(pb.count_hi[brute] - actual, bound="hi")
            slack.observe_many(actual - pb.count_lo[brute], bound="lo")
    return pb
