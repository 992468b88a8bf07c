"""Query execution: selectivity estimation, planning, dispatch.

The planner picks a strategy per query (graph beam search, widened beam, or
an exact brute scan of the enumerated valid subset) from an O(1) bounded
count over dominance rank space; ``execute_batch`` runs mixed-plan batches.
"""
from repro_torch.exec.bruteforce import brute_force_topk, brute_topk_impl, effective_norms
from repro_torch.exec.estimator import SelectivityEstimator, count_bounds_device
from repro_torch.exec.plan import (
    PLAN_NAMES,
    PlanBatch,
    PlannerConfig,
    QueryPlan,
    default_planner_config,
    plan_queries,
)
from repro_torch.exec.executor import (
    execute_batch,
    export_planned_graph,
    mask_entry_points,
    planned_exec_core,
    planned_graph_from_numpy,
    worklist_exec_core,
)

__all__ = [
    "PLAN_NAMES",
    "PlanBatch",
    "PlannerConfig",
    "QueryPlan",
    "SelectivityEstimator",
    "brute_force_topk",
    "brute_topk_impl",
    "count_bounds_device",
    "default_planner_config",
    "effective_norms",
    "execute_batch",
    "export_planned_graph",
    "mask_entry_points",
    "plan_queries",
    "planned_graph_from_numpy",
    "planned_exec_core",
    "worklist_exec_core",
]
