"""UDG core: the paper's primary contribution.

Public surface:
  - relations / dominance mapping: ``get_relation``, ``RELATIONS``,
    ``DominanceSpace`` (paper §II-A, §III, Table II, Lemma 1)
  - index: ``LabeledGraph`` (§IV-A), ``EntryTable``
  - construction: ``build_udg`` (practical, §V; sequential host loop or
    the wave constructor ``build_udg_batched`` / ``build_graphs_concurrent``,
    whose searches run on a torch device), ``build_udg_exact``
    (Algorithm 3 / Theorem 1), ``build_index``
  - search: ``udg_search`` (Algorithm 2), ``search_query``
"""
from repro_torch.core.build import (
    BATCHED_AUTO_MIN_N,
    BuildReport,
    build_dedicated_reference,
    build_index,
    build_udg,
    build_udg_exact,
)
from repro_torch.core.build_batched import build_graphs_concurrent, build_udg_batched
from repro_torch.core.entry import ConstructionEntry, EntryTable
from repro_torch.core.graph import GraphStats, LabeledGraph
from repro_torch.core.patch import PATCH_VARIANTS, add_patch_edges
from repro_torch.core.predicates import (
    RELATIONS,
    DominanceSpace,
    RelationMapping,
    canonical_state_for_query,
    get_relation,
)
from repro_torch.core.prune import (
    pool_distance_matrix,
    prune,
    prune_precomputed,
    squared_dists,
)
from repro_torch.core.search import SearchStats, search_query, udg_search

__all__ = [
    "BATCHED_AUTO_MIN_N",
    "BuildReport",
    "ConstructionEntry",
    "DominanceSpace",
    "EntryTable",
    "GraphStats",
    "LabeledGraph",
    "PATCH_VARIANTS",
    "RELATIONS",
    "RelationMapping",
    "SearchStats",
    "add_patch_edges",
    "build_dedicated_reference",
    "build_graphs_concurrent",
    "build_index",
    "build_udg",
    "build_udg_batched",
    "build_udg_exact",
    "canonical_state_for_query",
    "get_relation",
    "pool_distance_matrix",
    "prune",
    "prune_precomputed",
    "search_query",
    "squared_dists",
    "udg_search",
]
