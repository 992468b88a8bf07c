"""ACORN baseline (predicate-agnostic hybrid search, Patel et al. 2024).

ACORN-gamma keeps expanded neighbor lists of ~M*gamma nearest candidates
*without* diversity pruning, so that the subgraph induced by any predicate
retains enough edges to stay navigable. At query time, traversal evaluates
the predicate on each neighbor list and explores (up to) the first M valid
neighbors. We adapt it to interval predicates by using the interval test as
the traversal predicate, as the paper does (gamma=12 recommended)."""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from repro_torch.baselines.common import build_knn_graph, graph_search
from repro_torch.core.predicates import get_relation


class Acorn:
    name = "acorn"

    def __init__(self, M: int = 16, gamma: int = 12, ef_construction: int = 128):
        self.M = M
        self.gamma = gamma
        self.ef_construction = ef_construction

    def build(self, vectors: np.ndarray, s: np.ndarray, t: np.ndarray, relation: str):
        t0 = time.perf_counter()
        self.s, self.t = np.asarray(s), np.asarray(t)
        self.rel = get_relation(relation)
        keep = self.M * self.gamma
        self.pg = build_knn_graph(
            vectors,
            self.M,
            max(self.ef_construction, keep),
            keep_per_node=keep,
            max_degree=2 * keep,
            diversify=False,
        )
        self.build_seconds = time.perf_counter() - t0
        self.index_bytes = self.pg.index_bytes()
        return self

    def search(
        self, q: np.ndarray, s_q: float, t_q: float, k: int, ef: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        mask = self.rel.valid_mask(self.s, self.t, s_q, t_q)
        M = self.M
        adj = self.pg.adj

        def neighbor_filter(nbrs: np.ndarray) -> np.ndarray:
            # first M valid in (distance-sorted) list order ...
            ok = nbrs[mask[nbrs]][:M]
            if ok.size < M:
                # ... plus ACORN's two-hop expansion through invalid neighbors
                inv = nbrs[~mask[nbrs]][:M]
                if inv.size:
                    two = np.concatenate([adj[int(u)] for u in inv])
                    if two.size:
                        two = two[mask[two]]
                        ok = np.concatenate([ok, two])
                        _, first = np.unique(ok, return_index=True)
                        ok = ok[np.sort(first)][:M]
            return ok

        # seed with a spread of valid objects so restrictive filters start
        # inside the predicate subgraph (entry adaptation for interval preds).
        cand = np.where(mask)[0]
        if cand.size == 0:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        starts = cand[:: max(1, cand.size // 8)][:8]
        if mask[0]:
            starts = np.unique(np.append(starts, 0))
        ids, ds = graph_search(
            self.pg, q, 0, max(ef, k), neighbor_filter=neighbor_filter,
            start_set=starts,
        )
        ok = mask[ids]
        return ids[ok][:k], ds[ok][:k]
