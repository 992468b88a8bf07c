"""PostFilter-HNSW baseline: search a global (predicate-blind) proximity
graph with an oversampled pool, then drop candidates violating the interval
predicate. Adaptively doubles the pool until k valid results are found or a
cap is reached — the standard post-filtering recipe the paper compares to."""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from repro_torch.baselines.common import build_knn_graph, graph_search
from repro_torch.core.predicates import get_relation


class PostFilterHNSW:
    name = "postfilter"

    def __init__(self, M: int = 16, ef_construction: int = 128, max_ef: int = 4096):
        self.M = M
        self.ef_construction = ef_construction
        self.max_ef = max_ef

    def build(self, vectors: np.ndarray, s: np.ndarray, t: np.ndarray, relation: str):
        t0 = time.perf_counter()
        self.s, self.t = np.asarray(s), np.asarray(t)
        self.rel = get_relation(relation)
        self.pg = build_knn_graph(vectors, self.M, self.ef_construction)
        self.build_seconds = time.perf_counter() - t0
        self.index_bytes = self.pg.index_bytes()
        return self

    def search(
        self, q: np.ndarray, s_q: float, t_q: float, k: int, ef: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        mask = self.rel.valid_mask(self.s, self.t, s_q, t_q)
        cur_ef = max(ef, k)
        while True:
            ids, ds = graph_search(self.pg, q, 0, cur_ef)
            ok = mask[ids]
            if np.count_nonzero(ok) >= k or cur_ef >= self.max_ef:
                return ids[ok][:k], ds[ok][:k]
            cur_ef *= 2
