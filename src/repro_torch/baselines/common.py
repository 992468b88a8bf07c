"""Shared substrate for graph baselines: an incremental single-layer
proximity graph (HNSW-style insertion + Algorithm-1 pruning, no hierarchy)
and a generic best-first search with optional neighbor filtering.

Using one insertion/pruning rule across UDG and every graph baseline keeps
the comparison about *indexing strategy*, not about unrelated implementation
details — mirroring the paper's uniform M / efconstruction setting.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.prune import prune, squared_dists


class ProximityGraph:
    """Plain (unlabeled) proximity graph with growable adjacency."""

    def __init__(self, vectors: np.ndarray, max_degree: int):
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n = self.vectors.shape[0]
        self.max_degree = max_degree
        self.adj: List[np.ndarray] = [np.empty(0, dtype=np.int32) for _ in range(self.n)]

    def set_neighbors(self, u: int, nbrs: np.ndarray) -> None:
        self.adj[u] = np.asarray(nbrs, dtype=np.int32)

    def add_neighbor(self, u: int, v: int, *, shrink_with_prune: bool) -> None:
        cur = self.adj[u]
        if v in cur:
            return
        cur = np.append(cur, np.int32(v))
        if cur.shape[0] > self.max_degree:
            if shrink_with_prune:
                d = squared_dists(self.vectors, self.vectors[u], cur.astype(np.int64))
                cur = prune(self.vectors, u, cur, d, self.max_degree)
            else:  # keep nearest by distance
                d = squared_dists(self.vectors, self.vectors[u], cur.astype(np.int64))
                cur = cur[np.argsort(d, kind="stable")[: self.max_degree]]
        self.adj[u] = cur.astype(np.int32)

    def num_edges(self) -> int:
        return int(sum(a.shape[0] for a in self.adj))

    def index_bytes(self) -> int:
        return self.num_edges() * 4 + self.n * 8


def graph_search(
    pg: ProximityGraph,
    q: np.ndarray,
    ep: int,
    ef: int,
    *,
    neighbor_filter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    start_set: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Best-first search; ``neighbor_filter`` maps candidate neighbor ids to
    the subset that may be *explored* (ACORN-style predicate traversal)."""
    q = np.asarray(q, dtype=np.float32)
    vecs = pg.vectors
    visited = np.zeros(pg.n, dtype=bool)
    starts = np.asarray([ep] if start_set is None else start_set, dtype=np.int64)
    starts = starts[~visited[starts]]
    visited[starts] = True
    d0 = squared_dists(vecs, q, starts)
    pool = [(float(d), int(i)) for d, i in zip(d0, starts)]
    heapq.heapify(pool)
    ann = [(-float(d), int(i)) for d, i in zip(d0, starts)]
    heapq.heapify(ann)
    while len(ann) > ef:
        heapq.heappop(ann)
    while pool:
        dv, v = heapq.heappop(pool)
        if len(ann) >= ef and dv > -ann[0][0]:
            break
        nbrs = pg.adj[v]
        if neighbor_filter is not None and nbrs.size:
            nbrs = neighbor_filter(nbrs)
        if nbrs.size == 0:
            continue
        nbrs = nbrs[~visited[nbrs]]
        if nbrs.size == 0:
            continue
        visited[nbrs] = True
        dists = squared_dists(vecs, q, nbrs.astype(np.int64))
        bound = -ann[0][0] if ann else np.inf
        for o, do in zip(nbrs, dists):
            do = float(do)
            if len(ann) < ef or do < bound:
                heapq.heappush(pool, (do, int(o)))
                heapq.heappush(ann, (-do, int(o)))
                if len(ann) > ef:
                    heapq.heappop(ann)
                bound = -ann[0][0]
    out = sorted((-nd, i) for nd, i in ann)
    ids = np.array([i for _, i in out], dtype=np.int32)
    ds = np.array([d for d, _ in out], dtype=np.float32)
    return ids, ds


def build_knn_graph(
    vectors: np.ndarray,
    M: int,
    ef_construction: int,
    *,
    max_degree: Optional[int] = None,
    diversify: bool = True,
    keep_per_node: Optional[int] = None,
) -> ProximityGraph:
    """Incremental proximity-graph construction (single-layer HNSW style).

    ``keep_per_node`` > M skips diversity pruning and keeps that many nearest
    candidates instead — the ACORN-gamma construction rule.
    """
    n = vectors.shape[0]
    pg = ProximityGraph(vectors, max_degree or 2 * (keep_per_node or M))
    for j in range(1, n):
        q = pg.vectors[j]
        ids, ds = graph_search(pg, q, 0, max(ef_construction, keep_per_node or M))
        if keep_per_node is not None:
            nbrs = ids[:keep_per_node]
        elif diversify:
            nbrs = prune(pg.vectors, j, ids, ds, M)
        else:
            nbrs = ids[:M]
        pg.set_neighbors(j, nbrs)
        for u in nbrs:
            pg.add_neighbor(int(u), j, shrink_with_prune=diversify)
    return pg
