"""Algorithm 2: UDGSEARCH — edge-filtered best-first graph search (host ref).

This is the reference (numpy/heapq) implementation used by construction, by
correctness tests, and as the oracle for the batched JAX search in
``repro.search``. The only filter applied during traversal is the label
containment test; distances are always computed on raw embedding vectors.
"""
from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph


class SearchStats:
    __slots__ = ("dist_evals", "hops")

    def __init__(self) -> None:
        self.dist_evals = 0
        self.hops = 0


def udg_search(
    graph: LabeledGraph,
    q: np.ndarray,
    a: int,
    c: int,
    ep: int,
    K: int,
    *,
    ignore_labels: bool = False,
    stats: Optional[SearchStats] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return up to K (ids, squared dists) sorted ascending for state (a, c).

    ``a``/``c`` are canonical ranks. ``ignore_labels=True`` is the broad
    "any-state" search used once per insertion by the practical constructor
    (paper §V-A) — it traverses every edge regardless of label.
    """
    q = np.asarray(q, dtype=np.float32)
    vecs = graph.vectors
    visited = np.zeros(graph.n, dtype=bool)
    visited[ep] = True
    d0 = float(np.dot(q - vecs[ep], q - vecs[ep]))
    if stats is not None:
        stats.dist_evals += 1
    # pool: min-heap of (dist, id); ann: max-heap via negated dist.
    pool = [(d0, ep)]
    ann = [(-d0, ep)]
    while pool:
        dv, v = heapq.heappop(pool)
        if len(ann) >= K and dv > -ann[0][0]:
            break
        if stats is not None:
            stats.hops += 1
        if ignore_labels:
            nbrs = graph.all_neighbors(v)
        else:
            nbrs = graph.active_neighbors(v, a, c)
        if nbrs.size == 0:
            continue
        # Dedup multi-tuples + drop visited, preserving first-seen order.
        nbrs = np.unique(nbrs)
        nbrs = nbrs[~visited[nbrs]]
        if nbrs.size == 0:
            continue
        visited[nbrs] = True
        diff = vecs[nbrs] - q
        dists = np.einsum("ij,ij->i", diff, diff)
        if stats is not None:
            stats.dist_evals += int(nbrs.size)
        bound = -ann[0][0]
        for o, do in zip(nbrs, dists):
            do = float(do)
            if len(ann) < K or do < bound:
                heapq.heappush(pool, (do, int(o)))
                heapq.heappush(ann, (-do, int(o)))
                if len(ann) > K:
                    heapq.heappop(ann)
                bound = -ann[0][0]
    out = sorted((-nd, i) for nd, i in ann)
    ids = np.array([i for _, i in out], dtype=np.int32)
    ds = np.array([d for d, _ in out], dtype=np.float32)
    return ids, ds


def search_query(
    graph: LabeledGraph,
    q: np.ndarray,
    s_q: float,
    t_q: float,
    k: int,
    ef: int,
    entry_table,
    *,
    stats: Optional[SearchStats] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end single query: map + canonicalize + entry lookup + search."""
    state = graph.canonical_rank_state(s_q, t_q)
    empty = (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.float32))
    if state is None:
        return empty
    a, c = state
    ep = entry_table.entry(a, c)
    if ep is None:
        return empty
    ids, ds = udg_search(graph, q, a, c, ep, max(k, ef), stats=stats)
    return ids[:k], ds[:k]
