"""Hi-PNG baseline (Yang et al., KDD'25) — containment-specific hierarchical
interval partition navigating graph, reimplemented from its description.

Hi-PNG recursively partitions the interval (s, t) endpoint space until each
leaf holds at most a leaf-size threshold of objects, and builds a proximity
graph at every tree node over the objects in its region. A containment query
[s_q, t_q] selects the dominance region {s_i >= s_q, t_i <= t_q}; the tree is
walked to find (a) maximal nodes fully inside the region — searched with
their node graphs — and (b) partial leaves — scanned brute-force; results
are merged. Graphs are only materialized for nodes above ``min_graph_size``
(below that brute force is cheaper), matching the spirit of the original's
leaf handling."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.baselines.common import ProximityGraph, build_knn_graph, graph_search
from repro_torch.core.prune import squared_dists


class _Node:
    __slots__ = ("ids", "graph", "children", "s_lo", "s_hi", "t_lo", "t_hi")

    def __init__(self, ids: np.ndarray, s_lo, s_hi, t_lo, t_hi):
        self.ids = ids
        self.graph: Optional[ProximityGraph] = None
        self.children: List["_Node"] = []
        self.s_lo, self.s_hi, self.t_lo, self.t_hi = s_lo, s_hi, t_lo, t_hi


class HiPNG:
    name = "hipng"
    supported_relations = ("containment",)

    def __init__(
        self,
        M: int = 16,
        ef_construction: int = 64,
        leaf_size: int = 256,
        min_graph_size: int = 128,
    ):
        self.M = M
        self.ef_construction = ef_construction
        self.leaf_size = leaf_size
        self.min_graph_size = min_graph_size

    def build(self, vectors: np.ndarray, s: np.ndarray, t: np.ndarray, relation: str):
        if relation not in self.supported_relations:
            raise ValueError("Hi-PNG is containment-specific (paper §VI-A)")
        t0 = time.perf_counter()
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.s, self.t = np.asarray(s), np.asarray(t)
        self.index_bytes = 0
        self.root = self._build_node(
            np.arange(len(s), dtype=np.int64),
            float(s.min()), float(s.max()), float(t.min()), float(t.max()), depth=0,
        )
        self.build_seconds = time.perf_counter() - t0
        return self

    def _build_node(self, ids, s_lo, s_hi, t_lo, t_hi, depth) -> _Node:
        node = _Node(ids, s_lo, s_hi, t_lo, t_hi)
        if ids.size >= self.min_graph_size:
            node.graph = build_knn_graph(
                self.vectors[ids], self.M, self.ef_construction
            )
            self.index_bytes += node.graph.index_bytes()
        if ids.size > self.leaf_size:
            # alternate split axis (s at even depth, t at odd), median split
            if depth % 2 == 0:
                key = self.s[ids]
                mid = float(np.median(key))
                left = ids[key <= mid]
                right = ids[key > mid]
                if left.size and right.size:
                    node.children = [
                        self._build_node(left, s_lo, mid, t_lo, t_hi, depth + 1),
                        self._build_node(right, mid, s_hi, t_lo, t_hi, depth + 1),
                    ]
            else:
                key = self.t[ids]
                mid = float(np.median(key))
                left = ids[key <= mid]
                right = ids[key > mid]
                if left.size and right.size:
                    node.children = [
                        self._build_node(left, s_lo, s_hi, t_lo, mid, depth + 1),
                        self._build_node(right, s_lo, s_hi, mid, t_hi, depth + 1),
                    ]
        return node

    # --- query -----------------------------------------------------------------

    def _collect(self, node: _Node, s_q: float, t_q: float, full: list, partial: list):
        """Maximal fully-inside nodes + partial leaves for region
        {s >= s_q, t <= t_q}."""
        if node.s_lo >= s_q and node.t_hi <= t_q:
            full.append(node)
            return
        if node.s_hi < s_q or node.t_lo > t_q:
            return  # disjoint
        if not node.children:
            partial.append(node)
            return
        for ch in node.children:
            self._collect(ch, s_q, t_q, full, partial)

    def search(
        self, q: np.ndarray, s_q: float, t_q: float, k: int, ef: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, dtype=np.float32)
        full: List[_Node] = []
        partial: List[_Node] = []
        self._collect(self.root, s_q, t_q, full, partial)
        cand_ids: List[np.ndarray] = []
        cand_d: List[np.ndarray] = []
        for node in full:
            if node.graph is not None:
                loc, d = graph_search(node.graph, q, 0, max(ef, k))
                cand_ids.append(node.ids[loc])
                cand_d.append(d)
            elif node.ids.size:
                d = squared_dists(self.vectors, q, node.ids)
                cand_ids.append(node.ids)
                cand_d.append(d)
        for node in partial:
            mask = (self.s[node.ids] >= s_q) & (self.t[node.ids] <= t_q)
            ids = node.ids[mask]
            if ids.size:
                d = squared_dists(self.vectors, q, ids)
                cand_ids.append(ids)
                cand_d.append(d)
        if not cand_ids:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        ids = np.concatenate(cand_ids)
        d = np.concatenate(cand_d)
        ids, uniq = np.unique(ids, return_index=True)
        d = d[uniq]
        kk = min(k, ids.size)
        sel = np.argpartition(d, kk - 1)[:kk]
        order = sel[np.argsort(d[sel], kind="stable")]
        return ids[order].astype(np.int32), d[order].astype(np.float32)
