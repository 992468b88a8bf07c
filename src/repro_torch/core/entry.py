"""Compact entry-point table (paper §IV-A: "maintained by a compact auxiliary
table").

Observation: if V(a, c) is non-empty, the object with *minimum transformed Y*
among those with ``X >= a`` is itself valid (its Y is <= the Y of any valid
object). So one suffix-argmin over the X-sorted order provides an O(1) valid
entry point for every canonical state — |U_X| ints of storage.

During construction, an even simpler invariant suffices: all inserted objects
already satisfy the Y bound, so the inserted object with maximum X is a valid
entry for threshold ``x_L`` iff any inserted object is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.graph import LabeledGraph


class EntryTable:
    """Query-time entry points: for each canonical X rank, the min-Y object
    among objects with x_rank >= that rank."""

    def __init__(self, graph: LabeledGraph):
        n = graph.n
        order = np.lexsort((np.arange(n), graph.x_rank))  # ascending x_rank
        xr_sorted = graph.x_rank[order]
        yr_sorted = graph.y_rank[order]
        # suffix argmin of y_rank over the x-sorted object order
        suf = np.empty(n, dtype=np.int64)
        best = n - 1
        suf[n - 1] = n - 1
        for p in range(n - 2, -1, -1):
            if yr_sorted[p] <= yr_sorted[best]:
                best = p
            suf[p] = best
        # first position in x-sorted order whose x_rank >= k, for each rank k
        self._first_pos = np.searchsorted(xr_sorted, np.arange(graph.num_x))
        self._suffix_argmin = order[suf]
        self._y_rank = graph.y_rank
        self._n = n

    def entry(self, a: int, c: int) -> Optional[int]:
        """A valid entry node for canonical rank state (a, c), or None."""
        if a < 0 or a >= self._first_pos.shape[0]:
            return None
        p = int(self._first_pos[a])
        if p >= self._n:
            return None
        node = int(self._suffix_argmin[p])
        if self._y_rank[node] <= c:
            return node
        return None

    def device_arrays(self) -> dict:
        """Export for the batched JAX search (int32, sentinel -1)."""
        first = self._first_pos.astype(np.int32)
        valid = first < self._n
        ent = np.where(valid, self._suffix_argmin[np.minimum(first, self._n - 1)], -1)
        return {
            "entry_node": ent.astype(np.int32),       # [num_x]
            "entry_y_rank": np.where(
                ent >= 0, self._y_rank[np.maximum(ent, 0)], np.iinfo(np.int32).max
            ).astype(np.int32),
        }


class ConstructionEntry:
    """Incremental max-X entry point used while the graph is being built."""

    def __init__(self) -> None:
        self._best_node = -1
        self._best_x_rank = -1

    def insert(self, node: int, x_rank: int) -> None:
        if x_rank > self._best_x_rank:
            self._best_x_rank = x_rank
            self._best_node = node

    def entry(self, a_rank: int) -> Optional[int]:
        if self._best_node < 0 or self._best_x_rank < a_rank:
            return None
        return self._best_node
