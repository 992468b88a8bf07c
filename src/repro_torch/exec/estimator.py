"""Selectivity estimation over dominance rank space (planner layer).

The execution planner needs, per query, the size of the valid set

    V(a, c) = { i | X_i >= a  and  Y_i <= c }            (Eq. 1)

in O(1), *before* deciding how to execute the query. Because every
relation is already compiled into rank space (integer indices into the
canonical grids ``U_X``/``U_Y``), one relation-independent structure
suffices: a G x G **cumulative histogram** over rank space.

Let rank buckets partition ``[0, |U_X|)`` and ``[0, |U_Y|)`` (near-uniform
integer edges). With ``CP[i, j] = #{ x_rank >= edges_x[i] and
y_rank < edges_y[j] }`` precomputed once, a query state (a, c) — the rank
pair produced by canonicalization — gets *exact bounds* from four corner
lookups:

    lo <= |V(a, c)| <= hi,    hi - lo <= (pop. of a's x-bucket)
                                       + (pop. of c's y-bucket)

so the analytic error bound shrinks as O(n/G) for near-uniform rank
occupancy (ranks are dense by construction: every canonical value is
realized by at least one object). When the upper bound is small the
estimator falls back to an **exact** enumeration through a per-bucket CSR
ordered by y-rank (full buckets binary-search their prefix; only the one
partial x-bucket is scanned), which doubles as the valid-id enumerator of
the ``BRUTE_VALID`` execution path.

The cumulative table is tiny (G^2 int64) and put on a device on demand
(``device_tables`` + ``count_bounds_device``, the torch twin of
``count_bounds`` for code that keeps the query states on the device); host
planning uses the vectorized numpy ``count_bounds``. The exact-fallback CSR
is the O(n) component — 12 bytes/node of int32 host memory, rebuilt per
epoch.

A host numpy copy of the JAX package's estimator, plus the device twin.
``STATE_FIELDS`` / ``from_state`` carry an estimator built elsewhere over
unchanged, so both packages can plan over the same index.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.predicates import rank_bucket_edges
from repro_torch.device import resolve_device


STATE_FIELDS = (
    "cum", "edges_x", "edges_y", "_ids", "_xr", "_yr", "_off",
    "n", "num_x", "num_y", "buckets",
)


class SelectivityEstimator:
    """Cumulative rank-space histogram + exact small-count fallback.

    Built once per index epoch (from the same ``DominanceSpace`` the graph
    labels come from) and rebuilt on epoch swap; all query-time methods are
    read-only and thread-safe.
    """

    def __init__(
        self,
        x_rank: np.ndarray,
        y_rank: np.ndarray,
        num_x: int,
        num_y: int,
        *,
        buckets: int = 64,
    ):
        x_rank = np.asarray(x_rank, dtype=np.int64).ravel()
        y_rank = np.asarray(y_rank, dtype=np.int64).ravel()
        self.n = int(x_rank.size)
        self.num_x = int(max(num_x, 1))
        self.num_y = int(max(num_y, 1))
        self.buckets = int(buckets)
        self.edges_x = rank_bucket_edges(self.num_x, buckets)
        self.edges_y = rank_bucket_edges(self.num_y, buckets)
        gx = self.edges_x.shape[0] - 1
        gy = self.edges_y.shape[0] - 1
        self.gx, self.gy = gx, gy
        if self.n:
            bx = np.clip(
                np.searchsorted(self.edges_x, x_rank, side="right") - 1, 0, gx - 1
            )
            by = np.clip(
                np.searchsorted(self.edges_y, y_rank, side="right") - 1, 0, gy - 1
            )
        else:
            bx = by = np.empty(0, dtype=np.int64)
        H = np.zeros((gx, gy), dtype=np.int64)
        if self.n:
            np.add.at(H, (bx, by), 1)
        # CP[i, j] = #{ x_bucket >= i and y_bucket < j }  — zero row/col pads
        # make every corner lookup branch-free (CP[gx, :] = CP[:, 0] = 0).
        cp = np.zeros((gx + 1, gy + 1), dtype=np.int64)
        cp[:gx, 1:] = np.cumsum(np.cumsum(H[::-1], axis=0)[::-1], axis=1)
        self.cum = cp
        # exact-fallback CSR: ids grouped by x-bucket, y-sorted within each
        # (int32 throughout — ranks are < n, and this O(n) component is the
        # dominant memory cost of the estimator)
        order = np.lexsort((y_rank, bx)) if self.n else np.empty(0, np.int64)
        self._ids = order.astype(np.int32)
        self._xr = x_rank[order].astype(np.int32)
        self._yr = y_rank[order].astype(np.int32)
        self._off = np.zeros(gx + 1, dtype=np.int64)
        if self.n:
            self._off[1:] = np.cumsum(np.bincount(bx, minlength=gx))

    # --- construction helpers -------------------------------------------------

    @classmethod
    def from_space(cls, space, *, buckets: int = 64) -> "SelectivityEstimator":
        """Build from a ``repro.core.predicates.DominanceSpace``."""
        xr, yr = space.ranks()
        return cls(
            xr, yr, space.U_X.shape[0], space.U_Y.shape[0], buckets=buckets
        )

    @classmethod
    def from_graph(cls, g, *, buckets: int = 64) -> "SelectivityEstimator":
        """Build from a ``LabeledGraph`` (reuses its precomputed ranks)."""
        return cls(
            g.x_rank, g.y_rank, g.space.U_X.shape[0], g.space.U_Y.shape[0],
            buckets=buckets,
        )

    @classmethod
    def from_state(cls, arrays: dict) -> "SelectivityEstimator":
        """Rebuild from the fields named in ``STATE_FIELDS`` without
        recomputing them (the histogram and CSR are taken as given)."""
        est = cls.__new__(cls)
        for f in ("n", "num_x", "num_y", "buckets"):
            setattr(est, f, int(arrays[f]))
        for f in ("cum", "edges_x", "edges_y", "_ids", "_xr", "_yr", "_off"):
            setattr(est, f, np.asarray(arrays[f]).copy())
        est.gx = est.edges_x.shape[0] - 1
        est.gy = est.edges_y.shape[0] - 1
        return est

    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (self.cum, self.edges_x, self.edges_y, self._ids,
                      self._xr, self._yr, self._off)
        )

    # --- O(1) bounded counts --------------------------------------------------

    def count_bounds(
        self, a: np.ndarray, c: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized ``(lo, hi)`` with ``lo <= |V(a, c)| <= hi`` per query.

        ``a``/``c`` are rank-space thresholds (any integer values; states
        past either grid naturally produce 0/0)."""
        a = np.asarray(a, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        # hi: relax to enclosing bucket corners (largest edge <= a,
        # smallest edge >= c+1)
        i_hi = np.clip(
            np.searchsorted(self.edges_x, a, side="right") - 1, 0, self.gx
        )
        j_hi = np.clip(
            np.searchsorted(self.edges_y, c + 1, side="left"), 0, self.gy
        )
        i_hi = np.where(a >= self.num_x, self.gx, i_hi)
        j_hi = np.where(c < 0, 0, j_hi)
        hi = self.cum[i_hi, j_hi]
        # lo: shrink to enclosed bucket corners (smallest edge >= a,
        # largest edge <= c+1)
        i_lo = np.clip(np.searchsorted(self.edges_x, a, side="left"), 0, self.gx)
        j_lo = np.clip(
            np.searchsorted(self.edges_y, c + 1, side="right") - 1, 0, self.gy
        )
        lo = self.cum[i_lo, j_lo]
        return lo, hi

    def error_bound(self, a: np.ndarray, c: np.ndarray) -> np.ndarray:
        """Analytic per-query bound on the estimation error (= hi - lo)."""
        lo, hi = self.count_bounds(a, c)
        return hi - lo

    # --- exact fallback -------------------------------------------------------

    def exact_valid_ids(self, a: int, c: int) -> np.ndarray:
        """Exact enumeration of ``V(a, c)`` (ascending ids within runs).

        O(G log(n/G) + n/G + |V|): full x-buckets contribute a binary-
        searched y-prefix; only the partial bucket containing ``a`` is
        scanned. Intended for the small-count regime flagged by
        ``count_bounds`` (the ``BRUTE_VALID`` plan), but correct at any
        count."""
        a, c = int(a), int(c)
        if self.n == 0 or a >= self.num_x or c < 0:
            return np.empty(0, dtype=np.int32)
        ib = min(
            max(int(np.searchsorted(self.edges_x, a, side="right")) - 1, 0),
            self.gx - 1,
        )
        parts = []
        lo_off, hi_off = int(self._off[ib]), int(self._off[ib + 1])
        seg = slice(lo_off, hi_off)
        keep = (self._xr[seg] >= a) & (self._yr[seg] <= c)
        parts.append(self._ids[seg][keep])
        for jb in range(ib + 1, self.gx):
            lo_off, hi_off = int(self._off[jb]), int(self._off[jb + 1])
            m = int(np.searchsorted(self._yr[lo_off:hi_off], c, side="right"))
            parts.append(self._ids[lo_off : lo_off + m])
        return np.concatenate(parts) if parts else np.empty(0, np.int32)

    def exact_count(self, a: int, c: int) -> int:
        return int(self.exact_valid_ids(a, c).shape[0])

    # --- device residency -----------------------------------------------------

    def device_tables(self, device=None) -> tuple:
        """Memoized ``(cum, edges_x, edges_y)`` int64 tensors on ``device``
        (``None`` = the card), for :func:`count_bounds_device`."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_dev", {})
        key = str(dev)
        if key not in cache:
            cache[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)
                for x in (self.cum, self.edges_x, self.edges_y))
        return cache[key]


def count_bounds_device(cum, edges_x, edges_y, a, c):
    """Torch twin of ``SelectivityEstimator.count_bounds``: ``(lo, hi)``
    int64 with the same values, on the tables' device. ``cum`` /
    ``edges_x`` / ``edges_y`` come from ``device_tables()``; ``a`` / ``c``
    are integer rank thresholds (tensors or arrays)."""
    gx = cum.shape[0] - 1
    gy = cum.shape[1] - 1
    a = torch.as_tensor(a, device=cum.device).long()
    c = torch.as_tensor(c, device=cum.device).long()
    i_hi = (torch.searchsorted(edges_x, a, side="right") - 1).clamp(0, gx)
    j_hi = torch.searchsorted(edges_y, c + 1, side="left").clamp(0, gy)
    i_hi = torch.where(a >= edges_x[-1], gx, i_hi)
    j_hi = torch.where(c < 0, 0, j_hi)
    hi = cum[i_hi, j_hi]
    i_lo = torch.searchsorted(edges_x, a, side="left").clamp(0, gx)
    j_lo = (torch.searchsorted(edges_y, c + 1, side="right") - 1).clamp(0, gy)
    lo = cum[i_lo, j_lo]
    return lo, hi
