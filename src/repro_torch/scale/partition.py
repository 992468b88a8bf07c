"""Dominance-space segmentation + the recall-safe coarse router (a numpy
copy of the JAX package's ``scale/partition.py``).

A million-object UDG does not fit one graph traversal's working set, and —
more importantly — most queries touch only a corner of the dominance
plane. This module partitions the *normalized dominance space* (the same
(X, Y) plane every relation compiles into, Eq. 1) into a G×G-aligned grid
of rectangular cells and answers, per query, which cells can possibly
hold a valid object.

Alignment contract: the cell edges come from ``rank_bucket_edges`` over
the global canonical grids — the exact bucketing the selectivity
estimator (``repro_torch.exec.estimator``) uses — so the router, the planner
histogram, and any other rank-space consumer agree on boundaries by
construction.

Router invariant (``tests/test_torch_segmented.py`` pins
this for all five relations): for every canonical query state (a, c),

    valid object  =>  its cell is routed.

Routing may *over-select* (a routed cell can turn out empty for the
query — the per-segment planner's ``hi == 0`` refinement then skips it,
which is equally safe because ``hi`` is a true upper bound), but it can
never drop a valid object; that is what makes segment pruning recall-safe.

The proof is containment: a cell covers X ranks ``[ex[i], ex[i+1])`` and
Y ranks ``[ey[j], ey[j+1])``. If an object in cell (i, j) satisfies
``x_rank >= a`` then ``ex[i+1] - 1 >= x_rank >= a``; if it satisfies
``y_rank <= c`` then ``ey[j] <= y_rank <= c``. So testing the cell's
*extreme corners* — its max X rank against ``a`` and min Y rank against
``c`` — accepts every cell holding a valid object. The value-space twin
(``route_values``) uses the same argument on half-open value intervals
and exists for the streaming tier, where newly inserted objects do not
lie on the construction-time canonical grid.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.predicates import DominanceSpace, rank_bucket_edges


@dataclasses.dataclass(frozen=True)
class SegmentGrid:
    """G×G-aligned rectangular partition of dominance space.

    ``edges_x``/``edges_y`` are rank-space cell edges (cell i covers ranks
    ``[edges_x[i], edges_x[i+1])``); ``vals_x``/``vals_y`` are the
    corresponding value-space boundaries with the outer edges opened to
    ±inf so *every* value — including ones not on the construction grid —
    maps to exactly one cell. Cells flatten row-major: ``cell = ix * gy +
    iy``.
    """

    edges_x: np.ndarray   # [gx+1] int64 rank edges over [0, |U_X|]
    edges_y: np.ndarray   # [gy+1] int64 rank edges over [0, |U_Y|]
    vals_x: np.ndarray    # [gx+1] f64 value boundaries, vals_x[0]=-inf, [-1]=+inf
    vals_y: np.ndarray    # [gy+1] f64 value boundaries, vals_y[0]=-inf, [-1]=+inf

    @property
    def gx(self) -> int:
        return self.edges_x.shape[0] - 1

    @property
    def gy(self) -> int:
        return self.edges_y.shape[0] - 1

    @property
    def num_cells(self) -> int:
        return self.gx * self.gy

    @staticmethod
    def from_space(space: DominanceSpace, cells_per_axis: int) -> "SegmentGrid":
        """Partition ``space`` into at most ``cells_per_axis``² cells.

        Tiny grids collapse duplicate edges (``rank_bucket_edges``), so the
        actual cell count adapts — a dataset with 3 distinct X values never
        gets 8 X cells.
        """
        ex = rank_bucket_edges(space.U_X.shape[0], cells_per_axis)
        ey = rank_bucket_edges(space.U_Y.shape[0], cells_per_axis)
        # Cell i's value span starts at the value of its first rank; the
        # outer boundaries open to ±inf so off-grid (streaming) values
        # still land in a cell.
        vx = np.empty(ex.shape[0], dtype=np.float64)
        vx[0], vx[-1] = -np.inf, np.inf
        vx[1:-1] = space.U_X[ex[1:-1]]
        vy = np.empty(ey.shape[0], dtype=np.float64)
        vy[0], vy[-1] = -np.inf, np.inf
        vy[1:-1] = space.U_Y[ey[1:-1]]
        return SegmentGrid(edges_x=ex, edges_y=ey, vals_x=vx, vals_y=vy)

    def nbytes(self) -> int:
        return (self.edges_x.nbytes + self.edges_y.nbytes
                + self.vals_x.nbytes + self.vals_y.nbytes)

    # --- object -> cell assignment -------------------------------------------

    def assign_ranks(self, x_rank: np.ndarray, y_rank: np.ndarray) -> np.ndarray:
        """Flattened cell id per object from global rank coordinates."""
        ix = np.clip(
            np.searchsorted(self.edges_x, np.asarray(x_rank, np.int64),
                            side="right") - 1, 0, self.gx - 1)
        iy = np.clip(
            np.searchsorted(self.edges_y, np.asarray(y_rank, np.int64),
                            side="right") - 1, 0, self.gy - 1)
        return ix * self.gy + iy

    def assign_values(self, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
        """Flattened cell id per object from transformed *values* (the
        streaming path — off-grid values allowed)."""
        ix = np.clip(
            np.searchsorted(self.vals_x, np.asarray(X, np.float64),
                            side="right") - 1, 0, self.gx - 1)
        iy = np.clip(
            np.searchsorted(self.vals_y, np.asarray(Y, np.float64),
                            side="right") - 1, 0, self.gy - 1)
        return ix * self.gy + iy

    # --- query -> cells routing ----------------------------------------------

    def route_ranks(
        self, a: np.ndarray, c: np.ndarray, valid: np.ndarray | None = None
    ) -> np.ndarray:
        """[B, num_cells] bool — cells that can intersect each query's
        dominance rectangle, from *global rank* canonical states (a, c).

        A cell is routed iff its extreme corner can satisfy Eq. (1):
        ``max x_rank in cell >= a`` and ``min y_rank in cell <= c``.
        ``valid=False`` rows route nowhere (empty valid set).
        """
        a = np.asarray(a, dtype=np.int64).reshape(-1)
        c = np.asarray(c, dtype=np.int64).reshape(-1)
        # cell ix holds ranks up to edges_x[ix+1]-1; cell iy from edges_y[iy]
        x_ok = self.edges_x[1:][None, :] - 1 >= a[:, None]   # [B, gx]
        y_ok = self.edges_y[:-1][None, :] <= c[:, None]      # [B, gy]
        out = (x_ok[:, :, None] & y_ok[:, None, :]).reshape(a.shape[0], -1)
        if valid is not None:
            out &= np.asarray(valid, dtype=bool).reshape(-1, 1)
        return out

    def route_values(
        self, x_q: np.ndarray, y_q: np.ndarray,
        valid: np.ndarray | None = None,
    ) -> np.ndarray:
        """[B, num_cells] bool routing from transformed query *values* —
        the streaming twin of :meth:`route_ranks` (no canonical grid
        needed, so it stays correct as inserts move off the construction
        grid). Cell ix covers X in ``[vals_x[ix], vals_x[ix+1])``: some
        member can have ``X >= x_q`` iff ``vals_x[ix+1] > x_q``, and some
        member can have ``Y <= y_q`` iff ``vals_y[iy] <= y_q``.
        """
        x_q = np.asarray(x_q, dtype=np.float64).reshape(-1)
        y_q = np.asarray(y_q, dtype=np.float64).reshape(-1)
        x_ok = self.vals_x[1:][None, :] > x_q[:, None]       # [B, gx]
        y_ok = self.vals_y[:-1][None, :] <= y_q[:, None]     # [B, gy]
        out = (x_ok[:, :, None] & y_ok[:, None, :]).reshape(x_q.shape[0], -1)
        if valid is not None:
            out &= np.asarray(valid, dtype=bool).reshape(-1, 1)
        return out


def canonicalize_batch(
    space: DominanceSpace, x_q: np.ndarray, y_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized rank-space canonicalization — ``(a, c, valid)``.

    The batch twin of ``DominanceSpace.canonicalize`` returning *ranks*
    (indices into ``U_X``/``U_Y``) instead of values: ``a`` is the successor
    rank of ``x_q``, ``c`` the predecessor rank of ``y_q``; rows where
    either does not exist get ``valid=False`` (their valid set is provably
    empty, so the router sends them nowhere).
    """
    x_q = np.asarray(x_q, dtype=np.float64).reshape(-1)
    y_q = np.asarray(y_q, dtype=np.float64).reshape(-1)
    a = np.searchsorted(space.U_X, x_q, side="left").astype(np.int64)
    c = (np.searchsorted(space.U_Y, y_q, side="right") - 1).astype(np.int64)
    valid = (a < space.U_X.shape[0]) & (c >= 0)
    return np.clip(a, 0, max(space.U_X.shape[0] - 1, 0)), \
        np.clip(c, 0, max(space.U_Y.shape[0] - 1, 0)), valid
