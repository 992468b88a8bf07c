"""Interval-predicate semantics and the unified dominance mapping (paper §III).

Every supported relation is a *closed two-bound conjunctive* predicate: the
conjunction of two endpoint comparisons, each relating one data endpoint
(``s_i`` or ``t_i``) to one query endpoint (``s_q`` or ``t_q``) with >= or <=.

UDG compiles each relation into the single normalized dominance predicate

    X_i >= x_q  and  Y_i <= y_q                                     (Eq. 1)

via endpoint selection and (when necessary) negation — Table II of the paper.
After this mapping, construction and search are relation-independent.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class RelationMapping:
    """One row of Table II: a semantic mapping into dominance space.

    ``data_map`` maps data endpoints (s, t) -> (X, Y);
    ``query_map`` maps query endpoints (s_q, t_q) -> (x_q, y_q);
    ``brute`` evaluates the *original* interval predicate directly (used as
    the oracle in tests and for ground-truth generation).
    """

    name: str
    data_map: Callable[[Array, Array], Tuple[Array, Array]]
    query_map: Callable[[float, float], Tuple[float, float]]
    brute: Callable[[Array, Array, float, float], Array]
    # inverse of query_map: (x_q, y_q) -> (s_q, t_q); used by workload
    # generation to synthesize query intervals from dominance targets. Not
    # every relation a user registers needs one — go through
    # ``untransform_query`` which raises a clear error when it is missing.
    query_unmap: Optional[Callable[[float, float], Tuple[float, float]]] = None
    description: str = ""

    def transform_data(self, s: Array, t: Array) -> Tuple[Array, Array]:
        X, Y = self.data_map(np.asarray(s, dtype=np.float64),
                             np.asarray(t, dtype=np.float64))
        return np.asarray(X, dtype=np.float64), np.asarray(Y, dtype=np.float64)

    def transform_query(self, s_q: float, t_q: float) -> Tuple[float, float]:
        x_q, y_q = self.query_map(float(s_q), float(t_q))
        return float(x_q), float(y_q)

    def untransform_query(self, x_q, y_q):
        """Inverse semantic mapping: dominance target (x_q, y_q) -> interval
        (s_q, t_q). Raises ``ValueError`` when the relation has no registered
        inverse (``query_unmap`` is optional for user-defined relations)."""
        if self.query_unmap is None:
            raise ValueError(
                f"relation {self.name!r} has no inverse query mapping "
                "(query_unmap=None); cannot convert dominance targets back "
                "to query intervals"
            )
        return self.query_unmap(x_q, y_q)

    def valid_mask(self, s: Array, t: Array, s_q: float, t_q: float) -> Array:
        """Oracle: boolean validity per object under the original semantics."""
        return self.brute(np.asarray(s, dtype=np.float64),
                          np.asarray(t, dtype=np.float64),
                          float(s_q), float(t_q))


# --- Table II -----------------------------------------------------------------

RELATIONS: Dict[str, RelationMapping] = {}


def _register(mapping: RelationMapping) -> RelationMapping:
    RELATIONS[mapping.name] = mapping
    return mapping


CONTAINMENT = _register(RelationMapping(
    name="containment",
    data_map=lambda s, t: (s, t),
    query_map=lambda sq, tq: (sq, tq),
    brute=lambda s, t, sq, tq: (s >= sq) & (t <= tq),
    query_unmap=lambda xq, yq: (xq, yq),
    description="data interval fully inside query interval: s_i>=s_q & t_i<=t_q",
))

OVERLAP = _register(RelationMapping(
    name="overlap",
    data_map=lambda s, t: (t, s),
    query_map=lambda sq, tq: (sq, tq),
    brute=lambda s, t, sq, tq: (t >= sq) & (s <= tq),
    query_unmap=lambda xq, yq: (xq, yq),
    description="data interval intersects query interval: t_i>=s_q & s_i<=t_q",
))

QUERY_WITHIN_DATA = _register(RelationMapping(
    name="query_within_data",
    data_map=lambda s, t: (t, s),
    query_map=lambda sq, tq: (tq, sq),
    brute=lambda s, t, sq, tq: (s <= sq) & (t >= tq),
    query_unmap=lambda xq, yq: (yq, xq),
    description="query interval fully inside data interval: s_i<=s_q & t_i>=t_q",
))

BOTH_AFTER = _register(RelationMapping(
    name="both_after",
    data_map=lambda s, t: (s, -t),
    query_map=lambda sq, tq: (sq, -tq),
    brute=lambda s, t, sq, tq: (s >= sq) & (t >= tq),
    query_unmap=lambda xq, yq: (xq, -yq),
    description="both boundaries after: s_i>=s_q & t_i>=t_q",
))

BOTH_BEFORE = _register(RelationMapping(
    name="both_before",
    data_map=lambda s, t: (-s, t),
    query_map=lambda sq, tq: (-sq, tq),
    brute=lambda s, t, sq, tq: (s <= sq) & (t <= tq),
    query_unmap=lambda xq, yq: (-xq, yq),
    description="both boundaries before: s_i<=s_q & t_i<=t_q",
))


def get_relation(name: str) -> RelationMapping:
    try:
        return RELATIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown interval relation {name!r}; supported: {sorted(RELATIONS)}"
        ) from None


# --- Canonical query states (paper §III-C, Lemma 1) ----------------------------


@dataclasses.dataclass(frozen=True)
class DominanceSpace:
    """Transformed coordinates of the dataset plus canonical value grids.

    ``U_X``/``U_Y`` are the sorted distinct transformed coordinates. Only
    these values can flip the truth of Eq. (1), so queries are snapped onto
    them (canonicalization is exact — Lemma 1).
    """

    X: Array            # [n] transformed data X coordinates
    Y: Array            # [n] transformed data Y coordinates
    U_X: Array          # sorted distinct X values
    U_Y: Array          # sorted distinct Y values

    @staticmethod
    def build(X: Array, Y: Array) -> "DominanceSpace":
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        return DominanceSpace(X=X, Y=Y, U_X=np.unique(X), U_Y=np.unique(Y))

    @staticmethod
    def from_intervals(rel: RelationMapping, s: Array, t: Array) -> "DominanceSpace":
        X, Y = rel.transform_data(s, t)
        return DominanceSpace.build(X, Y)

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    def canonicalize(self, x_q: float, y_q: float) -> Tuple[float, float] | None:
        """Snap raw transformed query to canonical state (a, c) = (x_q+, y_q-).

        Returns None when either boundary is undefined (valid set empty).
        """
        # a = min{x in U_X | x >= x_q}  (successor)
        i = int(np.searchsorted(self.U_X, x_q, side="left"))
        if i >= self.U_X.shape[0]:
            return None
        a = float(self.U_X[i])
        # c = max{y in U_Y | y <= y_q}  (predecessor)
        j = int(np.searchsorted(self.U_Y, y_q, side="right")) - 1
        if j < 0:
            return None
        c = float(self.U_Y[j])
        return a, c

    def valid_mask_state(self, a: float, c: float) -> Array:
        """V(a, c) = {i | X_i >= a and Y_i <= c} as a boolean mask."""
        return (self.X >= a) & (self.Y <= c)

    def x_successor(self, x: float) -> float | None:
        """First canonical X value strictly greater than ``x`` (sweep leap)."""
        i = int(np.searchsorted(self.U_X, x, side="right"))
        if i >= self.U_X.shape[0]:
            return None
        return float(self.U_X[i])

    # --- rank-space histogram hooks (repro.exec planner layer) ----------------

    def ranks(self) -> Tuple[Array, Array]:
        """Integer rank coordinates (indices into ``U_X``/``U_Y``) per object.

        A canonical query state (a, c) given as *ranks* selects exactly
        ``x_rank >= rank(a) and y_rank <= rank(c)`` — the integer-space form
        of Eq. (1) used by device labels and by the selectivity estimator's
        rank-space histogram (``repro.exec.estimator``).
        """
        return (
            np.searchsorted(self.U_X, self.X).astype(np.int64),
            np.searchsorted(self.U_Y, self.Y).astype(np.int64),
        )


def rank_bucket_edges(num: int, buckets: int) -> Array:
    """Near-uniform integer bucket edges over the rank domain ``[0, num]``.

    At most ``buckets`` cells; duplicate edges from tiny grids collapse.
    Bucket ``i`` covers ranks ``[edges[i], edges[i+1])``. This is the
    bucketing contract shared by the planner's selectivity histogram
    (``repro.exec.estimator``) — one definition, so estimator counts and
    any other rank-space consumer can never disagree on cell boundaries.
    """
    num = max(int(num), 1)
    return np.unique(
        np.linspace(0, num, min(int(buckets), num) + 1).astype(np.int64)
    )


def canonical_state_for_query(
    rel: RelationMapping, space: DominanceSpace, s_q: float, t_q: float
) -> Tuple[float, float] | None:
    """Full query pipeline: semantic mapping then canonicalization."""
    x_q, y_q = rel.transform_query(s_q, t_q)
    return space.canonicalize(x_q, y_q)
