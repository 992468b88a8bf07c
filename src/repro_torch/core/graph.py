"""Labeled dominance graph (paper §IV-A).

Each directed edge carries a label rectangle in *canonical rank space*:
``(l, r)`` are indices into ``U_X`` and ``(b, e)`` indices into ``U_Y``. A
tuple is active for canonical state ``(a, c)`` (also ranks) iff
``l <= a <= r`` and ``b <= c <= e``.

Rank encoding is an exact re-coordinatization of the paper's value labels:
all label endpoints emitted by UDGConstruction are canonical transformed
coordinates drawn from ``U_X``/``U_Y`` (paper §IV-A), so mapping values to
their index in the sorted distinct arrays preserves every comparison while
making label tests integer ops — which is also what the TPU search kernel
wants (predicated int compares on the VPU instead of float compares that
would be sensitive to bf16/f32 rounding).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.predicates import DominanceSpace, RelationMapping, get_relation

_INT = np.int32
_GROW = 1.6


class _AdjList:
    """Growable struct-of-arrays adjacency for one node."""

    __slots__ = ("nbr", "l", "r", "b", "e", "size")

    def __init__(self, cap: int = 8):
        self.nbr = np.empty(cap, dtype=_INT)
        self.l = np.empty(cap, dtype=_INT)
        self.r = np.empty(cap, dtype=_INT)
        self.b = np.empty(cap, dtype=_INT)
        self.e = np.empty(cap, dtype=_INT)
        self.size = 0

    def _ensure(self, extra: int) -> None:
        need = self.size + extra
        cap = self.nbr.shape[0]
        if need <= cap:
            return
        new_cap = max(need, int(cap * _GROW) + 1)
        for name in ("nbr", "l", "r", "b", "e"):
            old = getattr(self, name)
            new = np.empty(new_cap, dtype=_INT)
            new[: self.size] = old[: self.size]
            setattr(self, name, new)

    def append(self, nbr: int, l: int, r: int, b: int, e: int) -> None:
        self._ensure(1)
        i = self.size
        self.nbr[i] = nbr
        self.l[i] = l
        self.r[i] = r
        self.b[i] = b
        self.e[i] = e
        self.size = i + 1

    def extend(
        self,
        nbrs: np.ndarray,
        l: np.ndarray,
        r: np.ndarray,
        b: np.ndarray,
        e: np.ndarray,
    ) -> None:
        k = int(nbrs.shape[0])
        self._ensure(k)
        i = self.size
        self.nbr[i : i + k] = nbrs
        self.l[i : i + k] = l
        self.r[i : i + k] = r
        self.b[i : i + k] = b
        self.e[i : i + k] = e
        self.size = i + k

    def view(self) -> Tuple[np.ndarray, ...]:
        s = self.size
        return (self.nbr[:s], self.l[:s], self.r[:s], self.b[:s], self.e[:s])


@dataclasses.dataclass
class GraphStats:
    n: int
    num_tuples: int
    max_degree: int
    num_patch_tuples: int
    index_bytes: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class LabeledGraph:
    """The UDG index: vectors + dominance coordinates + labeled adjacency."""

    def __init__(
        self,
        vectors: np.ndarray,
        s: np.ndarray,
        t: np.ndarray,
        relation: str | RelationMapping,
    ):
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n, self.dim = self.vectors.shape
        self.s = np.asarray(s, dtype=np.float64)
        self.t = np.asarray(t, dtype=np.float64)
        self.relation = (
            relation if isinstance(relation, RelationMapping) else get_relation(relation)
        )
        self.space = DominanceSpace.from_intervals(self.relation, self.s, self.t)
        # Per-object canonical ranks of the transformed coordinates.
        self.x_rank = np.searchsorted(self.space.U_X, self.space.X).astype(_INT)
        self.y_rank = np.searchsorted(self.space.U_Y, self.space.Y).astype(_INT)
        self.num_x = int(self.space.U_X.shape[0])
        self.num_y = int(self.space.U_Y.shape[0])
        self.adj: List[_AdjList] = [_AdjList() for _ in range(self.n)]
        self.num_tuples = 0
        self.num_patch_tuples = 0
        # Insertion order in increasing transformed Y, ties by id (paper §IV-B).
        self.insert_order = np.lexsort((np.arange(self.n), self.space.Y)).astype(_INT)
        self._y_max_rank = self.num_y - 1

    # --- label emission -------------------------------------------------------

    def add_labeled_edge(
        self, u: int, v: int, l: int, r: int, b: int, e: int, *, patch: bool = False
    ) -> None:
        """Add the directed tuple (l, r, v, b, e) to G[u] (ranks)."""
        if l > r or b > e:
            return
        self.adj[u].append(v, l, r, b, e)
        self.num_tuples += 1
        if patch:
            self.num_patch_tuples += 1

    def add_bidirectional(
        self, u: int, v: int, l: int, r: int, b: int, e: int, *, patch: bool = False
    ) -> None:
        self.add_labeled_edge(u, v, l, r, b, e, patch=patch)
        self.add_labeled_edge(v, u, l, r, b, e, patch=patch)

    def add_bidirectional_batch(
        self,
        u: int,
        vs: np.ndarray,
        l,
        r,
        b,
        e,
        *,
        patch: bool = False,
    ) -> np.ndarray:
        """Batch form of :meth:`add_bidirectional`: one vectorized append of
        the forward tuples ``u -> vs`` plus the mirrored reverse tuples.

        ``l``/``r``/``b``/``e`` are scalars or arrays broadcastable against
        ``vs`` (per-edge right boundaries under the MaxLeap policy). Tuples
        with an empty rectangle (``l > r`` or ``b > e``) are dropped, exactly
        as in the scalar path. Returns the neighbor ids actually connected
        (int32), so callers maintaining an incremental broad export fold in
        exactly the edges that exist.
        """
        vs = np.asarray(vs, dtype=_INT).ravel()
        if vs.size == 0:
            return vs
        l_, r_, b_, e_, vs = np.broadcast_arrays(
            np.asarray(l, dtype=_INT),
            np.asarray(r, dtype=_INT),
            np.asarray(b, dtype=_INT),
            np.asarray(e, dtype=_INT),
            vs,
        )
        keep = (l_ <= r_) & (b_ <= e_)
        if not keep.all():
            vs, l_, r_, b_, e_ = vs[keep], l_[keep], r_[keep], b_[keep], e_[keep]
        if vs.size == 0:
            return vs
        self.adj[u].extend(vs, l_, r_, b_, e_)
        for v, li, ri, bi, ei in zip(
            vs.tolist(), l_.tolist(), r_.tolist(), b_.tolist(), e_.tolist()
        ):
            self.adj[v].append(u, li, ri, bi, ei)
        added = 2 * int(vs.size)
        self.num_tuples += added
        if patch:
            self.num_patch_tuples += added
        return vs

    # --- traversal helpers ----------------------------------------------------

    def tuples(self, u: int) -> Tuple[np.ndarray, ...]:
        return self.adj[u].view()

    def active_neighbors(self, u: int, a: int, c: int) -> np.ndarray:
        """Neighbor ids with a tuple active at canonical rank state (a, c)."""
        nbr, l, r, b, e = self.adj[u].view()
        mask = (l <= a) & (a <= r) & (b <= c) & (c <= e)
        return nbr[mask]

    def all_neighbors(self, u: int) -> np.ndarray:
        """Label-ignoring neighbor ids (the broad 'any-state' traversal)."""
        return self.adj[u].nbr[: self.adj[u].size]

    def active_edge_set(self, a: int, c: int) -> set:
        """All active directed edges at state (a, c); for Theorem 1 testing."""
        edges = set()
        for u in range(self.n):
            for v in self.active_neighbors(u, a, c):
                edges.add((u, int(v)))
        return edges

    # --- queries over dominance space ------------------------------------------

    def canonical_rank_state(self, s_q: float, t_q: float) -> Optional[Tuple[int, int]]:
        st = self.space.canonicalize(*self.relation.transform_query(s_q, t_q))
        if st is None:
            return None
        a, c = st
        return (
            int(np.searchsorted(self.space.U_X, a)),
            int(np.searchsorted(self.space.U_Y, c)),
        )

    def valid_mask_rank(self, a: int, c: int) -> np.ndarray:
        return (self.x_rank >= a) & (self.y_rank <= c)

    # --- bookkeeping ------------------------------------------------------------

    def stats(self) -> GraphStats:
        max_deg = max((al.size for al in self.adj), default=0)
        # 4 bytes/id + 4 rank labels x 4 bytes = 20 bytes per tuple, plus the
        # canonical value arrays and entry table (reported without raw vectors,
        # matching the paper's Table IV convention).
        idx_bytes = self.num_tuples * 20 + (self.num_x + self.num_y) * 8 + self.n * 8
        return GraphStats(
            n=self.n,
            num_tuples=self.num_tuples,
            max_degree=max_deg,
            num_patch_tuples=self.num_patch_tuples,
            index_bytes=idx_bytes,
        )

    # --- (de)serialization -------------------------------------------------------

    def to_arrays(self) -> dict:
        """Flatten to CSR-style arrays (for checkpointing and device export)."""
        degs = np.array([al.size for al in self.adj], dtype=np.int64)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(degs, out=indptr[1:])
        total = int(indptr[-1])
        nbr = np.empty(total, dtype=_INT)
        lab = np.empty((total, 4), dtype=_INT)
        for u, al in enumerate(self.adj):
            n0, l, r, b, e = al.view()
            sl = slice(indptr[u], indptr[u + 1])
            nbr[sl] = n0
            lab[sl, 0] = l
            lab[sl, 1] = r
            lab[sl, 2] = b
            lab[sl, 3] = e
        return {
            "vectors": self.vectors,
            "s": self.s,
            "t": self.t,
            "relation": self.relation.name,
            "indptr": indptr,
            "nbr": nbr,
            "labels": lab,
        }

    def save(self, path: str) -> None:
        arrs = self.to_arrays()
        rel = arrs.pop("relation")
        np.savez_compressed(path, relation=np.array(rel), **arrs)

    @staticmethod
    def load(path: str) -> "LabeledGraph":
        z = np.load(path, allow_pickle=False)
        g = LabeledGraph(z["vectors"], z["s"], z["t"], str(z["relation"]))
        indptr, nbr, lab = z["indptr"], z["nbr"], z["labels"]
        for u in range(g.n):
            for k in range(int(indptr[u]), int(indptr[u + 1])):
                g.add_labeled_edge(
                    u, int(nbr[k]), int(lab[k, 0]), int(lab[k, 1]),
                    int(lab[k, 2]), int(lab[k, 3]),
                )
        return g
