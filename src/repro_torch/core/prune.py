"""Algorithm 1: PRUNE — HNSW-style diversity pruning (paper §IV-B).

Deterministic: candidates are scanned in ascending (distance, id) order; a
candidate ``u`` is dominated when an already-kept neighbor ``w`` satisfies
``d(o, w) < d(o, u)`` and ``d(w, u) < d(o, u)`` (strict, as in the paper).
Determinism is what lets Theorem 1 equate UDG's per-state subgraphs with the
dedicated graphs.

Two entry points share the rule:

``prune``              the sequential constructor's form — candidate-to-kept
                       distances are computed on demand, one ``squared_dists``
                       row per kept neighbor;
``prune_precomputed``  the batched constructor's form — the caller supplies
                       the full candidate x candidate squared-distance matrix
                       (one Gram-matrix einsum per pool, amortized over every
                       threshold-sweep round of a wave), so the greedy scan
                       is pure boolean masking with no distance recomputation.

All distances are *squared* L2 in raw embedding space; ids are original
object ids (not ranks).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def squared_dists(vectors: np.ndarray, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Squared L2 from ``q`` to ``vectors[ids]`` (float32 accumulate)."""
    diff = vectors[ids] - q
    return np.einsum("ij,ij->i", diff, diff)


def pool_distance_matrix(vectors: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Symmetric squared-L2 matrix over ``vectors[ids]`` for ``prune_precomputed``.

    Computed via the Gram-matrix identity ``‖a‖² + ‖b‖² − 2·a·b`` (one
    matmul instead of a [P, P, D] diff tensor) and clamped at zero so float
    residue on the diagonal can never flip a strict comparison.
    """
    pv = np.asarray(vectors[ids], dtype=np.float32)
    pn = np.einsum("ij,ij->i", pv, pv)
    dmat = pn[:, None] + pn[None, :] - 2.0 * (pv @ pv.T)
    np.maximum(dmat, 0.0, out=dmat)
    return dmat


def prune(
    vectors: np.ndarray,
    o: int | np.ndarray,
    cand_ids: Sequence[int] | np.ndarray,
    cand_dists: np.ndarray | None,
    M: int,
) -> np.ndarray:
    """Return <=M diversified neighbor ids for object ``o`` (Algorithm 1).

    ``o`` may be a node id or a raw vector (the object being inserted).
    ``cand_dists`` are squared distances from ``o`` to the candidates; if
    None they are computed here.
    """
    cand_ids = np.asarray(cand_ids, dtype=np.int64)
    if cand_ids.size == 0:
        return cand_ids.astype(np.int32)
    o_vec = vectors[o] if np.ndim(o) == 0 else np.asarray(o, dtype=vectors.dtype)
    if cand_dists is None:
        cand_dists = squared_dists(vectors, o_vec, cand_ids)
    # Ascending distance, ties broken by object id (paper line 2).
    order = np.lexsort((cand_ids, cand_dists))
    cand_ids = cand_ids[order]
    cand_dists = cand_dists[order]

    kept: list[int] = []
    kept_dists: list[float] = []
    for u, du in zip(cand_ids, cand_dists):
        if kept:
            w = np.asarray(kept, dtype=np.int64)
            dw = np.asarray(kept_dists)
            wu = squared_dists(vectors, vectors[u], w)
            if np.any((dw < du) & (wu < du)):
                continue
        kept.append(int(u))
        kept_dists.append(float(du))
        if len(kept) >= M:
            break
    return np.asarray(kept, dtype=np.int32)


def diversity_greedy(d_s: np.ndarray, sub: np.ndarray, budget: int) -> list[int]:
    """Algorithm 1 lines 4-9 over a scan-ordered pool, matrix form.

    ``d_s`` are squared distances to the inserted object in scan order;
    ``sub[i, j]`` the squared distance between pool members ``i`` and ``j``.
    ``dom[i, j]`` precomputes "scan-position i dominates j" (the strict
    test), so the greedy skip check "some kept w dominates u" reduces to one
    running boolean OR, updated once per KEPT neighbor (<= budget times)
    instead of per candidate. Returns the kept scan positions. This is the
    single home of the domination rule's matrix form — both the batched
    constructor's sweep (via :func:`prune_precomputed`) and the §V-B patch
    path use it.
    """
    if budget <= 0 or d_s.size == 0:
        return []
    dom = (d_s[:, None] < d_s[None, :]) & (sub < d_s[None, :])
    dominated = np.zeros(d_s.shape[0], dtype=bool)
    kept: list[int] = []
    for j in range(d_s.shape[0]):
        if dominated[j]:
            continue
        kept.append(j)
        if len(kept) >= budget:
            break
        dominated |= dom[j]
    return kept


def prune_precomputed(
    cand_ids: np.ndarray,
    cand_dists: np.ndarray,
    dmat: np.ndarray,
    M: int,
) -> np.ndarray:
    """Algorithm 1 over a pool with precomputed pairwise distances.

    ``cand_dists[i]`` is the squared distance from the inserted object to
    candidate ``i`` and ``dmat[i, j]`` the squared distance between
    candidates ``i`` and ``j`` (see :func:`pool_distance_matrix`). Applies
    the identical ascending-(distance, id) greedy with the identical strict
    domination test as :func:`prune`; the only difference is that no
    distance is computed inside the loop, which is what lets the batched
    constructor reuse one pool matrix across every sweep round of an
    insertion. Returns <=M kept ids (int32).
    """
    cand_ids = np.asarray(cand_ids, dtype=np.int64)
    if cand_ids.size == 0:
        return cand_ids.astype(np.int32)
    order = np.lexsort((cand_ids, cand_dists))
    d_s = np.asarray(cand_dists)[order]
    kept = diversity_greedy(d_s, dmat[np.ix_(order, order)], M)
    return cand_ids[order[kept]].astype(np.int32)
