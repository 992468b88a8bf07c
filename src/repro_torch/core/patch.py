"""Validity-preserving patch edges (paper §V-B).

When the practical constructor's sweep for an inserted object ``v`` stops
early (no broad-pool candidate remains valid), the canonical X thresholds in
``[a_L, a_R] = [a_L, X(v)]`` form an *uncovered range*: the active graph
there may be under-connected. Patch edges repair it:

  * repair pool = previously inserted objects with ``X_u >= a_L`` (valid at
    the start of the range), capped at ``M * K_p`` keeping the longest-lived
    candidates (largest ``X_u``);
  * up to two *lifetime anchors* reserved purely by lifetime rank;
  * remaining slots by ascending distance with HNSW-style diversity pruning;
  * backfill with nearest remaining candidates if fewer than M survive;
  * each edge (v, u) is labeled ``(a_L, min{X_v, X_u, a_R})`` on X and
    ``[Y_v, Y(v_n)]`` on Y, so both endpoints of an active patch edge are
    valid (the same argument as Lemma 2).

Variants implement the Fig. 7 ablation:
  ``none``      NoPatch
  ``previous``  most-recent valid objects, no lifetime/distance logic
  ``lifetime``  lifetime-capped pool + distance diversity, no anchors
  ``full``      UDG-Patch (anchors + lifetime pool + diversity + backfill)
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.prune import diversity_greedy, pool_distance_matrix, squared_dists

PATCH_VARIANTS = ("none", "previous", "lifetime", "full")


def add_patch_edges(
    g: LabeledGraph,
    vj: int,
    a_L: int,
    a_R: int,
    inserted_ids: np.ndarray,
    inserted_x: np.ndarray,
    M: int,
    K_p: int,
    variant: str = "full",
) -> np.ndarray:
    """Emit patch edges for the uncovered range ``[a_L, a_R]`` of node ``vj``
    (paper §V-B).

    ``a_L``/``a_R`` are canonical X *ranks* (indices into ``U_X``), not float
    keys. ``inserted_ids``/``inserted_x`` list previously inserted objects
    and their canonical X ranks *in insertion order* — under the batched
    constructor this includes earlier members of the current wave, so the
    repair pool is identical to the sequential constructor's at the same
    insertion position. Edge labels are emitted in one vectorized batch
    (per-edge right boundary ``min{X_v, X_u, a_R}``). Returns the selected
    patch-neighbor ids (int32, possibly empty) so callers maintaining an
    incremental broad-adjacency export can fold the new edges in.
    """
    empty = np.empty(0, dtype=np.int32)
    if variant == "none":
        return empty
    pool_mask = inserted_x >= a_L
    pool = inserted_ids[pool_mask]
    if pool.size == 0:
        return empty

    if variant == "previous":
        sel = pool[-M:][::-1].tolist()  # most recently inserted, no scoring
    else:
        pool_x = g.x_rank[pool]
        cap = M * K_p
        if pool.size > cap:
            # keep longest-lived candidates (largest X); ties -> most recent
            keep = np.lexsort((-np.arange(pool.size), -pool_x))[:cap]
            pool = pool[keep]
            pool_x = pool_x[keep]
        o_vec = g.vectors[vj]
        dists = squared_dists(g.vectors, o_vec, pool)
        pmat = pool_distance_matrix(g.vectors, pool)

        sel: list[int] = []
        rest_pos = np.arange(pool.size)
        if variant == "full" and pool.size > 0:
            # reserve up to two lifetime anchors by lifetime rank alone
            n_anchor = min(2, pool.size)
            anchor_order = np.lexsort((dists, -pool_x))[:n_anchor]
            sel = [int(pool[i]) for i in anchor_order]
            rest_mask = np.ones(pool.size, dtype=bool)
            rest_mask[anchor_order] = False
            rest_pos = np.flatnonzero(rest_mask)
        order = np.lexsort((pool[rest_pos], dists[rest_pos]))
        rest_pos = rest_pos[order]
        rest_ids = pool[rest_pos]
        budget = M - len(sel)
        metric = diversity_greedy(
            dists[rest_pos], pmat[np.ix_(rest_pos, rest_pos)], budget
        )
        sel.extend(int(rest_ids[j]) for j in metric)
        if len(sel) < M:  # backfill with nearest remaining pool members
            chosen = set(sel)
            for u in rest_ids:
                if len(sel) >= M:
                    break
                if int(u) not in chosen:
                    sel.append(int(u))
                    chosen.add(int(u))

    y_max = g.num_y - 1
    b = int(g.y_rank[vj])
    sel_arr = np.asarray(sel, dtype=np.int32)
    r = np.minimum(np.minimum(int(g.x_rank[vj]), g.x_rank[sel_arr]), a_R)
    g.add_bidirectional_batch(vj, sel_arr, a_L, r, b, y_max, patch=True)
    return sel_arr
