"""Selectivity-controlled query workloads (paper §VI-A).

The paper selects query intervals "by exact-count selectivity buckets":
the same interval width can produce wildly different valid-set sizes under
different endpoint distributions, so queries are synthesized to hit a target
selectivity sigma directly.

Generation works in dominance space, which makes it relation-independent:
sample a raw x_q, take the valid X-suffix {i | X_i >= x_q}, and set y_q to
the m-th smallest Y in that suffix, m = round(sigma * n). The resulting
(x_q, y_q) selects exactly m objects; ``query_unmap`` converts it back to an
interval (s_q, t_q). Draws violating s_q <= t_q (possible for overlap at
tiny sigma) are rejected and resampled; achieved selectivity is recorded.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.predicates import DominanceSpace, get_relation
from repro_torch.data.synthetic import validate_intervals


@dataclasses.dataclass
class QuerySet:
    relation: str
    vectors: np.ndarray          # [nq, d] query embeddings
    s_q: np.ndarray              # [nq]
    t_q: np.ndarray              # [nq]
    target_selectivity: float
    achieved_selectivity: np.ndarray  # [nq]
    k: int
    gt_ids: np.ndarray | None = None   # [nq, k] exact filtered kNN ids
    gt_dists: np.ndarray | None = None

    @property
    def nq(self) -> int:
        return int(self.s_q.shape[0])


def generate_queries(
    query_vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    relation: str,
    selectivity: float,
    *,
    k: int = 10,
    seed: int = 0,
    max_tries: int = 200,
) -> QuerySet:
    """Synthesize one interval per query vector at the target selectivity."""
    rel = get_relation(relation)
    s, t = validate_intervals(s, t, what="data intervals")
    space = DominanceSpace.from_intervals(rel, s, t)
    n = space.n
    m = max(int(round(selectivity * n)), k)  # paper assumes >= k valid objects
    rng = np.random.default_rng(seed + 104729)
    X, Y = space.X, space.Y
    order = np.argsort(X, kind="stable")
    x_sorted = X[order]
    y_by_x = Y[order]
    hi = n - m
    if hi < 0:
        raise RuntimeError(
            f"selectivity {selectivity} needs m={m} objects but n={n}"
        )

    def attempt(pos: int):
        """Exact-count construction at X-suffix position ``pos`` (or None)."""
        x_q = float(x_sorted[pos])
        # the suffix must start at the first occurrence of x_q (X >= x_q)
        lo = int(np.searchsorted(x_sorted, x_q, side="left"))
        suffix = y_by_x[lo:]
        if suffix.shape[0] < m:
            return None
        y_q = float(np.partition(suffix, m - 1)[m - 1])
        s_q, t_q = rel.untransform_query(x_q, y_q)
        if s_q > t_q:  # not a bona fide interval under this relation/sign
            return None
        cnt = int(np.count_nonzero(rel.valid_mask(s, t, s_q, t_q)))
        if cnt < k:
            return None
        return float(s_q), float(t_q), cnt / n

    # Some relations (e.g. both_before, query_within_data) are only feasible
    # on a sub-range of X positions once the s_q <= t_q coupling is enforced;
    # probe a coarse grid first so per-query sampling never dead-ends.
    grid = np.unique(np.linspace(0, hi, num=min(hi + 1, 128)).astype(np.int64))
    feasible = [int(p) for p in grid if attempt(int(p)) is not None]
    if not feasible:
        raise RuntimeError(
            f"no feasible {relation} query at selectivity {selectivity} "
            f"(n={n}); the interval distribution cannot support this "
            f"relation/selectivity combination"
        )
    step = max(1, (hi + 1) // max(len(grid) - 1, 1))

    s_qs: List[float] = []
    t_qs: List[float] = []
    achieved: List[float] = []
    for _ in range(query_vectors.shape[0]):
        res = None
        for _try in range(max_tries):
            base = feasible[int(rng.integers(0, len(feasible)))]
            pos = int(np.clip(base + rng.integers(-step, step + 1), 0, hi))
            res = attempt(pos)
            if res is not None:
                break
        if res is None:  # grid point itself is guaranteed feasible
            res = attempt(feasible[int(rng.integers(0, len(feasible)))])
        assert res is not None
        s_qs.append(res[0])
        t_qs.append(res[1])
        achieved.append(res[2])
    # rejection sampling guarantees s_q <= t_q per draw; validate the final
    # arrays anyway so a bad relation inverse can never leak degenerate
    # query intervals into benchmarks or serving
    s_arr, t_arr = validate_intervals(
        np.asarray(s_qs), np.asarray(t_qs), what="query intervals"
    )
    return QuerySet(
        relation=relation,
        vectors=np.asarray(query_vectors, dtype=np.float32),
        s_q=s_arr,
        t_q=t_arr,
        target_selectivity=selectivity,
        achieved_selectivity=np.asarray(achieved),
        k=k,
    )


def ground_truth(
    qs: QuerySet,
    vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    *,
    block: int = 1024,
) -> QuerySet:
    """Exact filtered kNN via brute force (the paper's ground-truth rule)."""
    rel = get_relation(qs.relation)
    nq, k = qs.nq, qs.k
    gt_ids = np.full((nq, k), -1, dtype=np.int64)
    gt_d = np.full((nq, k), np.inf, dtype=np.float32)
    vecs = np.asarray(vectors, dtype=np.float32)
    for qi in range(nq):
        mask = rel.valid_mask(s, t, qs.s_q[qi], qs.t_q[qi])
        ids = np.where(mask)[0]
        diff = vecs[ids] - qs.vectors[qi]
        d = np.einsum("ij,ij->i", diff, diff)
        kk = min(k, ids.shape[0])
        sel = np.argpartition(d, kk - 1)[:kk]
        order = sel[np.lexsort((ids[sel], d[sel]))]
        gt_ids[qi, :kk] = ids[order]
        gt_d[qi, :kk] = d[order]
    qs.gt_ids = gt_ids
    qs.gt_dists = gt_d
    return qs


def recall_at_k(result_ids: np.ndarray, qs: QuerySet) -> float:
    """Mean Recall@k against the exact filtered ground truth."""
    assert qs.gt_ids is not None, "call ground_truth() first"
    total = 0.0
    for qi in range(qs.nq):
        gt = set(int(i) for i in qs.gt_ids[qi] if i >= 0)
        got = set(int(i) for i in np.asarray(result_ids[qi]).ravel() if i >= 0)
        if gt:
            total += len(gt & got) / len(gt)
    return total / qs.nq
