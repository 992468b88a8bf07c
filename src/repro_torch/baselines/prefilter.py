"""PreFilter baseline: exact valid-set enumeration + brute-force scan.

A thin wrapper over the execution layer (``repro_torch.exec``), as in the
JAX package: the valid set is enumerated exactly by the planner's
rank-space estimator (``SelectivityEstimator.exact_valid_ids`` — the same
small-count fallback the ``BRUTE_VALID`` plan uses, correct at any count).
The paper builds a range tree for enumeration; the bucketed CSR over rank
space plays that role here with O(G log + |V|) per-query enumeration,
which keeps the baseline honest.

Scoring stays the plain host diff-square scan: it is *bit-identical* to
the ground-truth rule (``repro_torch.data.workloads.ground_truth``), which
is what makes this the exact-by-construction frontier point of the
paper's figures. The kernel-scored twin of this scan — cached-norm
arithmetic matching the graph search paths, with its f32 residue on
near-ties — is ``repro_torch.exec.bruteforce`` and is what serving's
``BRUTE_VALID`` plan runs (B3 on the card).
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from repro_torch.core.predicates import DominanceSpace, get_relation
from repro_torch.exec.estimator import SelectivityEstimator


class PreFilter:
    name = "prefilter"

    def __init__(self) -> None:
        pass

    def build(self, vectors: np.ndarray, s: np.ndarray, t: np.ndarray, relation: str):
        t0 = time.perf_counter()
        self.rel = get_relation(relation)
        self.space = DominanceSpace.from_intervals(self.rel, s, t)
        # rank-space CSR + histogram: the enumeration structure (the
        # analogue of the paper's range tree)
        self.est = SelectivityEstimator.from_space(self.space)
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.build_seconds = time.perf_counter() - t0
        self.index_bytes = self.est.nbytes()

    def search(
        self, q: np.ndarray, s_q: float, t_q: float, k: int, ef: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        state = self.space.canonicalize(*self.rel.transform_query(s_q, t_q))
        if state is None:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        a = int(np.searchsorted(self.space.U_X, state[0]))
        c = int(np.searchsorted(self.space.U_Y, state[1]))
        # ascending ids so exact-tie stable sorting reproduces the
        # ground-truth smaller-id rule (CSR enumeration order is bucketed)
        ids = np.sort(self.est.exact_valid_ids(a, c))
        if ids.size == 0:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        diff = self.vectors[ids] - np.asarray(q, dtype=np.float32)
        d = np.einsum("ij,ij->i", diff, diff)
        kk = min(k, ids.size)
        sel = np.argpartition(d, kk - 1)[:kk]
        order = sel[np.argsort(d[sel], kind="stable")]
        return ids[order].astype(np.int32), d[order].astype(np.float32)
