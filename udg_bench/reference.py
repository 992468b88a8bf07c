"""The plain reference: exact filtered k-nearest neighbours, on the raw data.

It evaluates the relation's predicate on the raw interval endpoints (paper
Table II, ``datagen.RELATIONS``), not through the dominance transform the
program indexes, and computes squared L2 distances over the raw vectors in
float64, in blocks of queries, on whatever device the tensors are on. It
imports nothing of the program and reads nothing the program made.

``precision="tf32"`` is the control: the same search with every dot
product's operands rounded to TF32 (a 10-bit mantissa, as the tensor cores
read float32 under ``allow_tf32``) and accumulated in float32, norms in
float32. The comparison in ``check.py`` has to find its answers wrong.
"""
from __future__ import annotations

import numpy as np
import torch

from udg_bench.datagen import relation


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to the nearest TF32 value (13 low mantissa bits
    cleared, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _distances(q: torch.Tensor, x: torch.Tensor, x_norm: torch.Tensor, precision: str):
    if precision == "exact":
        qd = q.double()
        return (qd * qd).sum(1, keepdim=True) + x_norm[None, :] - 2.0 * (qd @ x.T)
    if precision == "tf32":
        return ((q * q).sum(1, keepdim=True) + x_norm[None, :]
                - 2.0 * (to_tf32(q) @ to_tf32(x).T))
    raise ValueError(f"precision {precision!r}")


class Corpus:
    """The corpus on one device: vectors as the precision needs them, raw
    interval endpoints in float64."""

    def __init__(self, vectors: np.ndarray, s: np.ndarray, t: np.ndarray, relation_name: str,
                 device, precision: str = "exact"):
        self.device = torch.device(device)
        self.precision = precision
        self.rel = relation(relation_name)
        x = torch.as_tensor(vectors, device=self.device)
        if precision == "exact":
            x = x.double()
        self.x = x
        self.x_norm = (x * x).sum(1)
        self.s = torch.as_tensor(s, dtype=torch.float64, device=self.device)
        self.t = torch.as_tensor(t, dtype=torch.float64, device=self.device)
        self.n = int(x.shape[0])

    def valid(self, s_q: torch.Tensor, t_q: torch.Tensor, rows=None) -> torch.Tensor:
        """[Q, n] (or [Q, K] for ``rows`` [Q, K]) raw predicate."""
        if rows is None:
            s, t = self.s[None, :], self.t[None, :]
        else:
            s, t = self.s[rows], self.t[rows]
        return self.rel["valid"](s, t, s_q[:, None], t_q[:, None])

    def topk(self, q: np.ndarray, s_q: np.ndarray, t_q: np.ndarray, k: int, *,
             block: int = 256):
        """Exact filtered top-``k``: ids int64 [Q, k] (-1 past the valid set),
        distances [Q, k] (+inf there), valid counts [Q]. Ties go to the lower
        id."""
        Q = q.shape[0]
        ids = np.full((Q, k), -1, dtype=np.int64)
        dist = np.full((Q, k), np.inf)
        count = np.zeros(Q, dtype=np.int64)
        for lo in range(0, Q, block):
            hi = min(lo + block, Q)
            qb = torch.as_tensor(q[lo:hi], device=self.device)
            sq = torch.as_tensor(s_q[lo:hi], dtype=torch.float64, device=self.device)
            tq = torch.as_tensor(t_q[lo:hi], dtype=torch.float64, device=self.device)
            ok = self.valid(sq, tq)
            d = _distances(qb, self.x, self.x_norm, self.precision)
            d = torch.where(ok, d, torch.full_like(d, float("inf")))
            d_s, order = torch.sort(d, dim=1, stable=True)
            kk = min(k, self.n)
            d_s, order = d_s[:, :kk], order[:, :kk]
            live = torch.isfinite(d_s)
            ids[lo:hi, :kk] = torch.where(live, order, -1).cpu().numpy()
            dist[lo:hi, :kk] = d_s.double().cpu().numpy()
            count[lo:hi] = ok.sum(1).cpu().numpy()
        return ids, dist, count

    def at(self, q: np.ndarray, s_q: np.ndarray, t_q: np.ndarray, ids: np.ndarray, *,
           block: int = 1024):
        """The exact float64 distance of ``q[i]`` to each ``ids[i, j]`` and
        whether that object satisfies the predicate (False for an id outside
        ``[0, n)``): two [Q, K] arrays."""
        ids = np.asarray(ids, dtype=np.int64)
        dist = np.empty(ids.shape)
        valid = np.empty(ids.shape, dtype=bool)
        for lo in range(0, ids.shape[0], block):
            hi = min(lo + block, ids.shape[0])
            ids_t = torch.as_tensor(ids[lo:hi], device=self.device)
            inside = (ids_t >= 0) & (ids_t < self.n)
            rows = ids_t.clamp(0, self.n - 1)
            qd = torch.as_tensor(q[lo:hi], device=self.device).double()
            x = self.x[rows].double()                            # [b, K, D]
            dist[lo:hi] = ((x - qd[:, None, :]) ** 2).sum(-1).cpu().numpy()
            sq = torch.as_tensor(s_q[lo:hi], dtype=torch.float64, device=self.device)
            tq = torch.as_tensor(t_q[lo:hi], dtype=torch.float64, device=self.device)
            valid[lo:hi] = (self.valid(sq, tq, rows=rows) & inside).cpu().numpy()
        return dist, valid
