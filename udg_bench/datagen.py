"""The benchmark's own data: frozen copies of the corpus generators and a
vectorised exact-count query generator (paper §VI-A).

Nothing here imports the program. The corpus rules are copies of
``repro_torch.data.synthetic.make_vectors`` and ``make_intervals``
(``uniform``: length U(0, 0.01 T), start uniform over the feasible range,
endpoints rounded to float32) and stay frozen here, so a change to the
program cannot change the benchmark's data. Query intervals follow
``repro_torch.data.workloads.generate_queries``: a query at selectivity
sigma selects exactly m = max(round(sigma n), k) objects (more only where
Y values tie), built in dominance space as the m-th smallest Y of the
X-suffix {i | X_i >= x_q}. The original loops over queries in Python; here
one pass over the corpus gives the m-th smallest Y of every suffix, and
each query is then an index into it.
"""
from __future__ import annotations

import heapq

import numpy as np

T_DOMAIN = 1000.0

# Table II: (s, t) -> (X, Y) for data, (s_q, t_q) -> (x_q, y_q) for queries,
# the inverse for queries, and the raw predicate on the interval endpoints.
RELATIONS = {
    "containment": dict(
        data=lambda s, t: (s, t), query=lambda sq, tq: (sq, tq),
        unmap=lambda xq, yq: (xq, yq),
        valid=lambda s, t, sq, tq: (s >= sq) & (t <= tq)),
    "overlap": dict(
        data=lambda s, t: (t, s), query=lambda sq, tq: (sq, tq),
        unmap=lambda xq, yq: (xq, yq),
        valid=lambda s, t, sq, tq: (t >= sq) & (s <= tq)),
    "query_within_data": dict(
        data=lambda s, t: (t, s), query=lambda sq, tq: (tq, sq),
        unmap=lambda xq, yq: (yq, xq),
        valid=lambda s, t, sq, tq: (s <= sq) & (t >= tq)),
    "both_after": dict(
        data=lambda s, t: (s, -t), query=lambda sq, tq: (sq, -tq),
        unmap=lambda xq, yq: (xq, -yq),
        valid=lambda s, t, sq, tq: (s >= sq) & (t >= tq)),
    "both_before": dict(
        data=lambda s, t: (-s, t), query=lambda sq, tq: (-sq, tq),
        unmap=lambda xq, yq: (-xq, yq),
        valid=lambda s, t, sq, tq: (s <= sq) & (t <= tq)),
}


def relation(name: str) -> dict:
    try:
        return RELATIONS[name]
    except KeyError:
        raise ValueError(f"unknown relation {name!r}; known: {sorted(RELATIONS)}") from None


def mixture_centers(dim: int, *, clusters: int, seed: int) -> np.ndarray:
    """The mixture's centers: the first draw of ``make_vectors``' generator."""
    return np.random.default_rng(seed).normal(size=(clusters, dim))


def make_vectors(n: int, dim: int, *, clusters: int, spread: float, seed: int) -> np.ndarray:
    """Gaussian-mixture vectors, float32 [n, dim] (``make_vectors``' rule)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim))
    asg = rng.integers(0, clusters, size=n)
    x = centers[asg] + spread * rng.normal(size=(n, dim))
    return np.ascontiguousarray(x, dtype=np.float32)


def make_query_vectors(nq: int, centers: np.ndarray, *, spread: float, seed: int, device,
                       chunk: int = 16384) -> np.ndarray:
    """Queries drawn from the corpus's own mixture (its centers, fresh
    assignments and noise) by a ``torch.Generator`` on ``device`` seeded
    with ``seed``, ``chunk`` rows a call: float32 [nq, dim] on the host."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    c = torch.as_tensor(centers, dtype=torch.float32, device=device)
    out = np.empty((nq, c.shape[1]), dtype=np.float32)
    for lo in range(0, nq, chunk):
        m = min(chunk, nq - lo)
        asg = torch.randint(0, c.shape[0], (m,), generator=gen, device=device)
        noise = torch.randn((m, c.shape[1]), generator=gen, device=device)
        out[lo:lo + m] = (c[asg] + spread * noise).cpu().numpy()
    return out


def make_intervals(n: int, *, T: float = T_DOMAIN, seed: int) -> tuple:
    """Uniform capped intervals (``make_intervals(distribution="uniform")``):
    float64 (s, t) with float32-representable endpoints and s <= t."""
    rng = np.random.default_rng(seed + 7919)
    ln = rng.uniform(0.0, 0.01 * T, size=n)
    s = rng.uniform(0.0, T - ln)
    t = s + ln
    s = s.astype(np.float32).astype(np.float64)
    t = t.astype(np.float32).astype(np.float64)
    bad = s > t                      # rounding can reorder a near-empty span
    lo = np.minimum(s, t)
    return np.where(bad, lo, s), np.where(bad, lo, t)


def suffix_order_stat(y_by_x: np.ndarray, m: int) -> np.ndarray:
    """``out[lo]`` = the m-th smallest of ``y_by_x[lo:]`` (NaN where the
    suffix holds fewer than m values): one pass from the end with a max-heap
    of the m smallest values seen."""
    n = y_by_x.shape[0]
    out = np.full(n, np.nan)
    heap: list = []                  # negated values: heap[0] is -max
    for lo in range(n - 1, -1, -1):
        v = -float(y_by_x[lo])
        if len(heap) < m:
            heapq.heappush(heap, v)
        elif v > heap[0]:
            heapq.heapreplace(heap, v)
        if len(heap) == m:
            out[lo] = -heap[0]
    return out


def exact_count_queries(s: np.ndarray, t: np.ndarray, relation_name: str, selectivity: float,
                        nq: int, *, k: int, rng: np.random.Generator,
                        max_tries: int = 200) -> dict:
    """``nq`` query intervals at ``selectivity`` under the original's rules:
    a coarse grid of 128 X-suffix positions is probed, each query draws a
    feasible grid point and a jitter of one grid step, and a draw whose
    interval is not a bona fide interval (s_q > t_q) is drawn again, up to
    ``max_tries`` times, then falls back to a feasible grid point.

    Returns ``s_q``, ``t_q`` (float64) and ``pos``, the X-sorted position
    each query was built at."""
    rel = relation(relation_name)
    X, Y = (np.asarray(a, dtype=np.float64) for a in rel["data"](s, t))
    n = X.shape[0]
    m = max(int(round(selectivity * n)), k)
    hi = n - m
    if hi < 0:
        raise ValueError(f"selectivity {selectivity} needs m={m} objects but n={n}")
    order = np.argsort(X, kind="stable")
    x_sorted, y_by_x = X[order], Y[order]
    y_at = suffix_order_stat(y_by_x, m)

    def build(pos):
        x_q = x_sorted[pos]
        lo = np.searchsorted(x_sorted, x_q, side="left")   # first X >= x_q
        y_q = y_at[lo]
        s_q, t_q = rel["unmap"](x_q, y_q)
        ok = ~np.isnan(y_q) & (s_q <= t_q)
        return np.asarray(s_q, dtype=np.float64), np.asarray(t_q, dtype=np.float64), ok

    grid = np.unique(np.linspace(0, hi, num=min(hi + 1, 128)).astype(np.int64))
    feasible = grid[build(grid)[2]]
    if feasible.size == 0:
        raise ValueError(f"no feasible {relation_name} query at selectivity {selectivity} (n={n})")
    step = max(1, (hi + 1) // max(len(grid) - 1, 1))
    pos = np.zeros(nq, dtype=np.int64)
    todo = np.arange(nq)
    for _ in range(max_tries):
        if todo.size == 0:
            break
        base = feasible[rng.integers(0, feasible.size, size=todo.size)]
        p = np.clip(base + rng.integers(-step, step + 1, size=todo.size), 0, hi)
        ok = build(p)[2]
        pos[todo[ok]] = p[ok]
        todo = todo[~ok]
    pos[todo] = feasible[rng.integers(0, feasible.size, size=todo.size)]
    s_q, t_q, ok = build(pos)
    if not np.all(ok):
        raise AssertionError("a query fell outside the feasible positions")
    return {"s_q": s_q, "t_q": t_q, "pos": pos, "m": m}
