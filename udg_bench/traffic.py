"""The one traffic generator: a closed loop of fixed-size batches, read from
a mix's parameters (``traffic/<mix>.json``).

A mix gives ``batch`` (queries a batch), ``selectivities`` (in equal shares
in every batch, the remainder to the first ones), ``distinct_batches`` (how
many distinct batches a run holds), ``cycle`` (which has to be true: the
distinct batches are sent again in turn for as long as the window lasts),
``recall_sample`` (answers judged after the window) and ``trace_batches``
(batches the profiler covers in a ``--trace 1`` run). Everything is drawn from ``--seed``: the query vectors
(from the corpus's own mixture), the intervals (``datagen``'s exact-count
generator), each batch's row order and the judged sample. Every seed gets
the same number of queries at each selectivity in every batch.
"""
from __future__ import annotations

import numpy as np

from udg_bench import datagen

KEYS = {"batch", "selectivities", "distinct_batches", "cycle", "recall_sample",
        "trace_batches", "why"}


def validate(mix: dict) -> dict:
    missing = KEYS - {"why"} - set(mix)
    unknown = set(mix) - KEYS
    if missing or unknown:
        raise ValueError(f"traffic mix: missing {sorted(missing)}, unknown {sorted(unknown)}")
    if mix["distinct_batches"] < 1 or mix["batch"] < 1:
        raise ValueError("traffic mix: no queries")
    if mix["cycle"] is not True:
        raise ValueError("traffic mix: the generator makes closed loops that cycle (cycle: true)")
    return mix


def make_traffic(mix: dict, cfg: dict, s: np.ndarray, t: np.ndarray, seed: int,
                 device="cpu") -> dict:
    """The run's distinct batches: ``q`` [N, d] float32 (drawn on ``device``),
    ``s_q`` / ``t_q`` [N] float64, ``sel`` [N] (index into the mix's
    selectivities), with N = ``distinct_batches`` x ``batch``, batch b in
    rows [b B, (b+1) B)."""
    B, sels, nd = mix["batch"], mix["selectivities"], mix["distinct_batches"]
    rng = np.random.default_rng([seed, 1])
    shares = np.arange(B) % len(sels)
    sel = np.concatenate([rng.permutation(shares) for _ in range(nd)])
    data = cfg["data"]
    centers = datagen.mixture_centers(cfg["dim"], clusters=data["clusters"],
                                      seed=data["data_seed"])
    q_seed = np.random.SeedSequence([seed, 3]).generate_state(1, np.uint64)[0]
    q = datagen.make_query_vectors(nd * B, centers, spread=data["spread"], seed=q_seed,
                                   device=device)
    s_q = np.empty(nd * B)
    t_q = np.empty(nd * B)
    for g, sigma in enumerate(sels):
        rows = np.flatnonzero(sel == g)
        out = datagen.exact_count_queries(s, t, cfg["relation"], sigma, rows.size,
                                          k=cfg["search"]["k"], rng=rng)
        s_q[rows], t_q[rows] = out["s_q"], out["t_q"]
    return {"q": q, "s_q": s_q, "t_q": t_q, "sel": sel}


def batch_rows(mix: dict, i: int) -> slice:
    """Rows of the i-th batch sent (cycling over the distinct ones)."""
    b = i % mix["distinct_batches"]
    return slice(b * mix["batch"], (b + 1) * mix["batch"])


def sample(mix: dict, sent: int, seed: int) -> tuple:
    """The judged sample, drawn from ``--seed`` over every answer of the
    ``sent`` batches: (batch index, row in the batch), each [S]."""
    B = mix["batch"]
    rng = np.random.default_rng([seed, 2])
    total = sent * B
    pick = np.sort(rng.choice(total, size=min(mix["recall_sample"], total), replace=False))
    return pick // B, pick % B
