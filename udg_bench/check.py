"""The comparison that decides ``correct``.

The judged answers are ids and distances, ``[S, k]`` each, of a sample of
the queries a run answered. The reference (``reference.Corpus``) gives each
sampled query's exact filtered top-k and valid count, and for each answered
id its exact distance and whether it satisfies the predicate. Three numbers
are compared, each against the cell's limit (``limits/<cell>.json``):

* ``dist_err``: the largest gap between an answered distance and the exact
  distance of the answered id, over ``max(exact, 1)`` (distances here are
  tens to hundreds). The program's scorers compute float32 distances to
  about 1e-6 of the exact ones; a scorer in a lower precision lands far
  above, and an answer altered after it was scored does not match its id.
* ``bad_slots``: answered slots that are wrong on their face: an id that
  does not satisfy the predicate or lies outside the corpus, an id twice in
  a row, a distance below the slot before it, a finite distance without an
  id or an id without one, or an empty slot while the valid set holds more
  objects than the slots before it. An exact count: the limit is 0.

* ``recall``: the mean recall@k of the sample against the exact filtered
  top-k (the ``recall_at_10`` metric), held to a floor. The program is an
  approximate search, so the floor lies well below what sound runs read;
  it is there for what the other two cannot see: a search loop cut short,
  rows routed to the wrong strategy, candidates dropped before the merge.
  Each of these answers real, valid, well-ordered ids at their own
  distances, only worse ones.
"""
from __future__ import annotations

import numpy as np

# each compared number and how it is held: "max" (at most the limit) or
# "min" (at least the limit)
NUMBERS = {"dist_err": "max", "bad_slots": "max", "recall": "min"}


def readings(ids: np.ndarray, dist: np.ndarray, exact_ids: np.ndarray, count: np.ndarray,
             d_at: np.ndarray, valid_at: np.ndarray) -> dict:
    """The compared numbers and the recall of the answers (``ids``, ``dist``)
    against the reference's (``exact_ids``, ``count``, and ``d_at`` /
    ``valid_at`` of the answered ids, from ``Corpus.at``)."""
    ids = np.asarray(ids, dtype=np.int64)
    dist = np.asarray(dist, dtype=np.float64)
    S, k = ids.shape
    has_id = ids >= 0
    finite = np.isfinite(dist)
    err = np.where(has_id & finite & valid_at,
                   np.abs(dist - d_at) / np.maximum(d_at, 1.0), 0.0)
    srt = np.sort(np.where(has_id, ids, -1 - np.arange(k)[None, :]), axis=1)
    dup = np.zeros_like(has_id)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    slot = np.arange(k)[None, :]
    bad = (has_id & ~valid_at) | (has_id != finite) | (~has_id & (count[:, None] > slot))
    bad[:, 1:] |= finite[:, 1:] & finite[:, :-1] & (dist[:, 1:] < dist[:, :-1])
    gt = np.where(exact_ids >= 0, exact_ids, -2)
    hits = (ids[:, :, None] == gt[:, None, :]).any(1).sum(1)
    due = np.minimum(count, k)
    recall = np.where(due > 0, hits / np.maximum(due, 1), 1.0)
    return {"dist_err": float(err.max()) if err.size else 0.0,
            "bad_slots": int(bad.sum() + dup.sum()),
            "recall": float(recall.mean()), "sampled": int(S)}


def passes(name: str, value: float, limit: float) -> bool:
    return value <= limit if NUMBERS[name] == "max" else value >= limit


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each compared number beside its limit and how it
    is held ("max" or "min"), in ``NUMBERS`` order; correct when each is on
    the right side of its limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name], "held": held}
              for name, held in NUMBERS.items()}
    return all(passes(n, c["value"], c["limit"]) for n, c in checks.items()), checks


def judge_answers(corpus, q: np.ndarray, s_q: np.ndarray, t_q: np.ndarray, ids: np.ndarray,
                  dist: np.ndarray, k: int) -> dict:
    """Run the reference on the sampled queries and read the answers."""
    exact_ids, _, count = corpus.topk(q, s_q, t_q, k)
    d_at, valid_at = corpus.at(q, s_q, t_q, ids)
    return readings(ids, dist, exact_ids, count, d_at, valid_at)
