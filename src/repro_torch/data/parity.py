"""The rule by which two result sets for the same queries are held equal.

Two implementations that sum floats in different orders can swap entries
whose distances are (nearly) tied, so ids are compared under a tie rule:

* +inf positions equal;
* finite distances within ``rtol=1e-5, atol=1e-5·max(1, |d|)`` position by
  position (the reference is ``d_ref``);
* ids equal, except where the swapped entries' distances are within
  ``1e-5·max(1, |d|)`` of each other.
"""
from __future__ import annotations

import numpy as np


def tie_tol(d) -> np.ndarray:
    """The absolute tolerance ``1e-5·max(1, |d|)``."""
    return 1e-5 * np.maximum(1.0, np.abs(np.asarray(d, dtype=np.float64)))


def mismatches(ids_ref, d_ref, ids, d) -> list:
    """Descriptions of the rows of ``(ids, d)`` that break the rule against
    ``(ids_ref, d_ref)``; empty when the two agree."""
    ids_ref, ids = np.asarray(ids_ref), np.asarray(ids)
    d_ref = np.asarray(d_ref, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    if ids.shape != ids_ref.shape or d.shape != d_ref.shape:
        return [f"shapes {ids.shape}/{d.shape} vs {ids_ref.shape}/{d_ref.shape}"]
    bad = []
    for i in range(ids_ref.shape[0]):
        fin = np.isfinite(d_ref[i])
        if not np.array_equal(np.isfinite(d[i]), fin):
            bad.append(f"row {i}: +inf positions differ")
            continue
        err = np.abs(d[i][fin] - d_ref[i][fin])
        if np.any(err > tie_tol(d_ref[i][fin]) + 1e-5 * np.abs(d_ref[i][fin])):
            bad.append(f"row {i}: distance off by {err.max():.3g}")
            continue
        for p in np.flatnonzero(ids[i] != ids_ref[i]):
            # each swapped id, where it appears in the other row, must sit
            # at a distance tied with this position's
            for got, row_ids, row_d in ((ids[i, p], ids_ref[i], d_ref[i]),
                                        (ids_ref[i, p], ids[i], d[i])):
                where = np.flatnonzero(row_ids == got)
                if where.size and abs(row_d[where[0]] - row_d[p]) > tie_tol(row_d[p]):
                    bad.append(f"row {i}: id {got} at position {p} is no tie")
    return bad
