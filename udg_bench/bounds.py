"""The kernel bound model, copied from ``repro_torch.kernels.bounds`` (the
kernel table of ``PERF.md`` §6), for the NVIDIA H100 SXM (rates from the
NVIDIA H100 Tensor Core GPU data sheet).

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each needed input byte read once, each
output written once) over the HBM rate, and its operations over the peak
rate of their type. Kept here, where later changes to the program cannot
move it, for the per-kernel roofline shares (``<kernel>_roofline``) that
need the program's per-call counts of distinct rows, labels and visited
words; no metric reads it yet.
"""
from __future__ import annotations

import math
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, outside the tensor cores
CMP_OPS_PER_S = 33.5e12       # one compare per FP32 lane per clock


def bound(nbytes: float, nops: float, ops_rate: float) -> Tuple[float, str]:
    """(ms, ``"bytes"`` or ``"operations"``): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def row_bytes(D: int, elt: int, scaled: bool) -> int:
    """One table row with its norm and, for int8 rows, its scale."""
    return D * elt + 4 + (4 if scaled else 0)


def scorer_bytes(*, slots: int, labels: int, label_bytes: int, words: int, rows_read: int,
                 row_bytes: int, queries: int, per_query: int) -> int:
    """A scorer's bytes (B1, B3, B4): every slot's id and output (8), each
    distinct label (``label_bytes``), each distinct visited word (4), each
    distinct row (``row_bytes``), and ``per_query`` bytes of query, state
    and expanded ids a query."""
    return (slots * 8 + labels * label_bytes + words * 4 + rows_read * row_bytes
            + queries * per_query)


def scorer_ops(pairs: int, D: int) -> int:
    """A scorer's operations: 2·D for each distinct (query, row) pair
    scored, on the CUDA cores (``FP32_OPS_PER_S``)."""
    return pairs * 2 * D


def merge_bytes(*, B: int, L: int, C: int, sector_bytes: int, words: int = 0) -> int:
    """B2's bytes: every beam and candidate distance (4 each); the 32-byte
    sectors of candidate ids, beam ids and expanded flags it needs
    (``sector_bytes``); written, ids and d (4 each), exp and keep (1); with
    the visited bits fused, 8 bytes for each word a kept id touches."""
    return B * L * 4 + B * C * 4 + sector_bytes + B * (9 * L + C) + 8 * words


def merge_ops(*, B: int, L: int, C: int, live: int) -> int:
    """B2's compares: ``ceil(log2(L + C))`` for each beam entry and each of
    the ``live`` candidates (``CMP_OPS_PER_S``)."""
    return (B * L + live) * max(1, math.ceil(math.log2(L + C)))
