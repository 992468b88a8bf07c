"""Brute-force valid-subset scan on the gather-fused kernel.

The planner's ``BRUTE_VALID`` path: the valid ids are enumerated exactly on
the host (``SelectivityEstimator.exact_valid_ids``), padded to a static
capacity with -1, and scored by ``ops.filter_dist_gather`` with all-zero
rectangles and the all-zero state (every tuple passes: the ids are the valid
set by construction). Scoring is the search path's arithmetic, so brute
results merge cleanly with graph results inside one executor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops

INF = float("inf")


def effective_norms(vectors, scales=None, norms=None):
    """Cached ‖row‖² of the rows the kernel scores (dequantized if int8)."""
    if norms is not None:
        return norms.float()
    v32 = vectors.float()
    out = torch.sum(v32 * v32, dim=1)
    if scales is not None:
        out = out * scales * scales
    return out


def brute_topk_impl(
    table: torch.Tensor,     # [n, D] f32 (or int8 with scales)
    norms: torch.Tensor,     # [n] f32 cached ‖row‖²
    q: torch.Tensor,         # [B, D]
    bf_ids: torch.Tensor,    # [B, V] int32 valid ids (-1 padded)
    *,
    k: int,
    scales: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the id lists, return the ascending top-k ``(ids, d)``.

    Distance ties break toward the smaller id (the ground-truth rule of
    ``repro_torch.data.workloads.ground_truth``): a stable sort by id, then
    a stable sort by distance. Every +inf entry has id -1, so padding stays
    after all finite rows."""
    B, V = bf_ids.shape
    n = table.shape[0]
    dev = q.device
    q = q.float()
    labels = torch.zeros((B, V, 4), dtype=torch.int32, device=dev)
    states = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    visited = torch.zeros((B, (n + 31) // 32), dtype=torch.int32, device=dev)
    d = ops.filter_dist_gather(
        table, norms, q, bf_ids, labels, states, visited, scales=scales)
    ids = torch.where(torch.isfinite(d), bf_ids, -1)
    if V < k:  # degenerate capacity: pad out to the requested k
        d = torch.cat([d, torch.full((B, k - V), INF, device=dev)], dim=1)
        ids = torch.cat(
            [ids, torch.full((B, k - V), -1, dtype=ids.dtype, device=dev)], dim=1)
    by_id = torch.sort(ids, dim=1, stable=True).indices
    d, ids = torch.gather(d, 1, by_id), torch.gather(ids, 1, by_id)
    by_d = torch.sort(d + 0.0, dim=1, stable=True).indices[:, :k]
    return torch.gather(ids, 1, by_d), torch.gather(d, 1, by_d)


def brute_force_topk(table, norms, q, bf_ids, *, k: int, scales=None):
    """Standalone brute scan (the planned executor calls
    :func:`brute_topk_impl` itself); the reference's jitted twin."""
    return brute_topk_impl(table, norms, q, bf_ids, k=k, scales=scales)
