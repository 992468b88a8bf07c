"""Batched lockstep UDG search (Alg. 2) — the packed-label, fused branch.

Every query in the batch advances one step per iteration; finished queries
no-op until the whole batch terminates. Per iteration and per query:

  1. select the best ``expand`` (M >= 1) unexpanded beam entries (lower
     beam index first on exact ties, as ``argmin`` / ``lax.top_k`` in the
     reference);
  2. read their padded neighbor ids ``[B, M·E]``;
  3. score them with the packed-label kernel (``ops.filter_dist_gather_packed``):
     label rows read in-kernel, dominance + visited tests, cached-norm
     distance ``‖c‖² − 2·q·c + ‖q‖²``, +inf where masked;
  4. dedup + top-L merge with ``ops.beam_merge``;
  5. set the kept candidates' bits in the ``[B, ceil(n/32)]`` int32 visited
     bitmap with ``scatter_add_`` (kept candidates are deduped and
     unvisited, so each bit lands at most once: an add of distinct bits is
     an or, in any order, and ``1 << 31`` wraps to the right int32 bit
     pattern).

The reference runs this body in an on-device ``lax.while_loop`` whose
condition is "some row still has an unexpanded finite beam entry". Here
that test is a host sync, so the body runs in blocks of ``block``
iterations between tests, never more than ``max_iters`` in total. An
iteration after a row has finished is a no-op for it (no live entry → all
neighbor ids -1 → all-inf candidates → unchanged beam, no bitmap bits), so
results do not depend on ``block``. ``LOOP_STATS`` counts the tests (host
syncs) and iterations.

Not ported yet (ROADMAP A): the int32-label fused branch, ``fused=False``,
``stats=True`` and the broad (label-ignoring) search of the constructor.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.predicates import get_relation
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.search.device_graph import DeviceGraph

INF = float("inf")
LOOP_BLOCK = 8          # iterations between two "any row active" tests
LOOP_STATS = {"syncs": 0, "iterations": 0}


def prepare_states_extended(
    dg: DeviceGraph, s_q: np.ndarray, t_q: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map + canonicalize a batch of query intervals (Lemma 1, vectorized).

    Returns (states [B, 2] int32 rank pairs, ep [B] int32 entry ids; ep=-1
    marks an empty valid set / no entry, invalid [B] bool — True where
    canonicalization itself failed, i.e. the valid set is provably empty
    and the clipped state rows are meaningless)."""
    rel = get_relation(dg.relation)
    s_q = np.asarray(s_q, dtype=np.float64)
    t_q = np.asarray(t_q, dtype=np.float64)
    x_q, y_q = rel.query_map(s_q, t_q)
    a = np.searchsorted(dg.U_X, x_q, side="left")
    c = np.searchsorted(dg.U_Y, y_q, side="right") - 1
    num_x = dg.U_X.shape[0]
    invalid = (a >= num_x) | (c < 0)
    a_cl = np.clip(a, 0, max(num_x - 1, 0))
    ep = dg.entry_node[a_cl].astype(np.int64)
    ep_y = dg.entry_y_rank[a_cl].astype(np.int64)
    ep = np.where(invalid | (ep < 0) | (ep_y > c), -1, ep)
    states = np.stack([a_cl, np.maximum(c, 0)], axis=1).astype(np.int32)
    return states, ep.astype(np.int32), invalid


def prepare_states(
    dg: DeviceGraph, s_q: np.ndarray, t_q: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-tuple form of :func:`prepare_states_extended`."""
    states, ep, _ = prepare_states_extended(dg, s_q, t_q)
    return states, ep


def search_core(
    table: torch.Tensor,    # [n, D] f32 (or int8 with scales)
    nbr: torch.Tensor,      # [n, E] int32
    plabels: torch.Tensor,  # [n, E, 2] int32 packed label words
    q: torch.Tensor,        # [B, D] f32
    states: torch.Tensor,   # [B, 2] int32
    ep: torch.Tensor,       # [B] int32 (-1 = no entry: the row does nothing)
    *,
    k: int,
    beam: int,
    max_iters: int,
    expand: int = 1,
    norms: torch.Tensor,    # [n] f32 cached ‖c‖² of the scored rows
    scales: torch.Tensor | None = None,   # [n] f32: int8-quantized table
    block: int = LOOP_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed fused search loop on whatever device the tensors lie on.
    Returns (ids [B, k] int32, squared distances [B, k] f32), ascending."""
    if plabels.shape[-1] != 2:
        raise NotImplementedError(
            "the int32-label search branch is not ported yet (ROADMAP A)")
    if not 1 <= expand <= beam:
        raise ValueError(f"expand={expand} must be in [1, beam={beam}]")
    n = table.shape[0]
    B = q.shape[0]
    E = nbr.shape[1]
    L, M = beam, expand
    dev = q.device
    q = q.float()

    has_ep = ep >= 0
    ep_safe = torch.where(has_ep, ep, torch.zeros_like(ep)).long()
    row = table[ep_safe].float()
    if scales is not None:
        row = row * scales[ep_safe][:, None]
    # summed in f64 and rounded once, so the card and the CPU agree to the bit
    d_ep = torch.sum((q - row).double() ** 2, dim=-1).float()

    beam_ids = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    beam_d = torch.full((B, L), INF, dtype=torch.float32, device=dev)
    beam_exp = torch.zeros((B, L), dtype=torch.bool, device=dev)
    beam_ids[:, 0] = torch.where(has_ep, ep, -1)
    beam_d[:, 0] = torch.where(has_ep, d_ep, INF)
    visited = torch.zeros((B, (n + 31) // 32), dtype=torch.int32, device=dev)
    ep_bit = torch.where(has_ep, 1 << (ep_safe & 31), 0).to(torch.int32)
    visited.scatter_add_(1, (ep_safe >> 5)[:, None], ep_bit[:, None])

    def body(beam_ids, beam_d, beam_exp, visited):
        # 1. best M unexpanded entries per query
        cand_d = torch.where(beam_exp, INF, beam_d)
        if M == 1:
            j = torch.argmin(cand_d, dim=1, keepdim=True)          # [B, 1]
        else:
            j = torch.sort(cand_d, dim=1, stable=True).indices[:, :M]
        live = torch.gather(cand_d, 1, j) < INF                      # [B, M]
        cur = torch.gather(beam_ids, 1, j)
        cur_safe = torch.where(live, cur, 0)
        beam_exp = beam_exp.scatter(1, j, torch.gather(beam_exp, 1, j) | live)
        # 2. neighbor ids of the expanded nodes
        nb = torch.where(live[:, :, None], nbr[cur_safe.long()], -1)
        nb = nb.reshape(B, M * E)
        # 3. packed-label scorer
        d_new = ops.filter_dist_gather_packed(
            table, plabels, norms, q, cur_safe, nb, states, visited,
            scales=scales,
        )
        # 4. dedup + top-L merge; keep = deduped survivors in nb order
        beam_ids, beam_d, beam_exp, keep = ops.beam_merge(
            beam_d, beam_ids, beam_exp, d_new, nb, n=n)
        # 5. visited bitmap: scatter-add of distinct bits == scatter-or
        ids_safe = nb.clamp(0, n - 1).long()
        bits = torch.where(keep, 1 << (ids_safe & 31), 0).to(torch.int32)
        visited.scatter_add_(1, ids_safe >> 5, bits)
        return beam_ids, beam_d, beam_exp, visited

    it = 0
    while it < max_iters:
        LOOP_STATS["syncs"] += 1
        if not bool(torch.any(~beam_exp & torch.isfinite(beam_d))):
            break
        for _ in range(min(block, max_iters - it)):
            beam_ids, beam_d, beam_exp, visited = body(
                beam_ids, beam_d, beam_exp, visited)
            it += 1
    LOOP_STATS["iterations"] += it
    return beam_ids[:, :k], beam_d[:, :k]


def batched_udg_search(
    dg: DeviceGraph,
    q: np.ndarray,
    s_q: np.ndarray,
    t_q: np.ndarray,
    *,
    k: int = 10,
    beam: int = 64,
    max_iters: int | None = None,
    expand: int = 1,
    plan: str = "graph",
    device=None,
    block: int = LOOP_BLOCK,
) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end batched query: canonicalize on the host, search on
    ``device`` (``None`` = the card) over the graph's memoized device
    bundle. ``plan="graph"`` is the pure beam search; ``"auto"`` /
    ``"wide"`` / ``"brute"`` route through ``repro_torch.exec.execute_batch``.
    Returns numpy ``(ids [B, k], dists [B, k])``."""
    if plan != "graph":
        from repro_torch.exec.executor import execute_batch

        return execute_batch(
            dg, q, s_q, t_q, k=k, beam=beam, max_iters=max_iters,
            expand=expand, plan=plan, device=device, block=block,
        )
    dev = resolve_device(device)
    states, ep = prepare_states(dg, s_q, t_q)
    labels = dg.serving_labels(device=dev)
    di = dg.device(dev)
    ids, d = search_core(
        di.table, di.nbr, labels,
        torch.as_tensor(np.asarray(q, dtype=np.float32), device=dev),
        torch.as_tensor(states, device=dev), torch.as_tensor(ep, device=dev),
        k=k, beam=beam,
        max_iters=max_iters if max_iters is not None else 2 * beam,
        expand=expand, norms=di.norms, scales=di.scales, block=block,
    )
    return ids.cpu().numpy(), d.cpu().numpy()
