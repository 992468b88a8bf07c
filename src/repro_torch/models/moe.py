"""Fine-grained MoE (deepseek-moe / moonshot), the JAX package's
``models/moe.py``: shared + routed experts with GShard-style grouped one-hot
dispatch, exactly as the reference writes it.

Three details carry the reference's semantics where torch differs:

- ``ordered_top_k`` keeps ``lax.top_k``'s order on ties (the lower expert index
  first) by a stable descending sort; ``torch.topk`` promises no tie order,
  and bf16 router logits do tie;
- capacity positions are token-major (a cumulative count over the group's
  ``[g * k]`` choices), kept as floats as in the reference;
- a token whose position reaches the capacity gets a zero row in the
  position one-hot (``jax.nn.one_hot`` of an out-of-range index), so it is
  dropped; ``torch.nn.functional.one_hot`` would raise instead.

The aux loss is a product of two token means. A step that runs on a slice
of the batch (``distributed.fsdp``) passes ``batch_mean`` (through
``loss_fn`` and ``forward``) so that both means are the whole batch's, as
under the reference's GSPMD step; the data-parallel trainer, like the
reference's ``shard_map`` one, keeps each replica's own.

Under expert parallelism (``tp``) every rank of the model group holds the
same tokens (the batch is split over the batch axes only), so each routes
every token as the one-process layer does: the ``router`` is replicated and
the capacity positions and the aux loss come out the same on every rank.
A rank then runs only its ``E/model`` experts (``e_*`` arrive as its slice)
and the shared experts' ``d_ff`` slice, and one all-reduce combines the
ranks' partial outputs; no all-to-all is needed while the tokens are
replicated over ``model``. The routing weights enter the rank's combine
through ``copy_to_model``, so the router's gradient sums every rank's
experts.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.comm import copy_to_model, part, reduce_from_model
from repro_torch.models.layers import activate, param


class MoE(nn.Module):
    def __init__(self, d_model: int, num_experts: int, num_shared: int, d_ff_expert: int,
                 mlp_type: str, dtype, device=None):
        super().__init__()
        self.router = param((d_model, num_experts), dtype, device)
        self.e_in = param((num_experts, d_model, d_ff_expert), dtype, device)
        self.e_out = param((num_experts, d_ff_expert, d_model), dtype, device)
        if mlp_type == "swiglu":
            self.e_gate = param((num_experts, d_model, d_ff_expert), dtype, device)
        if num_shared > 0:
            f = num_shared * d_ff_expert
            self.s_in = param((d_model, f), dtype, device)
            self.s_out = param((f, d_model), dtype, device)
            if mlp_type == "swiglu":
                self.s_gate = param((d_model, f), dtype, device)


def ordered_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, descending, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``x`` over ``n`` classes; a zero row where ``x`` is not
    in ``[0, n)`` (``jax.nn.one_hot``)."""
    return (x[..., None] == torch.arange(n, device=x.device, dtype=x.dtype)).float()


def capacity_positions(idx: torch.Tensor, num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(one-hot of the choices [G, g, k, E], each choice's position in its
    expert's queue [G, g, k] as f32), token-major within each group."""
    G, g, k = idx.shape
    oh = one_hot(idx, num_experts)                                   # [G, g, k, E]
    ohf = oh.reshape(G, g * k, num_experts)
    pos = torch.cumsum(ohf, dim=1) - 1.0                             # [G, g*k, E]
    pos_tok = torch.sum(pos * ohf, dim=-1).reshape(G, g, k)
    return oh, pos_tok


def moe(
    p,
    x: torch.Tensor,            # [B, S, D]
    *,
    num_experts: int,
    top_k: int,
    mlp_type: str,
    capacity_factor: float = 1.25,
    group: int = 256,
    batch_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, D], aux load-balancing loss scalar). The aux
    loss's token means go through ``batch_mean`` when it is given (the mean
    over the ranks that hold the rest of the batch)."""
    B, S, D = x.shape
    T = B * S
    g = min(group, T)
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    G = T // g
    E = num_experts
    cap = max(int(g * top_k * capacity_factor / E), 1)

    xt = x.reshape(G, g, D)
    logits = (xt @ p.router).float()                                 # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = ordered_top_k(probs, top_k)                                    # [G, g, k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)

    oh, pos_tok = capacity_positions(idx, E)
    keep = pos_tok < cap
    # dispatch/combine tensors [G, g, E/model, cap] over this rank's experts
    e0, el = part(tp, E)
    oh_l = oh[..., e0:e0 + el]
    pos_oh = one_hot(pos_tok, cap)                                   # [G, g, k, cap]
    disp = torch.einsum("gske,gskc->gsec", oh_l * keep[..., None], pos_oh)
    comb = torch.einsum("gske,gskc,gsk->gsec", oh_l, pos_oh, copy_to_model(w * keep, tp))

    xe = copy_to_model(xt, tp)
    xin = torch.einsum("gsec,gsd->gecd", disp.to(x.dtype), xe)       # [G, E/model, cap, D]
    h = torch.einsum("gecd,edf->gecf", xin, p.e_in)
    e_gate = getattr(p, "e_gate", None)
    gate_in = torch.einsum("gecd,edf->gecf", xin, e_gate) if e_gate is not None else None
    h = activate(h, mlp_type, gate_in)
    eout = torch.einsum("gecf,efd->gecd", h, p.e_out)
    out = torch.einsum("gsec,gecd->gsd", comb.to(x.dtype), eout)

    if getattr(p, "s_in", None) is not None:  # shared experts, always-on dense path
        hs = xe @ p.s_in
        s_gate = getattr(p, "s_gate", None)
        gs = xe @ s_gate if s_gate is not None else None
        out = out + activate(hs, mlp_type, gs) @ p.s_out
    out = reduce_from_model(out, tp)

    # Switch-style load-balancing auxiliary loss
    me = probs.mean(dim=(0, 1))                                      # mean router prob
    ce = oh.sum(dim=2).mean(dim=(0, 1))                              # token fraction
    if batch_mean is not None:
        me, ce = batch_mean(me), batch_mean(ce)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux

