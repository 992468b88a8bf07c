"""Gradient compression for the data-parallel all-reduce: int8 quantization
with error feedback (the JAX package's ``distributed/compression.py``).

The data-parallel trainer (``repro_torch.train.dp_trainer``) optionally
routes gradients through ``compressed_psum``: each leaf, plus the residual
carried from the last step, is quantized to int8 with one scale per leaf
(the scales first MAX-reduced, so every rank dequantizes alike), summed
over the group, dequantized and divided by the group's size; the
quantization error is carried to the next step (error feedback, which
keeps SGD/Adam convergence unaffected to first order).

What the wire carries (ROADMAP C9): the sum runs over ``q`` widened to
int32, as the reference's (``psum(q.astype(jnp.int32))``), so the payload
is 4 bytes an element, the same as f32 and twice the bf16 gradients of a
bf16 model. The reference's docstring claims "8x less ICI traffic than
f32"; neither package has that. The port keeps the int32 sum so that its
results are the reference's.

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import comm


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.to(torch.float32)
    amax = torch.clamp(torch.max(torch.abs(g32)), min=1e-20)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads: Mapping[str, torch.Tensor], residual: Mapping[str, torch.Tensor],
                    group=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """int8 all-reduce with error feedback over ``group`` (``None``: the
    default group).

    grads/residual: ``{name: tensor}`` with the same keys (the residual f32,
    zeros at first). Returns (the means over the group, in each gradient's
    dtype; the new residual, f32). Scales are MAX-reduced first so every
    participant uses the same dequantization factor (required for a
    correct integer sum)."""
    n = dist.get_world_size(group)
    means, resid = {}, {}
    for name, g in grads.items():
        g32 = g.to(torch.float32) + residual[name]
        amax = torch.clamp(torch.max(torch.abs(g32)), min=1e-20)
        comm.all_reduce(amax, group, op="max", tag=name)      # shared scale across replicas
        scale = amax / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        resid[name] = g32 - q * scale                           # error feedback residual
        summed = comm.all_reduce(q.to(torch.int32), group, tag=name)   # i32 on the wire (C9)
        means[name] = (summed.to(torch.float32) * scale / float(n)).to(g.dtype)
    return means, resid


def init_residual(grads_like) -> Dict[str, torch.Tensor]:
    """f32 zeros shaped like each leaf of ``grads_like`` (an ``LM`` or a
    ``{name: tensor}`` dict)."""
    named = grads_like if isinstance(grads_like, Mapping) else dict(grads_like.named_parameters())
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device) for n, g in named.items()}
