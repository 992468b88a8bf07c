"""Shared transformer layers: RMSNorm, RoPE, MLP variants, embeddings
(the JAX package's ``models/layers.py``).

Each layer is an ``nn.Module`` that owns its parameters under the JAX
package's leaf names (``scale``, ``w_in``, ``table``, ...), and a plain
function over that module and tensors computes it (``rmsnorm(p, x)``,
``mlp(p, x, mlp_type)``); it reads the leaves as attributes, so any object
with attributes of those names will do. Weights keep the reference's orientation: a projection is
``x @ w`` with ``w`` of shape ``[in, out]``. Modules allocate their
parameters uninitialised (``torch.empty``, usually on the ``meta`` device);
``model.init_params`` draws them and ``convert.params_from_numpy`` carries
the reference's across.

Under tensor parallelism (``tp``, a ``distributed.comm.ModelGroup``) each
rank holds its ``model`` slice of a leaf and the layers run Megatron's
split: the MLP's ``w_in``/``w_gate`` column-parallel and ``w_out``
row-parallel with one all-reduce, and the embedding and tied unembedding
over the rank's rows of the vocabulary (``tp=None``: one process, the whole
leaf, no collective).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.comm import copy_to_model, reduce_from_model


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter, without gradients by default: serving
    builds no graph (a forward outside ``no_grad`` keeps none either).
    Training turns them on (``LM.requires_grad_(True)``, done by
    ``steps.make_train_step``'s step)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` with a backward (torch has no
    derivative for the f32-out product): the f32 cotangent is rounded to
    the operands' dtype and both products run on the tensor cores with f32
    sums, their results in the operands' dtype (the precision the
    parameters' gradients are kept in)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        gx = torch.mm(g, w.T) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x2.T, g) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` [..., K] x [K, N] with the products summed in f32 and f32
    out, whatever the operands' dtype: the reference's
    ``preferred_element_type=jnp.float32`` (a bf16 ``torch.matmul`` would
    round its output to bf16). On the card a bf16 product is one cuBLAS call
    with an f32 output (``_MatmulF32`` when a gradient is needed), and so is
    a ``meta`` tensor's (the dry-run counts the card's path); elsewhere
    the operands are widened to f32 first (exact), which on the card would
    copy the whole table a call."""
    if (x.is_cuda or x.is_meta) and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _MatmulF32.apply(x2, w)
        else:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[-1],))
    return torch.matmul(x.float(), w.float())


# --- RMSNorm -------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = param((d,), dtype, device)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


# --- RoPE ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]. Split halves."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                         # [hd/2]
    ang = positions[..., :, None].to(torch.float32) * freqs         # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                              # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- MLP variants ---------------------------------------------------------------

MLP_TYPES = ("swiglu", "squared_relu", "gelu")


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, mlp_type: str, dtype, device=None):
        super().__init__()
        self.w_in = param((d_model, d_ff), dtype, device)
        self.w_out = param((d_ff, d_model), dtype, device)
        if mlp_type == "swiglu":
            self.w_gate = param((d_model, d_ff), dtype, device)


def activate(h: torch.Tensor, mlp_type: str, gate_in=None) -> torch.Tensor:
    """The MLP's nonlinearity on ``h = x @ w_in`` (``gate_in = x @ w_gate``
    for swiglu). ``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s
    default."""
    if mlp_type == "swiglu":
        return F.silu(gate_in) * h
    if mlp_type == "squared_relu":  # nemotron-4
        return torch.square(F.relu(h))
    if mlp_type == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown mlp_type {mlp_type}")


def mlp(p, x: torch.Tensor, mlp_type: str, tp=None) -> torch.Tensor:
    """``w_in``/``w_gate`` [D, F/model] and ``w_out`` [F/model, D]: the
    activation acts on this rank's slice of ``d_ff``, and the row-parallel
    products' partial sums combine in one all-reduce."""
    x = copy_to_model(x, tp)
    h = x @ p.w_in
    gate_in = x @ p.w_gate if mlp_type == "swiglu" else None
    return reduce_from_model(activate(h, mlp_type, gate_in) @ p.w_out, tp)


# --- Embedding / unembedding ------------------------------------------------------


class Embedding(nn.Module):
    """``table``: [V, D], or [K, V, D] for K codebooks (musicgen)."""

    def __init__(self, vocab: int, d_model: int, dtype, device=None, codebooks: int = 1):
        super().__init__()
        shape = (vocab, d_model) if codebooks == 1 else (codebooks, vocab, d_model)
        self.table = param(shape, dtype, device)


def lookup(table: torch.Tensor, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """Rows ``ids`` of a vocabulary split over the model group: each rank
    looks up the ids among its rows [V/model, D], writes zeros for the rest,
    and one all-reduce combines them (exact: one rank's row and zeros).
    Without a group it is ``table[ids]``, which raises on an id outside
    [0, V); in a group an id outside every rank's rows reads zeros."""
    if tp is None:
        return table[ids]
    n = table.shape[0]
    local = ids.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, rows.new_zeros(())), tp)


def embed(p, ids: torch.Tensor, tp=None) -> torch.Tensor:
    return lookup(p.table, ids, tp)


def unembed(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Tied unembedding: [., D] @ [D, V/model] -> f32 logits over this
    rank's rows of the vocabulary."""
    return matmul_f32(copy_to_model(x, tp), p.table.T)
