"""Model assembly (the JAX package's ``models/model.py``): the module tree,
parameter init and the full-sequence forward for every architecture family.

The model is an ``nn.Module`` (``LM``) whose parameters carry the JAX
package's leaf names with the stacked layer axes unrolled into
``nn.ModuleList``s: the reference's ``layers/attn/wq`` of shape [L, D, H*hd]
is ``layers.<l>.attn.wq`` here, and a superblock stack's [G, P, ...] leaf is
``layers.<g>.<p>...`` (gemma3's 5 local + 1 global layers, zamba2's P-1
Mamba2 layers before its one shared attention block, ``shared_attn``).
``convert.params_from_numpy`` maps one onto the other. Families:

  flat (dense / moe / vlm / audio)  L attention blocks
  local_global (gemma3)             G superblocks of P blocks, the last global
  ssm (falcon-mamba)                L Mamba1 blocks
  hybrid (zamba2)                   G superblocks of P-1 Mamba2 blocks, then
                                    the shared attention block
musicgen sums one embedding table per codebook and emits per-codebook logits
from untied heads [K, D, V]; the others tie the unembedding to the table.
Logits are f32 from operands in the model's dtype. The layers run in a
Python loop (the reference's ``lax.scan``; ``cfg.unroll_layers`` gives the
same values there and changes nothing here). ``_maybe_remat`` wraps each
layer block (a superblock for gemma3 and zamba2) where the reference wraps
its scan body: ``cfg.remat`` changes what the backward pass keeps, never a
value.

``tp`` (a ``distributed.comm.ModelGroup``, ``None`` in one process) is the
model group the tensor-parallel step splits each layer's work over
(``layers``, ``attention``, ``moe``): the embedding and the logits over
this rank's rows of the vocabulary (musicgen's ``heads`` per codebook),
attention and MLP blocks column- then row-parallel, MoE layers over this
rank's experts, Mamba blocks over this rank's ``d_inner`` channels (Mamba1)
or heads (Mamba2) (``ssm``). A Mamba block whose channels or heads do not
divide over the group runs whole on every rank (``ssm_group``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.distributed.comm import copy_to_model
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, embed, lookup, matmul_f32, mlp, param,
                                       rmsnorm, unembed)


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn_lib.Attention(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                       dtype, device)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype, device)
        if cfg.is_moe:
            self.moe = moe_lib.MoE(cfg.d_model, cfg.num_experts, cfg.num_shared_experts,
                                   cfg.d_ff_expert, cfg.mlp_type, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype, device)
        if cfg.ssm_kind == "mamba1":
            self.mamba = ssm_lib.Mamba1(cfg.d_model, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_expand,
                                        dtype, device)
        else:
            self.mamba = ssm_lib.Mamba2(cfg.d_model, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_expand,
                                        cfg.ssm_head_dim, dtype, device)


class LM(nn.Module):
    """One architecture's parameters (uninitialised; see ``init_params``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device, cfg.num_codebooks)
        if cfg.num_codebooks > 1:  # musicgen: untied per-codebook heads
            self.heads = param((cfg.num_codebooks, cfg.d_model, cfg.vocab_size), dtype, device)
        G, P = cfg.layer_groups()
        if cfg.family == "ssm":
            self.layers = nn.ModuleList(SSMBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        elif cfg.is_hybrid:
            self.layers = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, dtype, device) for _ in range(P - 1)) for _ in range(G))
            self.shared_attn = AttnBlock(cfg, dtype, device)
        elif cfg.attn_pattern == "local_global":
            self.layers = nn.ModuleList(
                nn.ModuleList(AttnBlock(cfg, dtype, device) for _ in range(P)) for _ in range(G))
        else:  # dense / moe / vlm / audio: a flat stack
            self.layers = nn.ModuleList(AttnBlock(cfg, dtype, device) for _ in range(cfg.num_layers))

    def forward(self, tokens, positions=None):
        return forward(self, self.cfg, tokens, positions)


# --- init ------------------------------------------------------------------------

_DRAW_BLOCK = 1 << 26          # f32 normals drawn at a time: bounds init's peak memory
_SCALES = {"table": 0.02, "router": 0.02, "conv_w": 0.5}


def _normal_(t: torch.Tensor, scale: float, gen: torch.Generator) -> None:
    """Fill ``t`` with N(0, 1) * scale drawn in f32 and cast, in blocks."""
    flat = t.view(-1)
    for i in range(0, flat.numel(), _DRAW_BLOCK):
        n = min(_DRAW_BLOCK, flat.numel() - i)
        draw = torch.randn(n, generator=gen, dtype=torch.float32, device=t.device)
        flat[i:i + n].copy_(draw.mul_(scale))


def _init_leaf(name: str, t: torch.Tensor, gen: torch.Generator) -> None:
    """The reference's init rule for a leaf of this name: norms' ``scale``
    and Mamba's ``D`` ones, biases zero, Mamba1's ``A_log`` log(1..d_state)
    (Mamba2's zero), ``table``/``router`` N * 0.02, ``conv_w`` N * 0.5, and
    every projection N / sqrt(fan_in) with the reference's fan_in (the leaf's
    first axis; the D axis of musicgen's heads)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "D"):
        t.fill_(1.0)
    elif leaf in ("conv_b", "dt_bias"):
        t.zero_()
    elif leaf == "A_log":
        if t.dim() == 2:  # mamba1: [d_inner, d_state]
            ar = torch.arange(1, t.shape[1] + 1, dtype=torch.float32, device=t.device)
            t.copy_(torch.log(ar).expand(t.shape))
        else:
            t.zero_()
    else:
        fan_in = t.shape[1] if name == "heads" else t.shape[0]
        _normal_(t, _SCALES.get(leaf, 1.0 / math.sqrt(fan_in)), gen)


@torch.no_grad()
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """Random parameters drawn on ``device`` (``None``: the card, raising
    without CUDA) from ``torch.Generator(device).manual_seed(seed)``, leaf
    by leaf in module order. Values follow the reference's distributions;
    they are not its values (carry those with ``params_from_numpy``)."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta").to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, t in model.named_parameters():
        _init_leaf(name, t, gen)
    return model


def init_params_shapes(cfg: ModelConfig) -> LM:
    """The model on the ``meta`` device: shapes and dtypes, no allocation."""
    return LM(cfg, device="meta")


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# --- blocks ------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, p, y: torch.Tensor, group: int, batch_mean=None, tp=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP or MoE on the normed input; (out, aux)."""
    if cfg.is_moe and getattr(p, "moe", None) is not None:
        return moe_lib.moe(p.moe, y, num_experts=cfg.num_experts, top_k=cfg.top_k,
                           mlp_type=cfg.mlp_type, capacity_factor=cfg.capacity_factor,
                           group=group, batch_mean=batch_mean, tp=tp)
    return mlp(p.mlp, y, cfg.mlp_type, tp), torch.zeros((), dtype=torch.float32, device=y.device)


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _attn_block_kv(cfg: ModelConfig, p, x, positions, window: Optional[int], batch_mean=None,
                   tp=None):
    """One attention block over the sequence; (x, aux, (k, v)), k and v this
    rank's KV heads."""
    h, kv = attn_lib.attention_with_kv(p.attn, rmsnorm(p.attn_norm, x, cfg.norm_eps), positions,
                                       window=window, chunk=cfg.attn_chunk, tp=tp, **_attn_kw(cfg))
    x = x + h
    out, aux = _ffn(cfg, p, rmsnorm(p.mlp_norm, x, cfg.norm_eps), cfg.moe_group, batch_mean, tp)
    return x + out, aux, kv


def _attn_block(cfg: ModelConfig, p, x, positions, window: Optional[int], batch_mean=None,
                tp=None):
    x, aux, _ = _attn_block_kv(cfg, p, x, positions, window, batch_mean, tp)
    return x, aux


def ssm_splits(cfg: ModelConfig, model: int) -> bool:
    """Whether the Mamba blocks split over a model group of ``model`` ranks:
    Mamba1's ``d_inner`` channels, or Mamba2's heads, divide evenly over it.
    The rule is the shapes'; ``distributed.fsdp.read_policy`` reads the
    blocks' leaves by it."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n = d_inner if cfg.ssm_kind == "mamba1" else d_inner // cfg.ssm_head_dim
    return n % model == 0


def ssm_group(cfg: ModelConfig, tp):
    """``tp`` for the Mamba blocks: the group when they split over it
    (``ssm_splits``), else ``None`` (every rank runs the whole block)."""
    return tp if tp is not None and ssm_splits(cfg, tp.size) else None


def _ssm_block_state(cfg: ModelConfig, p, x, tp=None):
    """One Mamba block over the sequence; (x, decode state of this rank's
    channels or heads)."""
    y = rmsnorm(p.norm, x, cfg.norm_eps)
    tp = ssm_group(cfg, tp)
    if cfg.ssm_kind == "mamba1":
        h, st = ssm_lib.mamba1_with_state(p.mamba, y, d_state=cfg.ssm_state,
                                          expand=cfg.ssm_expand, d_conv=cfg.ssm_conv,
                                          chunk=cfg.ssm_chunk, tp=tp)
    elif cfg.ssm_impl == "ssd":
        h, st = ssm_lib.mamba2_ssd_with_state(p.mamba, y, d_state=cfg.ssm_state,
                                              expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                                              d_conv=cfg.ssm_conv, chunk=min(cfg.ssm_chunk, 64),
                                              tp=tp)
    else:
        h, st = ssm_lib.mamba2_with_state(p.mamba, y, d_state=cfg.ssm_state,
                                          expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                                          d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk, tp=tp)
    return x + h, st


def _ssm_block(cfg: ModelConfig, p, x, tp=None):
    """One Mamba block over the sequence, without a decode state."""
    y = rmsnorm(p.norm, x, cfg.norm_eps)
    kw = dict(d_state=cfg.ssm_state, expand=cfg.ssm_expand, tp=ssm_group(cfg, tp))
    if cfg.ssm_kind == "mamba1":
        return x + ssm_lib.mamba1(p.mamba, y, chunk=cfg.ssm_chunk, **kw)
    if cfg.ssm_impl == "ssd":
        return x + ssm_lib.mamba2_ssd(p.mamba, y, head_dim=cfg.ssm_head_dim,
                                      chunk=min(cfg.ssm_chunk, 64), **kw)
    return x + ssm_lib.mamba2(p.mamba, y, head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, **kw)


# --- remat -------------------------------------------------------------------------

# the 2-D products whose outputs the "dots" policy keeps: every projection
# (``x @ w`` lowers to ``mm``), ``addmm``, and ``matmul_f32``'s f32-out ``mm``
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                         torch.ops.aten.mm.dtype})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` (one layer block) under ``cfg.remat``'s checkpointing:

    * ``"none"``: no checkpointing, the backward keeps every activation;
    * ``"dots"``: selective checkpointing that keeps the outputs of the 2-D
      products (``_SAVED_DOTS``) and recomputes everything else, the
      batched attention einsums (``bmm``) included. This is the nearest
      counterpart of ``dots_with_no_batch_dims_saveable``, and departs from
      it in two ways: the policy sees torch's operators, not XLA's
      ``dot_general`` (a product with batch dimensions is saved there only
      when it has none, here only when it lowers to ``mm``), and what a
      recomputed block keeps alive between its forward and backward is
      torch's choice, not XLA's;
    * anything else (``"full"``): ``torch.utils.checkpoint`` of the whole
      block, which keeps its inputs and recomputes the rest.

    Under tensor parallelism the recomputation runs the block's forward
    collectives again: with ``"dots"`` the row-parallel products' partial
    sums are kept (``mm``), but the ``reduce_from_model`` all-reduce after
    each is not a product and runs again in the backward (two an attention
    layer, and the MoE layer's one; a Mamba1 block's ``out_proj`` and
    ``x_proj`` sums, a Mamba2 block's ``out_proj`` sum), as does
    ``"full"``'s; the backward's own all-reduces (``copy_to_model``'s, the
    ``x_proj`` sum's) run once either way.

    Outside a gradient (under ``no_grad``, or when the block's activation
    input needs none: the serving path, whose parameters need none) ``fn``
    runs as it is. Checkpointing recomputes the same operators on the same
    inputs, so the values and gradients are those of ``"none"``."""
    if cfg.remat == "none":
        return fn

    def block(h, *args):
        if not (torch.is_grad_enabled() and h.requires_grad):
            return fn(h, *args)
        if cfg.remat == "dots":
            return checkpoint(fn, h, *args, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
        return checkpoint(fn, h, *args, use_reentrant=False)

    return block


# --- forward ------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens, tp=None) -> torch.Tensor:
    if cfg.num_codebooks > 1:
        tab = params.embed.table                 # [K, V, D]
        x = lookup(tab[0], tokens[..., 0], tp)
        for k in range(1, cfg.num_codebooks):    # summed in order, in the model's dtype
            x = x + lookup(tab[k], tokens[..., k], tp)
        return x
    return embed(params.embed, tokens, tp)


def _logits(params, cfg: ModelConfig, x, tp=None) -> torch.Tensor:
    """f32 logits over this rank's rows of the vocabulary."""
    if cfg.num_codebooks > 1:
        x = copy_to_model(x, tp)
        return torch.stack([matmul_f32(x, h) for h in params.heads], dim=2)   # [B, S, K, V]
    return unembed(params.embed, x, tp)


def _positions(tokens: torch.Tensor, positions) -> torch.Tensor:
    B, S = tokens.shape[0], tokens.shape[1]
    if positions is None:
        return torch.arange(S, device=tokens.device)[None].expand(B, S)
    return positions


def forward(params, cfg: ModelConfig, tokens, positions=None, *, batch_mean=None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits f32 over this rank's rows of
    the vocabulary, moe aux-loss scalar); ``batch_mean`` goes to every MoE
    layer whose aux loss is summed (``moe.moe``)."""
    positions = _positions(tokens, positions)
    x = _embed_tokens(params, cfg, tokens, tp)
    G, P = cfg.layer_groups()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        body = _maybe_remat(lambda h, lp: _ssm_block(cfg, lp, h, tp), cfg)
        for lp in params.layers:
            x = body(x, lp)
    elif cfg.is_hybrid:
        def hybrid(h, group):
            for lp in group:
                h = _ssm_block(cfg, lp, h, tp)
            return _attn_block(cfg, params.shared_attn, h, positions, None, tp=tp)[0]

        body = _maybe_remat(hybrid, cfg)
        for group in params.layers:
            x = body(x, group)
    elif cfg.attn_pattern == "local_global":
        def local_global(h, group):
            for i, lp in enumerate(group):
                h, _ = _attn_block(cfg, lp, h, positions, cfg.window_size if i < P - 1 else None,
                                   tp=tp)
            return h

        body = _maybe_remat(local_global, cfg)
        for group in params.layers:
            x = body(x, group)
    else:
        body = _maybe_remat(lambda h, lp: _attn_block(cfg, lp, h, positions, None, batch_mean, tp),
                            cfg)
        for lp in params.layers:
            x, a = body(x, lp)
            aux = aux + a
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(params, cfg, x, tp), aux
