"""GQA attention (the JAX package's ``models/attention.py``): the chunked
(flash-style online-softmax) prefill path with its sliding-window mask, and
single-token decode against a full KV cache or a ring buffer.

The chunked path loops over KV chunks with a running (max, sum, acc)
accumulator in f32, so peak memory is O(S * chunk) per head. GQA repeats each
KV head over its ``H // KV`` query heads (``repeat_interleave``, as
``jnp.repeat``). The decode paths write the new K/V into the cache tensors in
place and return them: a functional copy would rewrite the whole cache every
token. The values are the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, param

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int, head_dim: int,
                 dtype, device=None):
        super().__init__()
        self.wq = param((d_model, num_heads * head_dim), dtype, device)
        self.wk = param((d_model, num_kv_heads * head_dim), dtype, device)
        self.wv = param((d_model, num_kv_heads * head_dim), dtype, device)
        self.wo = param((num_heads * head_dim, d_model), dtype, device)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


def _chunked_attn(
    q: torch.Tensor,            # [B, S, H, hd] (rope applied)
    k: torch.Tensor,            # [B, S, KV, hd]
    v: torch.Tensor,            # [B, S, KV, hd]
    *,
    chunk: int,
    window: Optional[int],      # None = full causal; else sliding window
) -> torch.Tensor:
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the attention chunk {chunk}")
    scale = _scale(hd)
    q32 = q.float()
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        kpos = c0 + torch.arange(chunk, device=q.device)
        # scores: [B, H, S, chunk]
        kb = k[:, c0:c0 + chunk].float().repeat_interleave(rep, dim=2)   # [B,chunk,H,hd]
        vb = v[:, c0:c0 + chunk].float().repeat_interleave(rep, dim=2)
        s_blk = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        mask = kpos[None, :] <= qpos[:, None]                            # causal
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        s_blk = torch.where(mask[None, None], s_blk, NEG_INF)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        p = torch.exp(s_blk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]                    # [B, H, S, hd]
    return out.transpose(1, 2).to(q.dtype)                               # [B, S, H, hd]


def _qkv(p, x, positions, num_heads, num_kv_heads, head_dim, rope_theta):
    q = _split_heads(x @ p.wq, num_heads, head_dim)
    k = _split_heads(x @ p.wk, num_kv_heads, head_dim)
    v = _split_heads(x @ p.wv, num_kv_heads, head_dim)
    return apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta), v


def attention_with_kv(
    p,
    x: torch.Tensor,            # [B, S, D]
    positions: torch.Tensor,    # [B, S]
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    chunk: int = 512,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention (causal, optional sliding window); also returns
    (k, v) for the cache, k with RoPE applied."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, positions, num_heads, num_kv_heads, head_dim, rope_theta)
    out = _chunked_attn(q, k, v, chunk=min(chunk, S), window=window)
    return out.reshape(B, S, num_heads * head_dim) @ p.wo, (k, v)


def attention(p, x, positions, **kw) -> torch.Tensor:
    """Training / prefill attention (causal, optional sliding window)."""
    return attention_with_kv(p, x, positions, **kw)[0]


def _attend_one(q, k_cache, v_cache, mask, rep, head_dim, dtype):
    """Softmax attention of one query token over cache slots; mask [B, S]."""
    kk = k_cache.float().repeat_interleave(rep, dim=2)                 # [B,S,H,hd]
    vv = v_cache.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * _scale(head_dim)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vv).to(dtype)             # [B,1,H,hd]


def decode_attention(
    p,
    x: torch.Tensor,            # [B, 1, D] current token activations
    pos: torch.Tensor,          # [B] current position (int64), below S_max
    k_cache: torch.Tensor,      # [B, S_max, KV, hd], written in place
    v_cache: torch.Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a KV cache; returns output + the cache."""
    B = x.shape[0]
    S_max = k_cache.shape[1]
    q, k, v = _qkv(p, x, pos[:, None], num_heads, num_kv_heads, head_dim, rope_theta)
    # write the new kv at each row's position
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v[:, 0].to(v_cache.dtype)
    kpos = torch.arange(S_max, device=x.device)
    mask = kpos[None, :] <= pos[:, None]                                # [B, S]
    if window is not None:
        mask &= kpos[None, :] > (pos[:, None] - window)
    out = _attend_one(q, k_cache, v_cache, mask, num_heads // num_kv_heads, head_dim, x.dtype)
    return out.reshape(B, 1, num_heads * head_dim) @ p.wo, (k_cache, v_cache)


def decode_attention_ring(
    p,
    x: torch.Tensor,            # [B, 1, D]
    pos: torch.Tensor,          # [B]
    k_cache: torch.Tensor,      # [B, W, KV, hd] ring buffer (W = window), in place
    v_cache: torch.Tensor,
    slot_pos: torch.Tensor,     # [B, W] true position per slot (-1 = empty), in place
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Sliding-window decode against a ring-buffer cache of size W: local
    layers never attend beyond their window, so they need W slots, not
    S_max."""
    B = x.shape[0]
    W = k_cache.shape[1]
    q, k, v = _qkv(p, x, pos[:, None], num_heads, num_kv_heads, head_dim, rope_theta)
    bidx = torch.arange(B, device=x.device)
    slot = pos % W
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    slot_pos[bidx, slot] = pos.to(slot_pos.dtype)
    mask = (
        (slot_pos >= 0)
        & (slot_pos <= pos[:, None])
        & (slot_pos > pos[:, None] - W)
    )                                                                   # [B, W]
    out = _attend_one(q, k_cache, v_cache, mask, num_heads // num_kv_heads, head_dim, x.dtype)
    return out.reshape(B, 1, num_heads * head_dim) @ p.wo, (k_cache, v_cache, slot_pos)
