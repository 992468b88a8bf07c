"""GQA attention (the JAX package's ``models/attention.py``): the chunked
(flash-style online-softmax) prefill path with its sliding-window mask, and
single-token decode against a full KV cache or a ring buffer.

The chunked path loops over KV chunks with a running (max, sum, acc)
accumulator in f32, so peak memory is O(S * chunk) per head. GQA repeats each
KV head over its ``H // KV`` query heads (``repeat_interleave``, as
``jnp.repeat``). The decode paths write the new K/V into the cache tensors in
place and return them: a functional copy would rewrite the whole cache every
token. The values are the reference's.

Under tensor parallelism (``tp``) a rank keeps ``H/model`` query heads (its
``wq`` columns), projects only the KV heads they read, and runs ``wo``
row-parallel with one all-reduce (``head_split``). When the KV heads do not
split over the group (``num_kv_heads % model != 0``: fewer KV heads than
ranks), ``wk``/``wv`` arrive whole and the rank keeps the columns of the KV
heads its query heads read; two ranks may then share one. A decode cache
then holds every KV head (its sequence split over ``model``, gathered for
the step): each rank writes the new token's heads gathered from the group
(``all_kv_heads``) and attends over its own.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed import comm
from repro_torch.distributed.comm import copy_to_model, reduce_from_model
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


def head_split(num_heads: int, num_kv_heads: int, tp=None) -> Tuple[int, int, int, int]:
    """(first query head, query heads, first KV head, KV heads) of this rank:
    its ``H/model`` query heads and the KV heads they read (query head h
    reads KV head ``h // (H/KV)``), in ``repeat_interleave``'s order."""
    size = 1 if tp is None else tp.size
    if num_heads % size:
        raise ValueError(f"{num_heads} query heads do not split over a model group of {size}")
    hl = num_heads // size
    q0 = 0 if tp is None else tp.rank * hl
    rep = num_heads // num_kv_heads
    k0 = q0 // rep
    kvl = (q0 + hl - 1) // rep + 1 - k0
    if hl % kvl or any((q0 + i) // rep - k0 != i // (hl // kvl) for i in range(hl)):
        raise ValueError(f"{num_heads} query heads over {num_kv_heads} KV heads do not split "
                         f"over a model group of {size} in repeat_interleave's order")
    return q0, hl, k0, kvl


def all_kv_heads(t: torch.Tensor, num_heads: int, num_kv_heads: int, tp) -> torch.Tensor:
    """Every KV head [..., KV, hd] from each rank's own [..., kvl, hd] (one
    ``all_gather`` over the model group; a head two ranks share is taken
    from the first)."""
    if tp is None:
        return t
    ranks = comm.all_gather(t.unsqueeze(0), tp.group, tag="tp.kv")
    owner = {}
    for r in range(tp.size):
        _, _, k0, kvl = head_split(num_heads, num_kv_heads, comm.ModelGroup(None, tp.size, r))
        for i in range(kvl):
            owner.setdefault(k0 + i, (r, i))
    return torch.stack([ranks[r].select(-2, i) for r, i in map(owner.get, range(num_kv_heads))],
                       dim=-2)


def _qkv(p, x, positions, num_heads, num_kv_heads, head_dim, rope_theta, tp=None):
    _, hl, k0, kvl = head_split(num_heads, num_kv_heads, tp)
    x = copy_to_model(x, tp)
    wk, wv = p.wk, p.wv
    if wk.shape[-1] != kvl * head_dim:       # whole: keep the KV heads this rank's queries read
        wk = wk[:, k0 * head_dim:(k0 + kvl) * head_dim]
        wv = wv[:, k0 * head_dim:(k0 + kvl) * head_dim]
    q = _split_heads(x @ p.wq, hl, head_dim)
    k = _split_heads(x @ wk, kvl, head_dim)
    v = _split_heads(x @ wv, kvl, head_dim)
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
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention (causal, optional sliding window); also returns
    (k, v) for the cache, k with RoPE applied (this rank's KV heads)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, positions, num_heads, num_kv_heads, head_dim, rope_theta, tp)
    out = _chunked_attn(q, k, v, chunk=min(chunk, S), window=window)
    return reduce_from_model(out.reshape(B, S, q.shape[2] * head_dim) @ p.wo, tp), (k, v)


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


def _write_kv(k_cache, v_cache, slot, k, v, num_heads, num_kv_heads, tp):
    """Writes the new token's K/V into each row's ``slot`` and returns the
    cache's heads this rank attends over. A cache of every KV head (fewer KV
    heads than ranks) takes every head's new entry, gathered from the
    group."""
    _, _, k0, kvl = head_split(num_heads, num_kv_heads, tp)
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    every = k_cache.shape[2] != kvl
    if every:
        k = all_kv_heads(k, num_heads, num_kv_heads, tp)
        v = all_kv_heads(v, num_heads, num_kv_heads, tp)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    if every:
        return k_cache[:, :, k0:k0 + kvl], v_cache[:, :, k0:k0 + kvl]
    return k_cache, v_cache


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
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a KV cache (this rank's KV heads, or every
    head); returns output + the cache."""
    B = x.shape[0]
    S_max = k_cache.shape[1]
    q, k, v = _qkv(p, x, pos[:, None], num_heads, num_kv_heads, head_dim, rope_theta, tp)
    kk, vv = _write_kv(k_cache, v_cache, pos, k, v, num_heads, num_kv_heads, tp)
    kpos = torch.arange(S_max, device=x.device)
    mask = kpos[None, :] <= pos[:, None]                                # [B, S]
    if window is not None:
        mask &= kpos[None, :] > (pos[:, None] - window)
    hl = q.shape[2]
    out = _attend_one(q, kk, vv, mask, hl // kk.shape[2], head_dim, x.dtype)
    return reduce_from_model(out.reshape(B, 1, hl * head_dim) @ p.wo, tp), (k_cache, v_cache)


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
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Sliding-window decode against a ring-buffer cache of size W: local
    layers never attend beyond their window, so they need W slots, not
    S_max."""
    B = x.shape[0]
    W = k_cache.shape[1]
    q, k, v = _qkv(p, x, pos[:, None], num_heads, num_kv_heads, head_dim, rope_theta, tp)
    slot = pos % W
    kk, vv = _write_kv(k_cache, v_cache, slot, k, v, num_heads, num_kv_heads, tp)
    slot_pos[torch.arange(B, device=x.device), slot] = pos.to(slot_pos.dtype)
    mask = (
        (slot_pos >= 0)
        & (slot_pos <= pos[:, None])
        & (slot_pos > pos[:, None] - W)
    )                                                                   # [B, W]
    hl = q.shape[2]
    out = _attend_one(q, kk, vv, mask, hl // kk.shape[2], head_dim, x.dtype)
    return reduce_from_model(out.reshape(B, 1, hl * head_dim) @ p.wo, tp), (k_cache, v_cache, slot_pos)
