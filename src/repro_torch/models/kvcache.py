"""Decode-state containers (the JAX package's ``models/kvcache.py``): KV
caches and SSM recurrent states, in the reference's stacked layouts and key
names, so a state converts leaf for leaf.

Shapes (S_max = cache length):
  flat attention stacks      kv: [L, B, S_max, KV, hd] x2
  local:global superblocks   kv: [G, P, B, S_max, KV, hd] x2
    with ring_local          kv_local: [G, P-1, B, W, KV, hd] x2 + pos [G, P-1, B, W]
                             kv_global: [G, B, S_max, KV, hd] x2
  hybrid (zamba2)            ssm states [G, P-1, B, ...] + kv [G, B, S_max, KV, hd]
  pure SSM                   ssm states [L, B, ...]
SSM states are f32: ``conv`` [., B, d_conv - 1, C], ``h`` [., B, d_inner,
d_state] (mamba1) or [., B, nheads, head_dim, d_state] (mamba2).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def _kv_pair(shape, dtype, device):
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _ssm_state(cfg: ModelConfig, batch: int, lead: tuple, device):
    d_inner = cfg.ssm_expand * cfg.d_model
    if cfg.ssm_kind == "mamba1":
        conv_c = d_inner
        h_shape = lead + (batch, d_inner, cfg.ssm_state)
    else:
        conv_c = d_inner + 2 * cfg.ssm_state
        nh = d_inner // cfg.ssm_head_dim
        h_shape = lead + (batch, nh, cfg.ssm_head_dim, cfg.ssm_state)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_c), dtype=torch.float32,
                            device=device),
        "h": torch.zeros(h_shape, dtype=torch.float32, device=device),
    }


def init_cache(
    cfg: ModelConfig, batch: int, s_max: int, dtype, *, ring_local: bool = False,
    device=None,
) -> Dict:
    """Zeroed decode state for one model on ``device`` (as given)."""
    G, P = cfg.layer_groups()
    kv_shape = (batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family == "ssm":
        return {"ssm": _ssm_state(cfg, batch, (cfg.num_layers,), device)}
    if cfg.is_hybrid:
        return {
            "ssm": _ssm_state(cfg, batch, (G, P - 1), device),
            "kv": _kv_pair((G,) + kv_shape, dtype, device),
        }
    if cfg.attn_pattern == "local_global":
        if ring_local:
            # P-1 local layers use a ring buffer of the window size; the
            # single global layer keeps the full cache.
            w = min(cfg.window_size, s_max)
            local = _kv_pair((G, P - 1, batch, w, cfg.num_kv_heads, cfg.head_dim), dtype, device)
            local["pos"] = torch.full((G, P - 1, batch, w), -1, dtype=torch.int32, device=device)
            return {"kv_local": local, "kv_global": _kv_pair((G,) + kv_shape, dtype, device)}
        return {"kv": _kv_pair((G, P) + kv_shape, dtype, device)}
    return {"kv": _kv_pair((cfg.num_layers,) + kv_shape, dtype, device)}
