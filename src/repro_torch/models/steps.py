"""Train, prefill and decode steps (the JAX package's ``models/steps.py``):

  softmax_xent       mean cross-entropy of f32 logits
  loss_fn            forward + CE loss + the MoE aux loss
  make_train_step    forward + loss + gradients + the optimizer's update
  prefill_step       full-sequence forward that also fills the decode state;
                     returns the last position's logits only
  init_decode_state  a zeroed decode state of length ``s_max``
  decode_step        one token against the decode state (KV cache / SSM state)

The train step updates the parameters and the optimizer state in place and
returns them, where the reference returns new ones and donates the old
(``donate_argnums``). Logits and the loss are f32, as the reference's.

``decode_step`` updates the state's tensors in place and returns the same
dict: a functional copy would rewrite the whole [L, B, S_max, KV, hd] cache
every token. Its values are the reference's.

``prefill_step`` returns a state sized to the prompt. To decode after it, size
a state for prompt + new tokens with ``init_decode_state`` and copy the
prefill state into its first S positions (the SSM leaves whole). A position
at or past the cache length raises ``ValueError`` (one host read of the
positions a step): the reference drops such a write silently and decodes
against a cache without the token.

Each step takes ``tp`` (a ``distributed.comm.ModelGroup``; ``None`` in one
process): logits are then this rank's rows of the vocabulary, the cross
entropy combines the group's max, sum of exponentials and gold logit, and
a decode state holds this rank's KV heads, or every KV head when they do
not split over the group, and the Mamba states of this rank's channels or
heads (Mamba2's ``conv`` whole; ``distributed.fsdp.make_sharded_serve_steps``
keeps the state under ``sharding.cache_specs``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.distributed.comm import max_over_model, reduce_from_model
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.kvcache import init_cache
from repro_torch.models.layers import mlp, rmsnorm
from repro_torch.models.model import (
    _attn_block_kv,
    _attn_kw,
    _embed_tokens,
    _ffn,
    _logits,
    _positions,
    _ssm_block_state,
    forward,
    ssm_group,
)


# --- loss and the train step ---------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, tp=None) -> torch.Tensor:
    """Mean CE; logits [..., V] (computed in f32; with ``tp``, this rank's
    rows [..., V/model] of a vocabulary split over the group), labels [...]
    int. The log-sum-exp is ``torch.logsumexp``'s: the max (over the group),
    then the log of the sum of exponentials (summed over the group) plus
    it; the gold logit comes from the rank that holds its row."""
    logits = logits.float()
    n = logits.shape[-1]
    m = max_over_model(logits.amax(dim=-1), tp)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    sumexp = reduce_from_model(torch.sum(torch.exp(logits - m[..., None]), dim=-1), tp)
    local = labels.long() - (0 if tp is None else tp.rank * n)
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, gold, torch.zeros_like(gold)), tp)
    return torch.mean(torch.log(sumexp) + m - gold)


def loss_fn(params, cfg: ModelConfig, tokens, labels, *, aux_weight: float = 0.01,
            batch_mean=None, tp=None) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(params, cfg, tokens, batch_mean=batch_mean, tp=tp)
    loss = softmax_xent(logits, labels, tp)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux}


def make_train_step(cfg: ModelConfig, optimizer):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``metrics`` the f32 tensors ``loss``, ``aux``, ``total``
    and ``grad_norm`` (no host sync).

    ``params`` is an ``LM``; the step turns its gradients on
    (``requires_grad_(True)``) and updates it and ``opt_state`` in place
    through ``optimizer.update(grads, opt_state, params)`` (the protocol
    of ``repro_torch.train.adamw``). ``batch`` holds ``tokens`` and
    ``labels`` (numpy or tensors), moved to the parameters' device."""

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        dev = next(iter(named.values())).device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        with torch.enable_grad():
            total, metrics = loss_fn(params, cfg, tokens, labels)
            grads = torch.autograd.grad(total, list(named.values()), materialize_grads=True)
        gnorm = optimizer.update(dict(zip(named, grads)), opt_state, params)
        metrics = {name: v.detach() for name, v in metrics.items()}
        return params, opt_state, dict(metrics, total=total.detach(), grad_norm=gnorm)

    return train_step


# --- prefill and decode ----------------------------------------------------------------


def _stack(states):
    """A list of equal-keyed dicts of tensors -> one dict of stacked tensors."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, tokens, positions=None, *, tp=None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Forward + decode-state population. Returns (last logits [B, V*], cache
    of this rank's KV heads)."""
    positions = _positions(tokens, positions)
    x = _embed_tokens(params, cfg, tokens, tp)
    dtype = dtype_of(cfg)
    G, P = cfg.layer_groups()

    def attn_with_cache(p, h, window):
        h, _, (k, v) = _attn_block_kv(cfg, p, h, positions, window, tp=tp)
        return h, {"k": k.to(dtype), "v": v.to(dtype)}

    if cfg.family == "ssm":
        states = []
        for lp in params.layers:
            x, st = _ssm_block_state(cfg, lp, x, tp)
            states.append(st)
        cache = {"ssm": _stack(states)}
    elif cfg.is_hybrid:
        ssm_states, kvs = [], []
        for group in params.layers:
            sts = []
            for lp in group:
                x, st = _ssm_block_state(cfg, lp, x, tp)
                sts.append(st)
            x, kv = attn_with_cache(params.shared_attn, x, None)
            ssm_states.append(_stack(sts))
            kvs.append(kv)
        cache = {"ssm": _stack(ssm_states), "kv": _stack(kvs)}
    elif cfg.attn_pattern == "local_global":
        kvs = []
        for group in params.layers:
            group_kv = []
            for i, lp in enumerate(group):
                x, kv = attn_with_cache(lp, x, cfg.window_size if i < P - 1 else None)
                group_kv.append(kv)
            kvs.append(_stack(group_kv))
        cache = {"kv": _stack(kvs)}
    else:
        kvs = []
        for lp in params.layers:
            x, kv = attn_with_cache(lp, x, None)
            kvs.append(kv)
        cache = {"kv": _stack(kvs)}

    x_last = rmsnorm(params.final_norm, x[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, x_last, tp)[:, 0], cache


def init_decode_state(cfg: ModelConfig, batch: int, s_max: int, *, ring_local: bool = False,
                      device=None) -> Dict:
    """A zeroed decode state on ``device`` (``None``: the card, raising
    without CUDA)."""
    return init_cache(cfg, batch, s_max, dtype_of(cfg), ring_local=ring_local,
                      device=resolve_device(device))


def _check_positions(cache: Dict, pos: torch.Tensor) -> None:
    """Every row's position must lie inside the full-length KV cache."""
    kv = cache.get("kv", cache.get("kv_global"))
    if kv is None or pos.is_meta:  # a pure SSM state has no length; meta has no values
        return
    s_max = kv["k"].shape[-3]
    lo, hi = (int(v) for v in torch.aminmax(pos))
    if lo < 0 or hi >= s_max:
        raise ValueError(
            f"decode positions [{lo}, {hi}] are outside the cache of length {s_max}: size the "
            "state for prompt + new tokens with init_decode_state and copy the prefill cache "
            "into its first positions")


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache: Dict, tokens, pos, *, tp=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens: [B, 1] (or [B, 1, K]); pos: [B] int.

    Returns (logits [B, V*] f32, the cache, updated in place)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long()
    _check_positions(cache, pos)
    x = _embed_tokens(params, cfg, tokens, tp)
    G, P = cfg.layer_groups()
    kw = dict(_attn_kw(cfg), tp=tp)

    def attn_dec(p, h, k_cache, v_cache, window):
        out, _ = attn_lib.decode_attention(p.attn, rmsnorm(p.attn_norm, h, cfg.norm_eps), pos,
                                           k_cache, v_cache, window=window, **kw)
        h = h + out
        out2, _ = _ffn(cfg, p, rmsnorm(p.mlp_norm, h, cfg.norm_eps), min(cfg.moe_group, B), tp=tp)
        return h + out2

    ssm_tp = ssm_group(cfg, tp)

    def ssm_dec(p, h, conv, hstate):
        y = rmsnorm(p.norm, h, cfg.norm_eps)
        st = {"conv": conv, "h": hstate}
        if cfg.ssm_kind == "mamba1":
            out, new = ssm_lib.mamba1_decode(p.mamba, y, st, d_state=cfg.ssm_state,
                                             expand=cfg.ssm_expand, tp=ssm_tp)
        else:
            out, new = ssm_lib.mamba2_decode(p.mamba, y, st, d_state=cfg.ssm_state,
                                             expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                                             tp=ssm_tp)
        conv.copy_(new["conv"])
        hstate.copy_(new["h"])
        return h + out

    if cfg.family == "ssm":
        st = cache["ssm"]
        for i, lp in enumerate(params.layers):
            x = ssm_dec(lp, x, st["conv"][i], st["h"][i])
    elif cfg.is_hybrid:
        st, kv = cache["ssm"], cache["kv"]
        for g, group in enumerate(params.layers):
            for i, lp in enumerate(group):
                x = ssm_dec(lp, x, st["conv"][g, i], st["h"][g, i])
            x = attn_dec(params.shared_attn, x, kv["k"][g], kv["v"][g], None)
    elif cfg.attn_pattern == "local_global" and "kv_local" in cache:
        kvl, kvg = cache["kv_local"], cache["kv_global"]
        for g, group in enumerate(params.layers):
            for i, lp in enumerate(group[:P - 1]):
                out, _ = attn_lib.decode_attention_ring(
                    lp.attn, rmsnorm(lp.attn_norm, x, cfg.norm_eps), pos,
                    kvl["k"][g, i], kvl["v"][g, i], kvl["pos"][g, i], **kw)
                x = x + out
                x = x + mlp(lp.mlp, rmsnorm(lp.mlp_norm, x, cfg.norm_eps), cfg.mlp_type, tp)
            x = attn_dec(group[P - 1], x, kvg["k"][g], kvg["v"][g], None)
    elif cfg.attn_pattern == "local_global":
        kv = cache["kv"]
        for g, group in enumerate(params.layers):
            for i, lp in enumerate(group):
                x = attn_dec(lp, x, kv["k"][g, i], kv["v"][g, i],
                             cfg.window_size if i < P - 1 else None)
    else:
        kv = cache["kv"]
        for i, lp in enumerate(params.layers):
            x = attn_dec(lp, x, kv["k"][i], kv["v"][i], None)

    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(params, cfg, x, tp)[:, 0], cache
