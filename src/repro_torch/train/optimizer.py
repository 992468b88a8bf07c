"""AdamW with f32 master weights (the JAX package's ``train/optimizer.py``).

The state mirrors the parameters: ``mu``, ``nu`` and ``master`` are
``{parameter name: f32 tensor}`` dicts in ``named_parameters`` order, one
entry for every leaf (bf16 leaves included), and ``step`` is an int32
tensor. The update runs in f32 whatever the parameters' dtype and writes
each weight back as ``master.to(p.dtype)``.

``params`` is an ``LM`` or a ``{name: tensor}`` dict (a sharded step's
local shards, a toy model's leaves). The update is in place: ``update``
rewrites the moments, the masters, the step and the parameters themselves, where the reference returns new arrays
and donates the old ones (``donate_argnums``). ``torch.optim.AdamW`` is not
this optimizer: it adds eps to ``sqrt(v) / sqrt(1 - b2^t)``, decays the
weights before the step and keeps no f32 master for bf16 leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple

import torch


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params) if isinstance(params, Mapping) else dict(params.named_parameters())


class AdamWState(NamedTuple):
    step: torch.Tensor               # [] int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    master: Dict[str, torch.Tensor]


def cosine_lr(
    base_lr: float, warmup: int, total: int, min_frac: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)

    return schedule


@dataclasses.dataclass(frozen=True)
class adamw:  # noqa: N801 — factory used like a module constant
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def init(self, params) -> AdamWState:
        """Zero moments and f32 copies of ``params`` (an ``LM`` or a
        ``{name: tensor}`` dict), on the parameters' device."""
        named = _named(params)
        dev = next(iter(named.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()},
            nu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()},
            master={n: p.detach().to(torch.float32, copy=True) for n, p in named.items()},
        )

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState, params, *,
               gnorm: torch.Tensor | None = None) -> torch.Tensor:
        """One step from ``grads`` (``{name: gradient}``), in place on
        ``state`` and ``params``; returns the global gradient norm (before
        clipping), an f32 tensor on the device (no host sync). A sharded
        step passes ``gnorm``, the norm of the whole gradient, which its
        local shards cannot give."""
        named = _named(params)
        state.step.add_(1)
        step = state.step
        if gnorm is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                   for g in grads.values()))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = self._lr(step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(self.b1, stepf)
        b2c = 1 - torch.pow(self.b2, stepf)
        for name, p in named.items():
            g = grads[name].to(torch.float32) * scale
            m, v, w = state.mu[name], state.nu[name], state.master[name]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            mh = m / b1c
            vh = v / b2c
            w.sub_(lr * (mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * w))
            p.copy_(w)
        return gnorm
