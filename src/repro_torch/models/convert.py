"""Carry the JAX package's parameters into the port's model.

The reference's parameters are a pytree of dicts whose layer leaves are
stacked on leading axes (``layers/attn/wq``: [L, D, H*hd], or [G, P, ...] for
superblock stacks); ``params_from_numpy`` takes that tree with numpy leaves
(``jax.tree_util.tree_map(np.asarray, params)``; bf16 leaves arrive as
``ml_dtypes`` bfloat16 arrays) and returns an ``LM`` whose parameter
``layers.<l>.attn.wq`` (or ``layers.<g>.<p>...``) is that leaf's slice. The
orientation is kept (``x @ w``, ``[in, out]``), so nothing is transposed.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import LM


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16-bit patterns
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _unstack(cfg: ModelConfig, leaves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Split the leading layer axes of every ``layers.*`` leaf."""
    lead = 2 if (cfg.is_hybrid or (cfg.family != "ssm" and cfg.attn_pattern == "local_global")) else 1
    out = {}
    for name, a in leaves.items():
        if not name.startswith("layers."):
            out[name] = a
            continue
        rest = name[len("layers."):]
        for idx in np.ndindex(*a.shape[:lead]):
            out["layers." + ".".join(map(str, idx)) + "." + rest] = a[idx]
    return out


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Mapping, *, device=None) -> LM:
    """The model of ``cfg`` on ``device`` (``None``: the card, raising
    without CUDA) holding the reference's parameters ``tree``. Raises
    ``KeyError`` on a missing or extra leaf and ``ValueError`` on a leaf of
    another shape or dtype."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta")
    want = dict(model.named_parameters())
    got = _unstack(cfg, _flatten(tree))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree of {cfg.name}: missing {missing[:8]}, extra {extra[:8]}")
    for name, a in got.items():
        t = _to_torch(a)
        if tuple(t.shape) != tuple(want[name].shape) or t.dtype != want[name].dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the model has "
                             f"{tuple(want[name].shape)} {want[name].dtype}")
    model = model.to_empty(device=dev)
    params = dict(model.named_parameters())
    for name, a in got.items():
        params[name].copy_(_to_torch(a))
    return model
