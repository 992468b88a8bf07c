"""Carry the JAX package's parameters into the port's model.

The reference's parameters are a pytree of dicts whose layer leaves are
stacked on leading axes (``layers/attn/wq``: [L, D, H*hd], or [G, P, ...] for
superblock stacks); ``params_from_numpy`` takes that tree with numpy leaves
(``jax.tree_util.tree_map(np.asarray, params)``; bf16 leaves arrive as
``ml_dtypes`` bfloat16 arrays) and returns an ``LM`` whose parameter
``layers.<l>.attn.wq`` (or ``layers.<g>.<p>...``) is that leaf's slice. The
orientation is kept (``x @ w``, ``[in, out]``), so nothing is transposed.
``params_to_numpy`` is its inverse: it restacks the layers into the
reference's ``[L, ...]`` or ``[G, P, ...]`` leaves (``stack_index`` and
``stack_rows``, which the checkpoint uses for the optimizer's moments too).
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


def stack_index(name: str):
    """A parameter name's nested key path in the reference's tree and its
    layer index: ``layers.3.attn.wq`` -> (("layers", "attn", "wq"), (3,)),
    ``layers.0.2.norm.scale`` -> (("layers", "norm", "scale"), (0, 2)),
    ``embed.table`` -> (("embed", "table"), ())."""
    parts = name.split(".")
    return (tuple(c for c in parts if not c.isdigit()),
            tuple(int(c) for c in parts if c.isdigit()))


def stack_rows(rows: Mapping[tuple, np.ndarray], what: str) -> np.ndarray:
    """One array from ``{layer index: array}``: the whole leaf for the
    single index (), else the layers stacked on their leading axes."""
    if list(rows) == [()]:
        return rows[()]
    lead = tuple(max(i[d] for i in rows) + 1 for d in range(len(next(iter(rows)))))
    if len(rows) != int(np.prod(lead)):
        raise ValueError(f"{what}: layer stack {sorted(rows)} is not complete")
    first = next(iter(rows.values()))
    out = np.empty(lead + first.shape, first.dtype)
    for i, a in rows.items():
        out[i] = a
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:   # the 16-bit patterns as an ml_dtypes array
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(model: LM) -> Dict:
    """The reference's parameter tree (numpy leaves, the layers stacked
    into ``[L, ...]`` / ``[G, P, ...]``; bf16 as ``ml_dtypes.bfloat16``)
    of ``model``: the inverse of ``params_from_numpy``, exact."""
    groups: Dict[tuple, Dict[tuple, np.ndarray]] = {}
    for name, t in model.named_parameters():
        path, idx = stack_index(name)
        groups.setdefault(path, {})[idx] = _to_numpy(t)
    tree: Dict = {}
    for path, rows in groups.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack_rows(rows, "/".join(path))
    return tree
