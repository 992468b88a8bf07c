"""Logical-axis sharding rules (the JAX package's ``distributed/sharding.py``):
a ``PartitionSpec`` for every parameter, optimizer, decode-state, batch and
logits tensor, and the placement of one rank's slice.

Policy (FSDP + TP + EP, the reference's):
  * every weight matrix is sharded on BOTH the fsdp axis ("data", plus
    "pod" multi-pod) and the tensor axis ("model");
  * the tensor axis follows Megatron convention: column-parallel on the
    d_model -> hidden projections, row-parallel on hidden -> d_model;
  * MoE expert tensors put the *expert* dimension on "model" (EP);
  * vocab/embedding tables are vocab-sharded on "model";
  * small vectors (norms, biases, per-head scalars) replicate;
  * batch dims shard over ("pod","data"); KV caches additionally shard
    heads over "model"; SSM states shard d_inner over "model".

Rules are matched by leaf *name*, with dim specs aligned to the trailing
dimensions. Two differences from the reference follow from the port's
model tree (``models/model.py``):

* the port's parameter leaves are unstacked (``layers.3.attn.wq`` is
  ``[D, H*hd]`` where the reference's ``layers/attn/wq`` is ``[L, D,
  H*hd]``), so a leaf's spec is the reference's with the leading ``None``s
  of the stack dims dropped; ``param_specs`` returns ``{parameter name:
  spec}``;
* a leaf's name is the last non-numeric part of its dotted name. The decode
  state is stacked as the reference's (``steps._stack``), so
  ``cache_specs`` keeps its stack padding.

``PartitionSpec`` is the port's own: a tuple with one entry per leading
tensor dim, each an axis name, a tuple of names (split major to minor) or
``None``. ``mesh`` is anything with axis names and sizes: the production
description (``launch.mesh.MeshSpec``), a serving ``ShardMesh``, a training
``distributed.mesh.TrainMesh`` or a torch ``DeviceMesh``. ``to_placements``
gives a spec as DTensor placements; ``local_shard`` cuts the slice one rank
holds, a dim split over ``("pod", "data")`` pod-major as in JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """``P("data", None)``: one entry per leading tensor dim (missing
    trailing entries replicate)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of any of the meshes the module takes."""
    names = getattr(mesh, "mesh_dim_names", None)        # torch DeviceMesh
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, (int(v) for v in mesh.shape)))


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_sizes(mesh))


def _fsdp(mesh) -> object:
    return ("pod", "data") if "pod" in _names(mesh) else "data"


# leaf-name -> spec for the TRAILING dims (None-padded on the left at apply)
def _rules(fsdp) -> Dict[str, Tuple]:
    return {
        # embeddings / heads: vocab on model, d_model on fsdp
        "table": ("model", fsdp),
        "heads": ("model", fsdp),          # musicgen [K, D, V] -> pad left
        # attention projections
        "wq": (fsdp, "model"),
        "wk": (fsdp, "model"),
        "wv": (fsdp, "model"),
        "wo": ("model", fsdp),
        # dense MLP
        "w_in": (fsdp, "model"),
        "w_gate": (fsdp, "model"),
        "w_out": ("model", fsdp),
        # MoE: expert dim on model (EP), d_model on fsdp
        "router": (fsdp, None),
        "e_in": ("model", fsdp, None),
        "e_gate": ("model", fsdp, None),
        "e_out": ("model", None, fsdp),
        "s_in": (fsdp, "model"),
        "s_gate": (fsdp, "model"),
        "s_out": ("model", fsdp),
        # SSM: d_inner on model
        "in_proj": (fsdp, "model"),
        "x_proj": ("model", None),
        "dt_proj": (None, "model"),
        "out_proj": ("model", fsdp),
        "conv_w": (None, "model"),
        "conv_b": ("model",),
        "A_log": None,                     # [di, ds] m1 / [nh] m2: replicate
        "dt_bias": None,
        "D": None,
        # norms
        "scale": None,
    }


def _spec_for(name: str, ndim: int, rules) -> PartitionSpec:
    rule = rules.get(name, None)
    if rule is None:
        return P()
    rule = tuple(rule)
    if ndim < len(rule):  # scalar-ish leaf that matched a matrix rule
        return P()
    pad = (None,) * (ndim - len(rule))
    return P(*(pad + rule))


def leaf_name(name: str) -> str:
    """``layers.3.attn.wq`` -> ``wq``: the last non-numeric part."""
    return next(p for p in reversed(name.split(".")) if not p.isdigit())


def param_specs(params, cfg: ModelConfig, mesh) -> Dict[str, PartitionSpec]:
    """``{parameter name: spec}`` for an ``LM`` (on ``meta`` too) or a
    ``{name: tensor}`` dict, in its order."""
    named = params if isinstance(params, Mapping) else dict(params.named_parameters())
    rules = _rules(_fsdp(mesh))
    out = {}
    for name, leaf in named.items():
        leaf_ = leaf_name(name)
        if leaf_ == "heads":  # musicgen heads at top level: [K, D, V]
            out[name] = P(None, _fsdp(mesh), "model")
        else:
            out[name] = _spec_for(leaf_, len(leaf.shape), rules)
    return out


def opt_state_specs(opt_state, params_specs):
    """AdamW state mirrors the parameter specs (step scalar replicated)."""
    assert hasattr(opt_state, "mu"), type(opt_state)
    return type(opt_state)(step=P(), mu=params_specs, nu=params_specs, master=params_specs)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axes, str):
        return int(sizes[axes])
    n = 1
    for a in axes:
        n *= int(sizes[a])
    return n


def spec_size(mesh, spec) -> int:
    """The number of slices a tensor of this spec is cut into."""
    n = 1
    for axes in spec:
        n *= _axis_size(mesh, axes)
    return n


def _pick_batch(mesh, b: int):
    """Largest batch-parallel axis set that divides b (None = replicate).

    long_500k has global_batch=1 — an unshardable batch is replicated and
    the cache's sequence dim takes the model axis instead."""
    names = _names(mesh)
    for cand in (_fsdp(mesh), "data", "pod" if "pod" in names else None):
        if cand is None:
            continue
        if b % _axis_size(mesh, cand) == 0:
            return cand
    return None


def _model_if_divisible(mesh, n: int):
    return "model" if n % _axis_size(mesh, "model") == 0 else None


def batch_spec(mesh, shape) -> PartitionSpec:
    """Token batches: batch dim over the largest divisible DP axis set."""
    return P(_pick_batch(mesh, shape[0]), *([None] * (len(shape) - 1)))


def logits_spec(mesh, shape) -> PartitionSpec:
    """[B, ..., V]: batch over DP axes, vocab over model when divisible."""
    return P(
        _pick_batch(mesh, shape[0]),
        *([None] * (len(shape) - 2)),
        _model_if_divisible(mesh, shape[-1]),
    )


def cache_specs(cache, cfg: ModelConfig, mesh):
    """Decode-state sharding, shape-aware: a nested dict of specs with the
    structure of ``cache`` (``init_decode_state``'s).

    KV tensors [stack.., B, S, KV, hd]: heads on "model" when divisible,
    otherwise the sequence dim takes "model" (sequence-sharded cache — the
    standard fallback for few-KV-head models on wide meshes). SSM conv
    [stack.., B, K-1, C] shards channels; SSM h shards d_inner / heads.
    """

    def spec(name, leaf):
        nd = len(leaf.shape)
        if name in ("k", "v"):
            B, S, KV, _hd = leaf.shape[nd - 4:]
            pad = (None,) * (nd - 4)
            b_ax = _pick_batch(mesh, B)
            kv_ax = _model_if_divisible(mesh, KV)
            s_ax = None if kv_ax else _model_if_divisible(mesh, S)
            return P(*pad, b_ax, s_ax, kv_ax, None)
        if name == "pos":
            # ring-buffer slot positions [stack..., B, W]
            B = leaf.shape[nd - 2]
            pad = (None,) * (nd - 2)
            return P(*pad, _pick_batch(mesh, B), None)
        if name == "conv":
            B, _K, C = leaf.shape[nd - 3:]
            pad = (None,) * (nd - 3)
            return P(*pad, _pick_batch(mesh, B), None, _model_if_divisible(mesh, C))
        if name == "h":
            if cfg.ssm_kind == "mamba2":
                B, NH, _hd, _ds = leaf.shape[nd - 4:]
                pad = (None,) * (nd - 4)
                return P(*pad, _pick_batch(mesh, B),
                         _model_if_divisible(mesh, NH), None, None)
            B, DI, _ds = leaf.shape[nd - 3:]
            pad = (None,) * (nd - 3)
            return P(*pad, _pick_batch(mesh, B),
                     _model_if_divisible(mesh, DI), None)
        return P()

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else spec(k, v) for k, v in tree.items()}

    return walk(cache)


# --- placement ---------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim, in the mesh's axis
    order: the DTensor form of ``spec``. A tensor dim split over several
    axes gets ``Shard(d)`` on each, and DTensor splits it in mesh-dim
    order, which is pod-major as in JAX."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a in where:
                raise ValueError(f"axis {a!r} appears twice in {spec}")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in _names(mesh))


def _coords(mesh, coords) -> Dict[str, int]:
    if isinstance(coords, Mapping):
        return {k: int(v) for k, v in coords.items()}
    return dict(zip(_names(mesh), (int(c) for c in coords)))


def slice_index(entry, mesh, coords: Mapping[str, int]) -> Tuple[int, int]:
    """(this rank's slice index, the number of slices) of a dim split over
    ``entry``'s axes, the first axis major."""
    sizes = mesh_sizes(mesh)
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_shard(tensor: torch.Tensor, spec, mesh, coords) -> torch.Tensor:
    """The slice of ``tensor`` that the rank at ``coords`` (``{axis:
    index}`` or a tuple in the mesh's axis order) holds under ``spec``: a
    view. Raises when a dim does not divide into its slices."""
    c = _coords(mesh, coords)
    out = tensor
    for d, entry in enumerate(spec):
        idx, n = slice_index(entry, mesh, c)
        if n == 1:
            continue
        size = tensor.shape[d]
        if size % n:
            raise ValueError(f"dim {d} of size {size} does not split {n} ways ({entry})")
        out = out.narrow(d, idx * (size // n), size // n)
    return out
