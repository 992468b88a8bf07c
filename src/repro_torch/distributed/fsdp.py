"""The sharded train step (ZeRO-3 over a ``TrainMesh``, with tensor and
expert parallelism over its ``model`` axis): what GSPMD makes of the
reference's ``jax.jit(train_step, in_shardings=...)`` (``launch/train.py``,
``launch/dryrun.py``), written out over a process group; and the sharded
prefill and decode steps beside it.

* **State.** Every parameter and every AdamW ``mu``/``nu``/``master`` leaf
  lives only as this rank's slice under ``sharding.param_specs`` /
  ``opt_state_specs`` (``local_shard``): a rank holds each leaf's bytes over
  the product of its spec's axes.
* **Forward and backward.** The model reads its parameters as attributes
  (``models/layers.py``); the step hands it a tree of the same shape whose
  leaves are gathered when they are read (``_Gather``), so a layer's weights
  exist only while it runs and while autograd keeps them for its backward,
  and a recomputed block (``cfg.remat``) gathers them again. The step runs
  on this rank's rows of the batch (``batch_spec``).
* **Tensor and expert parallelism.** A leaf that a tensor- or
  expert-parallel product reads (``read_policy``: ``wq``/``wo``, the MLP's
  and the shared experts' matrices, ``e_*``, ``table``/``heads``, ``wk``/
  ``wv`` when the KV heads split over ``model``, and the Mamba blocks'
  row-parallel leaves) is gathered over its batch axes only and stays this
  rank's ``model`` slice: the layers run their share of each product
  (Megatron's column- then row-parallel split, experts over ranks, a
  vocabulary split over ranks, Mamba1's ``d_inner`` channels and Mamba2's
  heads) and combine it over the model group (``comm.copy_to_model`` /
  ``reduce_from_model`` / ``sum_over_model``, passed as ``tp``). A leaf
  read ``"parts"`` is gathered whole and each rank uses its part of it:
  ``wk``/``wv`` whose KV heads do not split (fewer KV heads than ranks),
  each rank keeping the heads its query heads read; the Mamba blocks'
  ``in_proj`` (its spec's ``model`` slices of the concatenated [x, z] or
  [z, x, B, C, dt] are not a rank's channels), Mamba2's ``conv_w``/
  ``conv_b`` (likewise over [x, B, C]) and the per-channel or per-head
  ``dt_bias``/``A_log``/``D``, which the specs replicate. Their gradient
  sums the ranks' parts. A Mamba block whose channels or heads do not
  divide over ``model`` (``models.model.ssm_splits``) reads its leaves
  whole and every rank runs it. Norms and the ``router`` are replicated
  over ``model``.
* **Gradients.** ``_Gather``'s backward means the gradient of a read over
  the batch axes (``all_reduce``, in the gradient's dtype, then a divide,
  as ``pmean``; summed over ``model`` too for a whole ``wk``/``wv``) and
  keeps this rank's slice. A replicated leaf's gradient is whole on every
  rank of the model group (the activations it touches are whole there).
  The gradient norm is the whole meaned gradient's: each rank sums its
  slices' squares, each divided by the number of ranks that hold the same
  slice, and one ``all_reduce`` over the mesh adds them, so every rank
  clips alike. Each rank then applies AdamW to its own slices
  (``optimizer.update(..., gnorm=)``).
* **MoE.** The aux loss's token means are taken over the whole batch
  (``loss_fn``'s ``batch_mean``), as the one-process step takes them.

The loss, grad norm and parameters equal the one-process
``make_train_step``'s up to the order of float sums.

Every collective goes through ``distributed.comm`` and is counted there;
the model group's carry ``tp`` tags (``comm.counts(tp=True)``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import (
    P,
    _axes,
    batch_spec,
    cache_specs,
    leaf_name,
    local_shard,
    mesh_sizes,
    opt_state_specs,
    param_specs,
    spec_size,
)
from repro_torch.models.attention import all_kv_heads
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.model import init_params_shapes, ssm_group, ssm_splits
from repro_torch.models.steps import decode_step, init_decode_state, loss_fn, prefill_step
from repro_torch.train.optimizer import AdamWState


def gather(shard: torch.Tensor, spec, mesh, tag: str = "") -> torch.Tensor:
    """The whole tensor from this rank's slice: one ``all_gather`` over the
    union of the spec's axes (whose group orders its ranks row-major over
    those axes, in the mesh's order), then each axis's slices moved in
    front of the dim it splits, a dim's axes in the spec's order."""
    split = {d: _axes(e) for d, e in enumerate(spec) if _axes(e)}
    if not split:
        return shard
    used = [a for a in mesh.axis_names if any(a in ax for ax in split.values())]
    sizes = mesh_sizes(mesh)
    out = comm.all_gather(shard, mesh.group(used), dim=0, tag=tag)
    out = out.view(*(sizes[a] for a in used), *shard.shape)
    perm = []
    for d in range(shard.dim()):
        perm += [used.index(a) for a in split.get(d, ())]
        perm.append(len(used) + d)
    whole = [n * math.prod(sizes[a] for a in split.get(d, ())) for d, n in enumerate(shard.shape)]
    return out.permute(perm).reshape(whole)


def _batch_axes(spec) -> tuple:
    return _axes(spec[0]) if len(spec) else ()


# leaves whose ``model`` slice a tensor- or expert-parallel product reads
_MODEL_SLICED = frozenset({"wq", "wo", "w_in", "w_gate", "w_out", "e_in", "e_gate", "e_out",
                           "s_in", "s_gate", "s_out", "table", "heads"})


# how a split Mamba block reads its leaves (no other family has these names)
_SSM_READS = {
    "mamba1": {"in_proj": "parts", "conv_w": "slice", "conv_b": "slice", "x_proj": "slice",
               "dt_proj": "slice", "dt_bias": "parts", "A_log": "parts", "D": "parts",
               "out_proj": "slice"},
    "mamba2": {"in_proj": "parts", "conv_w": "parts", "conv_b": "parts", "dt_bias": "parts",
               "A_log": "parts", "D": "parts", "out_proj": "slice"},
}


def read_policy(name: str, cfg: ModelConfig, mesh) -> str:
    """How the layers read parameter ``name`` on ``mesh``: ``"slice"`` (this
    rank's ``model`` slice), ``"parts"`` (whole, each rank of the model group
    using its part: ``wk``/``wv`` whose KV heads do not split over
    ``model``, and a split Mamba block's ``in_proj``, Mamba2's conv and the
    per-channel or per-head vectors) or ``"whole"`` (whole, every rank of
    the model group computing alike: leaves replicated over ``model``).

    A Mamba block splits when Mamba1's ``d_inner`` or Mamba2's head count
    divides by the ``model`` extent (``ssm_splits``, a rule of the shapes);
    when it does not, every leaf of the block is read ``"whole"``. Mamba1's
    ``conv_w``, ``conv_b``, ``dt_proj`` (``model`` on ``d_inner``),
    ``x_proj`` and ``out_proj`` (row-parallel) are read ``"slice"``, as is
    Mamba2's ``out_proj``."""
    leaf = leaf_name(name)
    model = mesh_sizes(mesh)["model"]
    if leaf in ("wk", "wv"):
        return "slice" if cfg.num_kv_heads % model == 0 else "parts"
    ssm = _SSM_READS.get(cfg.ssm_kind, {})
    if leaf in ssm:
        return ssm[leaf] if ssm_splits(cfg, model) else "whole"
    return "slice" if leaf in _MODEL_SLICED else "whole"


def _drop_model(spec):
    """``spec`` without its ``model`` entries."""
    return P(*(tuple(a for a in _axes(e) if a != "model") or None for e in spec))


class _Gather(torch.autograd.Function):
    """Forward: the leaf from its slice, whole or (``read`` "slice") still
    this rank's ``model`` slice. Backward: the gradient meaned over the
    batch axes (and, for ``"parts"``, summed over ``model``), then this
    rank's slice."""

    @staticmethod
    def forward(ctx, shard, spec, mesh, batch_axes, tag, read):
        ctx.spec = _drop_model(spec) if read == "slice" else spec
        ctx.mesh, ctx.batch_axes, ctx.tag = mesh, batch_axes, tag
        ctx.sum_axes = batch_axes + ("model",) if read == "parts" else batch_axes
        return gather(shard, ctx.spec, mesh, tag)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_axes:
            g = g.clone(memory_format=torch.contiguous_format)
            comm.all_reduce(g, ctx.mesh.group(ctx.sum_axes), tag=ctx.tag)
            if ctx.batch_axes:
                g.div_(torch.distributed.get_world_size(ctx.mesh.group(ctx.batch_axes)))
        return local_shard(g, ctx.spec, ctx.mesh, ctx.mesh.coord), None, None, None, None, None


class _BatchMean(torch.autograd.Function):
    """The mean over the batch axes of a value each rank computed from its
    rows. Backward is the identity: every rank's upstream gradient is the
    same (the meaned value feeds the same loss term on each), and the
    parameters' gradients are meaned afterwards by ``_Gather``."""

    @staticmethod
    def forward(ctx, x, group, n):
        x = x.detach().clone()
        comm.all_reduce(x, group, tag="moe.aux")
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gathered:
    """A module-shaped view of the slices: a child module is a view, a
    ``ModuleList`` a list of views, and a parameter is gathered when it is
    read (through ``fetch``)."""

    def __init__(self, module: nn.Module, prefix: str, fetch):
        self._fetch = fetch
        self._prefix = prefix
        self._params = frozenset(n for n, _ in module.named_parameters(recurse=False))
        for n, child in module.named_children():
            setattr(self, n, _view(child, f"{prefix}{n}.", fetch))

    def __getattr__(self, name):
        if name in self.__dict__.get("_params", ()):
            return self._fetch(self._prefix + name)
        raise AttributeError(name)


def _view(module: nn.Module, prefix: str, fetch):
    if isinstance(module, nn.ModuleList):
        return [_view(c, f"{prefix}{i}.", fetch) for i, c in enumerate(module)]
    return _Gathered(module, prefix, fetch)


def gathered_view(template: nn.Module, shards: Mapping[str, torch.Tensor], specs, mesh, reads,
                  batch_axes=()):
    """``template``'s tree (an ``LM``, on ``meta``) over ``shards``: each
    parameter read gathers its leaf as ``reads[name]`` says
    (``read_policy``); its gradient, meaned over ``batch_axes``, reaches the
    slice."""
    return _view(template, "", lambda name: _Gather.apply(shards[name], specs[name], mesh,
                                                          batch_axes, name, reads[name]))


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params) if isinstance(params, Mapping) else dict(params.named_parameters())


def shard_tree(named: Mapping[str, torch.Tensor], specs, mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of whole tensors, copied onto the mesh's device."""
    return {n: local_shard(t.detach(), specs[n], mesh, mesh.coord).to(mesh.device, copy=True)
            .contiguous() for n, t in named.items()}


def gather_tree(shards: Mapping[str, torch.Tensor], specs, mesh) -> Dict[str, torch.Tensor]:
    """The whole tensors from their slices (every rank gets them)."""
    with torch.no_grad():
        return {n: gather(t.detach(), specs[n], mesh, n) for n, t in shards.items()}


def make_sharded_train_step(cfg: ModelConfig, optimizer, mesh):
    """Returns ``(shard_state, step)`` over a ``TrainMesh``.

    ``shard_state(params, opt_state=None)`` takes whole parameters (an
    ``LM`` or a ``{name: tensor}`` dict, on any device) and optionally a
    whole AdamW state, and returns ``{"params": {name: slice}, "opt":
    AdamWState of slices}`` on the mesh's device (a fresh AdamW state from
    the slices when none is given). ``step(state, batch)`` takes the global
    batch (``tokens``, ``labels``; numpy or tensors), runs this rank's rows,
    updates the state in place and returns ``(state, metrics)``: ``loss``,
    ``aux`` and ``total`` meaned over the batch axes, ``grad_norm`` the
    whole gradient's. ``step.specs`` holds the parameter specs,
    ``step.unshard(state)`` the whole ``(params, opt_state)`` for a
    checkpoint."""
    template = init_params_shapes(cfg)
    specs = param_specs(template, cfg, mesh)
    reads = {n: read_policy(n, cfg, mesh) for n in specs}
    tp = mesh.model_group()
    n_mesh = mesh.size
    repl = {n: n_mesh // spec_size(mesh, s) for n, s in specs.items()}

    def shard_state(params, opt_state=None):
        shards = shard_tree(_named(params), specs, mesh)
        if opt_state is None:
            return {"params": shards, "opt": optimizer.init(shards)}
        ospecs = opt_state_specs(opt_state, specs)
        opt = AdamWState(step=opt_state.step.detach().to(mesh.device, copy=True),
                         mu=shard_tree(opt_state.mu, ospecs.mu, mesh),
                         nu=shard_tree(opt_state.nu, ospecs.nu, mesh),
                         master=shard_tree(opt_state.master, ospecs.master, mesh))
        return {"params": shards, "opt": opt}

    def unshard(state):
        opt = state["opt"]
        return gather_tree(state["params"], specs, mesh), AdamWState(
            step=opt.step.clone(), mu=gather_tree(opt.mu, specs, mesh),
            nu=gather_tree(opt.nu, specs, mesh), master=gather_tree(opt.master, specs, mesh))

    def step(state, batch):
        shards = state["params"]
        tokens = torch.as_tensor(batch["tokens"], device=mesh.device)
        labels = torch.as_tensor(batch["labels"], device=mesh.device)
        bspec = batch_spec(mesh, tuple(tokens.shape))
        b_axes = _batch_axes(bspec)
        tokens = local_shard(tokens, bspec, mesh, mesh.coord)
        labels = local_shard(labels, bspec, mesh, mesh.coord)
        b_group = mesh.group(b_axes) if b_axes else None
        n_batch = torch.distributed.get_world_size(b_group) if b_axes else 1
        for t in shards.values():
            t.requires_grad_(True)
        tree = gathered_view(template, shards, specs, mesh, reads, b_axes)
        mean = (lambda x: _BatchMean.apply(x, b_group, n_batch)) if b_axes else None
        with torch.enable_grad():
            total, metrics = loss_fn(tree, cfg, tokens, labels, batch_mean=mean, tp=tp)
            grads = torch.autograd.grad(total, list(shards.values()), materialize_grads=True)
        grads = dict(zip(shards, grads))
        sq = sum(torch.sum(torch.square(g.to(torch.float32))) / repl[n] for n, g in grads.items())
        comm.all_reduce(sq, mesh.group(mesh.axis_names), tag="grad_norm")
        gnorm = optimizer.update(grads, state["opt"], shards, gnorm=torch.sqrt(sq))
        m = torch.stack([metrics["loss"].detach(), metrics["aux"].detach(), total.detach()])
        if b_axes:
            comm.all_reduce(m, b_group, tag="metrics")
            m = m / n_batch
        return state, {"loss": m[0], "aux": m[1], "total": m[2], "grad_norm": gnorm}

    step.specs = specs
    step.unshard = unshard
    return shard_state, step


# --- the sharded prefill and decode ----------------------------------------------------


def _map_state(fn, tree, specs):
    """``fn(key, leaf, spec)`` over a decode state's leaves."""
    return {k: _map_state(fn, v, specs[k]) if isinstance(v, Mapping) else fn(k, v, specs[k])
            for k, v in tree.items()}


def _model_only(spec):
    """``spec`` with only its ``model`` entries."""
    return P(*(e if e == "model" else None for e in spec))


def _heads_local(key: str, spec) -> bool:
    """A K/V leaf whose heads split over ``model``: its slice is the KV
    heads this rank's query heads read."""
    return key in ("k", "v") and len(spec) >= 2 and spec[-2] == "model"


def state_specs(cfg: ModelConfig, mesh, batch: int, s_max: int, ring_local: bool = False):
    """``cache_specs`` of a decode state of the global ``batch`` and length
    ``s_max``."""
    return cache_specs(init_decode_state(cfg, batch, s_max, ring_local=ring_local, device="meta"),
                       cfg, mesh)


def shard_cache(cache, specs, mesh):
    """This rank's slices of a whole decode state under ``specs``."""
    return _map_state(lambda k, t, sp: local_shard(t, sp, mesh, mesh.coord).clone(), cache, specs)


def gather_cache(cache, specs, mesh):
    """The whole decode state from this rank's slices (every rank gets it)."""
    with torch.no_grad():
        return _map_state(lambda k, t, sp: gather(t, sp, mesh, "cache"), cache, specs)


def make_sharded_serve_steps(cfg: ModelConfig, mesh):
    """Returns ``(prefill, decode)`` over a ``TrainMesh``'s parameter slices
    (``shard_tree`` or ``make_sharded_train_step``'s ``shard_state``), the
    counterparts of the reference's dry-run lowering ``prefill_step`` and
    ``decode_step`` with shardings.

    * ``prefill(shards, tokens, specs) -> (logits, cache)``: ``tokens`` the
      global prompt batch; the step runs this rank's rows (``batch_spec``)
      and returns their last logits over this rank's rows of the
      vocabulary ``[b, (K,) V/model]`` and their decode state of the
      prompt's length under ``specs`` (``state_specs(cfg, mesh, batch,
      prompt)``);
    * ``decode(shards, cache, specs, tokens, pos) -> (logits, cache)``: one
      token of the global batch against this rank's decode state (held
      under ``specs``). A cache whose heads split over ``model`` is read and
      written in place, and so are a split Mamba block's states of the
      rank's channels or heads (Mamba1's ``conv`` and ``h``, Mamba2's
      ``h``). A cache of every KV head (its sequence on ``model``: few KV
      heads on a wide group) is gathered over ``model`` for the step and
      sliced again after it. So is Mamba2's ``conv``, whose spec splits the
      concatenated [x, B, C] channels: the layers read and write it whole
      (``models.ssm``)."""
    template = init_params_shapes(cfg)
    specs = param_specs(template, cfg, mesh)
    reads = {n: read_policy(n, cfg, mesh) for n in specs}
    tp = mesh.model_group()
    coord = mesh.coord
    # a split Mamba block holds these state leaves as the rank's channels or heads
    # across steps (their specs put model on them)
    split = cfg.ssm_kind and ssm_group(cfg, tp) is not None
    own = ssm_lib.RANK_STATE[cfg.ssm_kind] if split else ()

    def rows(t):
        t = torch.as_tensor(t, device=mesh.device)
        return local_shard(t, batch_spec(mesh, tuple(t.shape)), mesh, coord)

    def held(t, spec):
        """This rank's slice of a state leaf whole over ``model``."""
        return local_shard(t, _model_only(spec), mesh, coord).clone() if "model" in spec else t

    def gathered(key, spec) -> bool:
        """A leaf the step reads gathered over ``model``."""
        return "model" in spec and not _heads_local(key, spec) and key not in own

    def place(key, t, spec):
        if _heads_local(key, spec) or key in own:
            return t
        if key in ("k", "v"):
            t = all_kv_heads(t, cfg.num_heads, cfg.num_kv_heads, tp)
        return held(t, spec)

    def prefill(shards, tokens, cspecs):
        tree = gathered_view(template, shards, specs, mesh, reads)
        logits, cache = prefill_step(tree, cfg, rows(tokens), tp=tp)
        return logits, _map_state(place, cache, cspecs)

    def decode(shards, cache, cspecs, tokens, pos):
        tree = gathered_view(template, shards, specs, mesh, reads)
        state = _map_state(lambda k, t, sp: gather(t, _model_only(sp), mesh, "cache")
                           if gathered(k, sp) else t, cache, cspecs)
        logits, state = decode_step(tree, cfg, state, rows(tokens), rows(pos), tp=tp)
        return logits, _map_state(lambda k, t, sp: held(t, sp) if gathered(k, sp) else t,
                                  state, cspecs)

    return prefill, decode
