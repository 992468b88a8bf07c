"""Explicit data-parallel trainer with optional int8 gradient compression
(the JAX package's ``train/dp_trainer.py``).

The default production path is the sharded step (``distributed/fsdp.py``,
the counterpart of the reference's GSPMD trainer). This module is the
*explicit-collective* variant used when the communication schedule itself
is the experiment: every rank of the mesh's ``data`` axis holds the whole
model and state, computes the gradients of its rows, and means them either
in the gradients' dtype (``all_reduce`` then a divide, as ``pmean``) or
through the int8 error-feedback path (``distributed.compression``). The
reference's docstring promises an 8x ICI traffic cut; its sum runs in
int32, so the wire carries 4 bytes an element (ROADMAP C9), which the port
keeps.

Where the reference maps the step over the mesh (``shard_map`` with the
batch on ``P("data")``), each rank here runs it on its rows
(``distributed/compat.py``). The state and the optimizer update in place,
as ``models.steps.make_train_step``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed.compression import compressed_psum, init_residual
from repro_torch.distributed.sharding import P, local_shard
from repro_torch.models.steps import loss_fn


def make_dp_train_step(cfg: ModelConfig, optimizer, mesh, *, compress_grads: bool = False):
    """Returns ``(init_state, step)`` for pure-DP training over the mesh's
    ``data`` axis (a ``TrainMesh``).

    ``init_state(params)`` -> ``{params, opt, residual}`` (``params`` an
    ``LM`` on the mesh's device; the residual f32 zeros with
    ``compress_grads``, else empty: the reference allocates it either way). ``step(state,
    batch)`` takes the global batch, cuts this rank's rows along dim 0 over
    ``data``, and returns ``(state, metrics)`` with ``loss`` and ``total``
    meaned over ``data`` and ``grad_norm`` from the update."""
    group = mesh.group("data")

    def step_fn(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        n = torch.distributed.get_world_size(group)
        rows = P("data")
        tokens = local_shard(torch.as_tensor(batch["tokens"], device=mesh.device), rows, mesh,
                             mesh.coord)
        labels = local_shard(torch.as_tensor(batch["labels"], device=mesh.device), rows, mesh,
                             mesh.coord)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        with torch.enable_grad():
            total, metrics = loss_fn(params, cfg, tokens, labels)
            grads = torch.autograd.grad(total, list(named.values()), materialize_grads=True)
        grads = dict(zip(named, grads))
        if compress_grads:
            grads, state["residual"] = compressed_psum(grads, state["residual"], group)
        else:
            for name, g in grads.items():
                comm.all_reduce(g, group, tag=name)
                g.div_(n)
        gnorm = optimizer.update(grads, state["opt"], params)
        m = torch.stack([metrics["loss"].detach(), total.detach()])
        comm.all_reduce(m, group, tag="metrics")
        m = m / n
        return state, {"loss": m[0], "total": m[1], "grad_norm": gnorm}

    def init_state(params):
        return {"params": params, "opt": optimizer.init(params),
                "residual": init_residual(params) if compress_grads else {}}

    return init_state, step_fn
