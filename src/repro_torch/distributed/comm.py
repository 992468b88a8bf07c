"""The training path's collectives, counted.

Every collective of the sharded step (``distributed/fsdp.py``), the
data-parallel trainer (``train/dp_trainer.py``), gradient compression and
the elastic runner goes through ``all_gather`` or ``all_reduce`` here. Each
call adds its operand bytes (the bytes this rank puts on the wire: the
local shard of a gather, the tensor of a reduce) and one call to
``COUNTS[kind]``, under the reference's collective kind names
(``launch/hlo.py``'s ``all-gather``, ``all-reduce``, ...), so that
``launch.hlo.collective_bytes`` reads them in the shape the reference
parses out of HLO. With ``LOG`` set to a list, each call also appends
``(kind, bytes, tag)``, the tag naming the leaf that caused it
(``launch/inspect_cell.py``).

Tensor (and expert) parallelism over the mesh's ``model`` axis runs on
``ModelGroup``, the ranks that split one model's work, through Megatron's
two conjugate functions: ``copy_to_model`` (identity forward, all-reduce
backward) where a replicated activation enters a rank's slice of a product,
and ``reduce_from_model`` (all-reduce forward, identity backward) where the
slices' partial results combine; ``sum_over_model`` (all-reduce both ways)
combines partial results that every rank then reads again from its own
slice (Mamba1's ``x_proj`` product). Their collectives carry tags that start
with ``tp``; ``COUNTS`` keeps their bytes and calls a second time
(``tp_bytes``, ``tp_calls``), so that the activation traffic they move reads
apart from the weights' and gradients' (``counts(tp=True)``) without a log.
A layer given ``tp=None`` holds the whole model in one process: the two
functions are the identity and no collective runs.

``all_gather`` calls ``torch.distributed.all_gather_into_tensor`` on every
release, so the CPU tests and the card run the same collective: torch 2.11
(the card's) has no ``all_gather_single``, and 2.13 keeps
``all_gather_into_tensor`` as a deprecated alias of it (a ``FutureWarning``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_FIELDS = ("bytes", "calls", "tp_bytes", "tp_calls")
COUNTS: Dict[str, Dict[str, int]] = {k: dict.fromkeys(_FIELDS, 0) for k in KINDS}
LOG: Optional[List[Tuple[str, int, str]]] = None

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts() -> None:
    for v in COUNTS.values():
        v.update(dict.fromkeys(_FIELDS, 0))


def counts(tp: bool = False) -> Dict[str, Dict[str, int]]:
    """A copy of the counts of the kinds that ran: every collective, or
    (``tp``) only the model group's activation collectives."""
    pre = "tp_" if tp else ""
    return {k: {"bytes": v[pre + "bytes"], "calls": v[pre + "calls"]}
            for k, v in COUNTS.items() if v[pre + "calls"]}


def _record(kind: str, t: torch.Tensor, tag: str) -> None:
    nbytes = t.numel() * t.element_size()
    for pre in ("", "tp_") if tag.startswith("tp") else ("",):
        COUNTS[kind][pre + "bytes"] += nbytes
        COUNTS[kind][pre + "calls"] += 1
    if LOG is not None:
        LOG.append((kind, nbytes, tag))


def all_gather(t: torch.Tensor, group, dim: int = 0, tag: str = "") -> torch.Tensor:
    """The group's slices of ``t`` concatenated along ``dim`` in group-rank
    order (a new tensor)."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)   # slices along dim 0 (gloo's form)
    _record("all-gather", t, tag)
    if dim == 0:
        return out
    shape = list(t.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(t.shape)).movedim(0, dim).reshape(shape)


def all_reduce(t: torch.Tensor, group, op: str = "sum", tag: str = "") -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op`` "sum" or "max");
    returns ``t``. A strided ``t`` (a gradient of a transposed read) is
    reduced through a contiguous copy, which NCCL requires."""
    buf = t if t.is_contiguous() else t.contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    if buf is not t:
        t.copy_(buf)
    _record("all-reduce", t, tag)
    return t


# --- tensor parallelism over the model axis ------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ranks that split one model's work (a mesh's ``model`` axis): their
    process group, its size and this rank's index in it
    (``TrainMesh.model_group()``)."""

    group: object
    size: int
    rank: int


def part(tp: Optional[ModelGroup], n: int) -> Tuple[int, int]:
    """(first, count) of this rank's share of ``n`` items split evenly over
    the group: all of them without a group."""
    if tp is None:
        return 0, n
    if n % tp.size:
        raise ValueError(f"{n} does not split over a model group of {tp.size}")
    k = n // tp.size
    return tp.rank * k, k


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy for an in-place collective."""
    return t.clone(memory_format=torch.contiguous_format)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, tag):
        ctx.tp, ctx.tag = tp, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), ctx.tp.group, tag=ctx.tag), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, tag):
        return all_reduce(_copy(x), tp.group, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, tag):
        ctx.tp, ctx.tag = tp, tag
        return all_reduce(_copy(x), tp.group, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), ctx.tp.group, tag=ctx.tag), None, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelGroup], tag: str = "tp.copy") -> torch.Tensor:
    """``x`` (the same on every rank of the group) entering this rank's slice
    of a product: the identity, whose backward sums the ranks' partial
    gradients (one ``all_reduce``)."""
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, tp, tag)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelGroup],
                      tag: str = "tp.reduce") -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (one ``all_reduce``), whose
    backward hands each rank the whole gradient."""
    if tp is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, tp, tag)
    return all_reduce(_copy(x), tp.group, tag=tag)


def sum_over_model(x: torch.Tensor, tp: Optional[ModelGroup], tag: str = "tp.sum") -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (one ``all_reduce``) where each
    rank goes on to use the whole sum with its own slice of the next
    product: each rank's gradient of the sum is then partial too, so the
    backward sums it over the group as well (one more ``all_reduce``)."""
    if tp is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverModel.apply(x, tp, tag)
    return all_reduce(_copy(x), tp.group, tag=tag)


def max_over_model(x: torch.Tensor, tp: Optional[ModelGroup], tag: str = "tp.max") -> torch.Tensor:
    """The elementwise max over the group of a value without a gradient."""
    x = x.detach()
    return x if tp is None else all_reduce(_copy(x), tp.group, op="max", tag=tag)
