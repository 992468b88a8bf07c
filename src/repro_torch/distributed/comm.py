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

``all_gather`` calls ``torch.distributed.all_gather_into_tensor`` on every
release, so the CPU tests and the card run the same collective: torch 2.11
(the card's) has no ``all_gather_single``, and 2.13 keeps
``all_gather_into_tensor`` as a deprecated alias of it (a ``FutureWarning``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
COUNTS: Dict[str, Dict[str, int]] = {k: {"bytes": 0, "calls": 0} for k in KINDS}
LOG: Optional[List[Tuple[str, int, str]]] = None

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts() -> None:
    for v in COUNTS.values():
        v["bytes"] = v["calls"] = 0


def counts() -> Dict[str, Dict[str, int]]:
    """A copy of the counts of the kinds that ran."""
    return {k: dict(v) for k, v in COUNTS.items() if v["calls"]}


def _record(kind: str, t: torch.Tensor, tag: str) -> None:
    nbytes = t.numel() * t.element_size()
    COUNTS[kind]["bytes"] += nbytes
    COUNTS[kind]["calls"] += 1
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
