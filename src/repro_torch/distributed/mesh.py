"""The serving mesh: how a sharded index's shards map onto processes.

The JAX package serves through ``shard_map`` over a ``(data, model)``
device mesh (``launch/mesh.make_host_mesh``). The port's ``ShardMesh``
keeps what serving needs of it, the ``model`` axis (one database shard per
position), in one of two executions of the same step:

* **single process** (``group=None``): all ``model`` shards lie on one
  device, stacked on a leading shard axis; the serving step runs each
  shard's search in shard order and merges on that device;
* **process group** (``group`` a ``torch.distributed`` group of ``model``
  ranks): rank r holds shard r on its own device; the cross-shard merge is
  ``all_gather`` (or ``isend``/``irecv`` for the tournament) and the
  counters' sum ``all_reduce``.

The query axes (``data``, ``pod``) are 1: every rank serves the whole
batch. ``make_host_mesh`` builds the single-process form,
``make_process_mesh`` the process-group form over an initialized group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    model: int                   # number of database shards
    device: torch.device         # where this process's shards lie
    group: Optional[object] = None   # torch.distributed group of `model` ranks

    @property
    def rank(self) -> int:
        """This process's shard in the process-group form, else 0."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process searches, in shard order."""
        if self.group is None:
            return tuple(range(self.model))
        return (self.rank,)


def make_host_mesh(model_parallel: int = 1, device=None) -> ShardMesh:
    """Single-process mesh of ``model_parallel`` shards on ``device``
    (``None`` = the card)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} < 1")
    return ShardMesh(model=int(model_parallel), device=resolve_device(device))


def make_process_mesh(group=None, device=None) -> ShardMesh:
    """Process-group mesh: one shard per rank of ``group`` (``None`` = the
    default group, which must be initialized), this rank's shard on
    ``device`` (``None`` = the card)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized")
    group = group if group is not None else dist.group.WORLD
    return ShardMesh(model=dist.get_world_size(group), device=resolve_device(device),
                     group=group)
