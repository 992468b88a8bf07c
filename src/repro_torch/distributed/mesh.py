"""The serving mesh: how a sharded index's shards and a batch's queries map
onto processes.

The JAX package serves through ``shard_map`` over a ``(data, model)`` (or
``(pod, data, model)``) device mesh (``launch/mesh.py``): the database is
split over ``model``, one shard a position, and the query batch over the
query axes ``("pod", "data")``, pod major (``P(("pod", "data"))``). The
port's ``ShardMesh`` has the same three extents, in one of two executions
of the same step:

* **single process** (``group=None``): every shard lies on one device,
  stacked on a leading shard axis, and the batch is cut into
  ``pod * data`` slices that run in turn; each slice searches every shard in
  shard order and merges on that device, and the slices' answers are
  concatenated in slice order. This form exists to hold the other one bit
  for bit;
* **process group**: a world of W = pod * data * model ranks. Rank r sits
  at (pod, data, model) in row-major order: it holds shard ``r % model``
  and serves query slice ``r // model``. The cross-shard merge
  (``all_gather``, or ``isend``/``irecv`` for the tournament) and the
  counters' ``all_reduce`` run over the rank's **model subgroup** (the
  ranks of its query slice); the merged answer is then gathered over its
  **query subgroup** (the ranks of its shard, one per slice), so every rank
  returns the whole batch.

``make_host_mesh`` builds the single-process form, ``make_process_mesh``
the process-group form over an initialized default group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.comm import ModelGroup


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    model: int                   # number of database shards
    device: torch.device         # where this process's shards lie
    group: Optional[object] = None   # process-group form: this rank's model subgroup
    data: int = 1                # query slices within a pod
    pod: int = 1                 # pods (query slices = pod * data)
    query_group: Optional[object] = None   # process-group form: the ranks of this shard
    query_index: int = 0         # process-group form: this rank's query slice

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The reference's axis names: ``pod`` only when there are pods."""
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pod, self.data, self.model) if self.pod > 1 else (self.data, self.model)

    @property
    def queries(self) -> int:
        """Query slices of a batch: the product of the query axes."""
        return self.pod * self.data

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

    @property
    def local_queries(self) -> Tuple[int, ...]:
        """The query slices this process serves, in slice order."""
        if self.group is None:
            return tuple(range(self.queries))
        return (self.query_index,)


def _extent(name: str, v: int) -> int:
    if int(v) < 1:
        raise ValueError(f"{name}={v} < 1")
    return int(v)


def make_host_mesh(model_parallel: int = 1, *, data: int = 1, pod: int = 1,
                   device=None) -> ShardMesh:
    """Single-process mesh of ``model_parallel`` shards and ``pod * data``
    query slices on ``device`` (``None`` = the card).

    The reference's ``make_host_mesh(model_parallel)`` takes its data extent
    from the host's device count (``len(jax.devices()) // model_parallel``);
    one torch process has one device, so ``data`` (and ``pod``) are
    keywords here, 1 by default."""
    return ShardMesh(model=_extent("model_parallel", model_parallel),
                     device=resolve_device(device), data=_extent("data", data),
                     pod=_extent("pod", pod))


def make_process_mesh(group=None, *, model: Optional[int] = None, pod: int = 1,
                      device=None) -> ShardMesh:
    """Process-group mesh over ``group`` (``None`` = the default group,
    which must be initialized), this rank's shard on ``device`` (``None`` =
    the card). ``model`` shards (``None``: the whole world over ``pod``
    pods, data 1); data = W / (pod * model).

    Every rank of the default group must call this, in the same order as
    its other ``new_group`` calls: the subgroups are created by every rank,
    those it is not in included, as ``torch.distributed.new_group``
    requires."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized")
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    pod = _extent("pod", pod)
    model = _extent("model", model if model is not None else world // pod)
    if world % (pod * model):
        raise ValueError(f"a world of {world} ranks is not pod {pod} x data x model {model}")
    data = world // (pod * model)
    dev = resolve_device(device)
    if pod * data == 1:
        return ShardMesh(model=model, device=dev, group=group)
    ranks = [dist.get_global_rank(group, i) for i in range(world)]
    me = dist.get_rank(group)
    q_idx, m_idx = divmod(me, model)
    model_group = query_group = None
    for q in range(pod * data):          # every rank creates every subgroup, in one order
        g = dist.new_group([ranks[q * model + m] for m in range(model)])
        if q == q_idx:
            model_group = g
    for m in range(model):
        g = dist.new_group([ranks[q * model + m] for q in range(pod * data)])
        if m == m_idx:
            query_group = g
    return ShardMesh(model=model, device=dev, group=model_group, data=data, pod=pod,
                     query_group=query_group, query_index=q_idx)


# --- the training mesh ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A ``(data, model)`` or ``(pod, data, model)`` mesh over ranks of an
    initialized process group, for the sharded train step, the
    data-parallel trainer and the elastic runner.

    ``ranks`` are the global ranks of the mesh in row-major order over the
    axes; ``coords`` is this rank's position (``None`` for a rank outside
    the mesh, which takes no step on it). ``groups`` maps every non-empty
    subset of the axes (a tuple in the mesh's order; ``axis_names`` is the
    whole mesh) to this rank's group over those axes. A group's rank order
    is the row-major order of its axes, so a dim split over ``("pod",
    "data")`` gathers pod-major."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    ranks: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]]
    groups: dict

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def coord(self) -> dict:
        """``{axis: index}`` of this rank."""
        return dict(zip(self.axis_names, self.coords))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def model_group(self):
        """This rank's ``model`` group, its size and this rank's index in it
        (``comm.ModelGroup``): the ranks that split each layer's work. At
        model 1 it is a one-rank group, and the layers run the same code."""
        return ModelGroup(group=self.group("model"),
                          size=int(self.shape[self.axis_names.index("model")]),
                          rank=self.coord["model"])

    def group(self, axes):
        """This rank's group over ``axes`` (a name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes):
            raise KeyError(f"axes {axes} are not axes of the mesh {self.axis_names}")
        return self.groups[key]


def _combos(names: Tuple[str, ...]) -> Tuple[Tuple[str, ...], ...]:
    """Every non-empty subset of the axes, in the mesh's order."""
    import itertools

    return tuple(c for k in range(1, len(names) + 1) for c in itertools.combinations(names, k))


def make_train_mesh(*, model: int = 1, pod: int = 1, ranks=None, device=None) -> TrainMesh:
    """A training mesh over ``ranks`` (``None``: every rank of the default
    group, which must be initialized): ``model`` x ``pod`` divides their
    number, data is the rest. Every rank of the default group must call
    this with the same arguments, in the same order as its other
    ``new_group`` calls: it creates every group of the mesh, those this
    rank is not in included, as ``torch.distributed.new_group`` requires."""
    import numpy as np

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(sorted(int(r) for r in ranks))
    pod, model = _extent("pod", pod), _extent("model", model)
    if len(ranks) % (pod * model):
        raise ValueError(f"a mesh of {len(ranks)} ranks is not pod {pod} x data x model {model}")
    data = len(ranks) // (pod * model)
    names = ("pod", "data", "model") if pod > 1 else ("data", "model")
    shape = (pod, data, model) if pod > 1 else (data, model)
    grid = np.array(ranks).reshape(shape)
    me = dist.get_rank()
    coords = tuple(int(c) for c in np.argwhere(grid == me)[0]) if me in ranks else None
    groups = {}
    for combo in _combos(names):
        rest = [names.index(a) for a in names if a not in combo]
        inner = [names.index(a) for a in combo]
        rows = grid.transpose(rest + inner).reshape(-1, int(np.prod([shape[i] for i in inner])))
        for row in rows:
            members = [int(r) for r in row]
            g = dist.group.WORLD if members == list(range(world)) else dist.new_group(members)
            if me in members:
                groups[combo] = g
    return TrainMesh(shape=shape, axis_names=names, device=resolve_device(device), ranks=ranks,
                     coords=coords, groups=groups)
