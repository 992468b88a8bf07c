"""Mesh construction (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants, so that importing this module
initializes neither CUDA nor a process group (the reference's reason: its
dry-run sets ``XLA_FLAGS`` before any device state exists).

Mesh axes:
  pod    cross-pod data parallelism (2 pods in the multi-pod layout)
  data   in-pod data parallel axis; serving splits the query batch over
         ``("pod", "data")``
  model  tensor / expert parallel axis; also the database-shard axis of UDG
         serving

No torch process has 256 devices, so ``make_production_mesh`` returns a
description of the production axes (``MeshSpec``: their shape and names).
The process-group form of ``repro_torch.distributed.ShardMesh``
(``make_process_mesh``) realizes such axes over as many ranks as exist;
``make_host_mesh`` (``repro_torch.distributed``'s, with ``data=`` in place
of the reference's host device count) is the single-process form.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.distributed.mesh import make_host_mesh  # noqa: F401  (the single-process form)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's shape and axis names, with no devices behind it."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(shape, axes)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def data_axes(mesh) -> Tuple[str, ...]:
    """All batch-parallel axes (pod absorbed into data when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
