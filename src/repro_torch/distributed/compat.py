"""The JAX package's version shims (``distributed/compat.py``), where the
port has a counterpart.

``abstract_mesh(shape)`` is the reference's ``AbstractMesh`` across JAX
releases: a mesh's axis names and sizes with no devices behind it. The port
returns the production description ``launch.mesh.MeshSpec``, which the
sharding rules read as they read any mesh.

``shard_map`` has no counterpart. Where the reference maps a body over a
device mesh (``shard_map(step, mesh, in_specs, out_specs)``), each rank of a
process group runs the body on its own slice: the caller cuts the rank's
rows (``sharding.local_shard`` under the in-spec) and the body's
collectives (``psum``, ``pmax``, ``pmean``) are ``torch.distributed``
calls over the rank's group of the named axis (``distributed.comm``,
``TrainMesh.group``). ``train/dp_trainer.py`` and ``serve/distributed.py``
are written that way.
"""
from __future__ import annotations

from repro_torch.launch.mesh import MeshSpec


def abstract_mesh(shape: dict) -> MeshSpec:
    """``{axis name: size}`` -> a ``MeshSpec`` of those axes, in order."""
    return MeshSpec(tuple(int(v) for v in shape.values()), tuple(shape))
