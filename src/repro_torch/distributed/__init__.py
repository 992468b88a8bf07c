"""Process layout of the port's serving path (``ShardMesh``)."""
from repro_torch.distributed.mesh import ShardMesh, make_host_mesh, make_process_mesh

__all__ = ["ShardMesh", "make_host_mesh", "make_process_mesh"]
