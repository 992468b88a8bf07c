"""The port's distributed runtime: the serving mesh (``ShardMesh``), the
training mesh (``TrainMesh``), the sharding rules, the counted collectives,
int8 gradient compression, the sharded (FSDP) train step and elastic
restarts."""
from repro_torch.distributed.mesh import (
    ShardMesh,
    TrainMesh,
    make_host_mesh,
    make_process_mesh,
    make_train_mesh,
)
from repro_torch.distributed.sharding import (
    PartitionSpec,
    batch_spec,
    cache_specs,
    local_shard,
    logits_spec,
    opt_state_specs,
    param_specs,
    to_placements,
)

__all__ = [
    "PartitionSpec",
    "ShardMesh",
    "TrainMesh",
    "batch_spec",
    "cache_specs",
    "local_shard",
    "logits_spec",
    "make_host_mesh",
    "make_process_mesh",
    "make_train_mesh",
    "opt_state_specs",
    "param_specs",
    "to_placements",
]
