"""Sharded UDG serving: per-shard search + cross-shard merge, request
batching, admission control, and straggler mitigation (the JAX package's
``repro.serve`` on torch, with the segmented tier's
``segments_to_sharded_index``)."""
from repro_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    RequestShed,
    validate_query,
)
from repro_torch.serve.distributed import (
    PartialResult,
    ShardedIndex,
    ShardedStreamingIndex,
    build_sharded_index,
    make_planned_serving_step,
    make_serving_step,
    make_streaming_serving_step,
    merge_partial_results,
    plan_sharded_batch,
    remap_shard_ids,
    segments_to_sharded_index,
    serve_batch,
    serve_streaming_batch,
    sharded_index_from_numpy,
)
from repro_torch.serve.batching import RequestBatcher, StreamingServer

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "PartialResult",
    "RequestBatcher",
    "RequestShed",
    "ShardedIndex",
    "ShardedStreamingIndex",
    "StreamingServer",
    "build_sharded_index",
    "make_planned_serving_step",
    "make_serving_step",
    "make_streaming_serving_step",
    "merge_partial_results",
    "plan_sharded_batch",
    "remap_shard_ids",
    "segments_to_sharded_index",
    "serve_batch",
    "serve_streaming_batch",
    "sharded_index_from_numpy",
    "validate_query",
]
