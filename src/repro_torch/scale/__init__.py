"""Scale-out tier: dominance-space segmentation of the UDG (the JAX
package's ``repro.scale`` on torch).

``partition`` — the G×G-aligned segment grid + recall-safe coarse router;
``segmented`` — the batch-built segmented index (concurrent wave builds,
int8-resident segments, the one-dispatch worklist over a flat segment
stack, exact f32 rerank tail);
``stream`` — the segment-local streaming tier (per-segment epoch swaps);
``durability`` — coordinated per-segment WALs + the CRC-framed manifest
(crash-safe checkpoints, concurrent recovery, segment quarantine).

The reference's jit-cache counters (``merge_fold_cache_size``,
``worklist_exec_cache_size``) have no counterpart: nothing is compiled per
shape here.
"""
from repro_torch.scale.durability import (
    CorruptManifestError,
    SegmentedRecoveryReport,
    SegmentRecovery,
    read_manifest,
    recover_segmented,
    write_manifest,
)
from repro_torch.scale.partition import SegmentGrid, canonicalize_batch
from repro_torch.scale.segmented import (
    PartialSearchInfo,
    Segment,
    SegmentedIndex,
    build_segmented_index,
    dispatch_count,
    segmented_index_from_numpy,
    worklist_capacity,
)
from repro_torch.scale.stream import SegmentedStreamingIndex

__all__ = [
    "CorruptManifestError",
    "PartialSearchInfo",
    "Segment",
    "SegmentGrid",
    "SegmentRecovery",
    "SegmentedIndex",
    "SegmentedRecoveryReport",
    "SegmentedStreamingIndex",
    "build_segmented_index",
    "canonicalize_batch",
    "dispatch_count",
    "read_manifest",
    "recover_segmented",
    "segmented_index_from_numpy",
    "worklist_capacity",
    "write_manifest",
]
