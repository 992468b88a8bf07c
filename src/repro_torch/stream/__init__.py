"""Streaming index: LSM-style online inserts and deletes over the UDG.

Two tiers, an immutable compacted UDG and a fixed-capacity mutable delta
buffer, searched by one call whose device tensors keep their shapes across
compaction epochs; a write-ahead log and snapshots make every acknowledged
mutation durable. The JAX package's ``repro.stream``, on torch (its jit
cache counter ``streaming_search_cache_size`` has no counterpart: nothing
is compiled per shape here).
"""
from repro_torch.stream.delta import DeltaBuffer, query_key_state, sort_key
from repro_torch.stream.index import (
    CompactionPolicy,
    CompactionReport,
    StreamingIndex,
)
from repro_torch.stream.search import (
    planned_streaming_search_core,
    streaming_search_core,
)
from repro_torch.stream.wal import (
    CorruptSnapshotError,
    RecoveryReport,
    ReplayReport,
    WalRecord,
    WriteAheadLog,
    file_digest,
    recover,
)

__all__ = [
    "CompactionPolicy",
    "CompactionReport",
    "CorruptSnapshotError",
    "DeltaBuffer",
    "RecoveryReport",
    "ReplayReport",
    "StreamingIndex",
    "WalRecord",
    "WriteAheadLog",
    "file_digest",
    "planned_streaming_search_core",
    "query_key_state",
    "recover",
    "sort_key",
    "streaming_search_core",
]
