"""Batched UDG search on torch tensors — the serving path."""
from repro_torch.search.device_graph import (
    BroadExport,
    DeltaSegment,
    DeviceGraph,
    DeviceIndex,
    SegmentStack,
    device_graph_from_numpy,
    export_device_graph,
    pack_labels,
    unpack_labels,
)
from repro_torch.search.batched import (
    batched_udg_search,
    broad_batched_search,
    prepare_states,
    search_core,
)

__all__ = [
    "BroadExport",
    "DeltaSegment",
    "DeviceGraph",
    "DeviceIndex",
    "SegmentStack",
    "batched_udg_search",
    "broad_batched_search",
    "device_graph_from_numpy",
    "export_device_graph",
    "pack_labels",
    "prepare_states",
    "search_core",
    "unpack_labels",
]
