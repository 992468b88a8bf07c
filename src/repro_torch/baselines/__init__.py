"""Hybrid-search baselines from the paper's evaluation (§VI-A):

  PostFilter-HNSW  global proximity graph, oversampled search, post filter
  PreFilter        exact valid-set enumeration + brute-force scan
  ACORN            predicate-agnostic graph (gamma-expanded neighbor lists,
                   predicate-filtered traversal)
  Hi-PNG           containment-specific hierarchical interval partition
                   navigating graph (reimplemented from its description)

Copies of the JAX package's ``repro.baselines``, which are host numpy
there too and search one query at a time: the same inputs give the same
ids and distances bit for bit. They take no ``device=`` on purpose. This
is the reference's design, the comparison the paper draws against UDG,
and not a CPU fallback; a device version would be a feature the JAX
package lacks. UDG's own search is what runs on the card.
"""
from repro_torch.baselines.common import ProximityGraph, build_knn_graph, graph_search
from repro_torch.baselines.postfilter import PostFilterHNSW
from repro_torch.baselines.prefilter import PreFilter
from repro_torch.baselines.acorn import Acorn
from repro_torch.baselines.hipng import HiPNG

__all__ = [
    "Acorn",
    "HiPNG",
    "PostFilterHNSW",
    "PreFilter",
    "ProximityGraph",
    "build_knn_graph",
    "graph_search",
]
