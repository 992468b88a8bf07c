"""The shared parity case of the port's search tests.

One index per relation is built and exported by the JAX package and carried
over unchanged (``planned_graph_from_numpy``), so both packages search the
same index; queries span three selectivities, and the planner thresholds
give every plan rows at n = 600.

Importing it also pins torch to one CPU thread: the suite runs in several
test processes at once (every one of them imports this module while it
collects), and torch's default of one thread per core in each of them
oversubscribes the cores.
"""
import numpy as np
import torch

import repro.core as jcore
import repro.search as jsearch
from repro.core.predicates import RELATIONS
from repro.data import generate_queries, ground_truth, make_dataset, make_queries_vectors, recall_at_k
from repro.data.workloads import QuerySet
from repro_torch.data.parity import mismatches
from repro_torch.exec import planned_graph_from_numpy
from repro_torch.exec.estimator import STATE_FIELDS
from repro_torch.search.device_graph import GRAPH_FIELDS

torch.set_num_threads(1)

N, D, NQ, K = 600, 16, 24, 10
# per relation: interval distribution, selectivities (query i takes
# sels[i % 3]), and planner thresholds that give each plan rows at N=600
CASES = {
    rel: ("uniform", (0.02, 0.15, 0.5), dict(brute_max_valid=32, wide_max_fraction=0.3))
    for rel in RELATIONS
}
# feasible only with uncapped data intervals, at low selectivity
CASES["query_within_data"] = (
    "uncapped", (0.01, 0.03, 0.05), dict(brute_max_valid=16, wide_max_fraction=0.05))


def graph_arrays(dg) -> dict:
    """The numpy fields of a JAX ``DeviceGraph`` export and its planner."""
    out = {f: getattr(dg, f) for f in GRAPH_FIELDS}
    out.update({f: getattr(dg.planner, f) for f in STATE_FIELDS})
    return out


def int32_export(jdg):
    """The port's view of the JAX export ``jdg`` with its labels unpacked to
    the int32 layout, as an export over a too-wide rank grid carries them."""
    arrays = graph_arrays(jdg)
    arrays["labels"] = jsearch.unpack_labels(arrays.pop("plabels"))
    return planned_graph_from_numpy(arrays, device="cpu")


def build_case(rel):
    """(relation, query set with ground truth, planner config, {dtype:
    (JAX export, port export)}) for one relation."""
    dist, sels, cfg = CASES[rel]
    vecs, s, t = make_dataset(N, D, distribution=dist, seed=0)
    g, et, _ = jcore.build_index(vecs, s, t, rel, batched=False)
    qv = make_queries_vectors(NQ, D, seed=1)
    s_q, t_q = np.empty(NQ), np.empty(NQ)
    for j, sel in enumerate(sels):
        idx = np.arange(j, NQ, len(sels))
        part = generate_queries(qv[idx], s, t, rel, sel, k=K, seed=j)
        s_q[idx], t_q[idx] = part.s_q, part.t_q
    qs = ground_truth(QuerySet(rel, qv, s_q, t_q, 0.0, np.zeros(NQ), K), vecs, s, t)
    exports = {}
    for dt, quant in (("f32", False), ("int8", True)):
        jdg = jsearch.export_device_graph(g, et, quantize_int8=quant)
        exports[dt] = (jdg, planned_graph_from_numpy(graph_arrays(jdg), device="cpu"))
    return rel, qs, cfg, exports


def assert_same(qs, jax_out, torch_out):
    (ij, dj), (it, dt) = jax_out, torch_out
    assert it.shape == ij.shape and dt.shape == dj.shape
    bad = mismatches(ij, dj, it, dt)
    assert not bad, bad[:5]
    assert recall_at_k(it, qs) == recall_at_k(ij, qs)



