"""The port's search and planned executor against the JAX package, on the CPU.

One index per relation is built and exported by the JAX package and carried
over unchanged (``device_graph_from_numpy``), so both packages search the
same index. The JAX side runs its jnp oracles (``use_ref=True``); the port
runs its plain PyTorch versions (``device="cpu"``). Per row: the same plan
and brute id list, ids equal under the tie rule of
``repro_torch.data.parity``, distances within its tolerance, recall@10 equal.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.exec as jexec
import repro.search as jsearch
from repro.core.predicates import RELATIONS
from repro.data import generate_queries, ground_truth, make_dataset, make_queries_vectors, recall_at_k
from repro.data.workloads import QuerySet
from repro_torch import resolve_device
from repro_torch.data.parity import mismatches
from repro_torch.exec import PlannerConfig, brute_topk_impl, execute_batch
from repro_torch.exec.estimator import STATE_FIELDS
from repro_torch.search import batched_udg_search, device_graph_from_numpy
from repro_torch.search.device_graph import GRAPH_FIELDS

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


@pytest.fixture(scope="module", params=sorted(RELATIONS))
def case(request):
    rel = request.param
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
        exports[dt] = (jdg, device_graph_from_numpy(graph_arrays(jdg), device="cpu"))
    return rel, qs, cfg, exports


def assert_same(qs, jax_out, torch_out):
    (ij, dj), (it, dt) = jax_out, torch_out
    assert it.shape == ij.shape and dt.shape == dj.shape
    bad = mismatches(ij, dj, it, dt)
    assert not bad, bad[:5]
    assert recall_at_k(it, qs) == recall_at_k(ij, qs)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("expand", [1, 2])
def test_graph_search_matches_jax(case, dtype, expand):
    rel, qs, _, exports = case
    jdg, tdg = exports[dtype]
    want = jsearch.batched_udg_search(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand, use_ref=True)
    got = batched_udg_search(
        tdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand, device="cpu")
    assert_same(qs, want, got)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("plan", ["auto", "wide", "brute"])
def test_planned_execution_matches_jax(case, plan, dtype, expand):
    rel, qs, cfg, exports = case
    jdg, tdg = exports[dtype]
    ij, dj, jpb = jexec.execute_batch(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand, plan=plan,
        config=jexec.PlannerConfig(**cfg), return_plans=True, use_ref=True)
    it, dt, tpb = execute_batch(
        tdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand, plan=plan,
        config=PlannerConfig(**cfg), return_plans=True, device="cpu")
    if plan == "auto":
        np.testing.assert_array_equal(tpb.plans, jpb.plans)
        np.testing.assert_array_equal(tpb.bf_ids, jpb.bf_ids)
        assert len(set(tpb.plans.tolist())) == 3, tpb.mix()   # every plan has rows
    else:
        assert tpb is None and jpb is None
    assert_same(qs, (ij, dj), (it, dt))


def test_loop_block_size_does_not_change_results(case):
    _, qs, _, exports = case
    tdg = exports["f32"][1]
    for expand in (1, 2):
        one = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, expand=expand,
                                 device="cpu", block=1)
        eight = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, expand=expand,
                                   device="cpu", block=8)
        np.testing.assert_array_equal(one[0], eight[0])
        np.testing.assert_array_equal(one[1].view(np.int32), eight[1].view(np.int32))


@pytest.mark.parametrize("block", [1, 2, 8])
def test_max_iters_stops_where_jax_stops(case, block):
    """A cap of 3 iterations cuts every row where the reference's while
    loop cuts it, whatever the block size between activity checks."""
    _, qs, _, exports = case
    jdg, tdg = exports["f32"]
    want = jsearch.batched_udg_search(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, max_iters=3, use_ref=True)
    got = batched_udg_search(
        tdg, qs.vectors, qs.s_q, qs.t_q, k=K, max_iters=3, device="cpu", block=block)
    assert not mismatches(*want, *got)
    full = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, device="cpu")
    assert not np.array_equal(full[0], got[0])      # the cap did cut the search


def test_brute_topk_breaks_distance_ties_toward_smaller_id():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    table[30] = table[7]          # rows 7 and 30 tie exactly for every query
    table[12] = table[25]
    norms = np.sum(table * table, axis=1)
    q = np.stack([table[7] + 0.01, table[25] - 0.01]).astype(np.float32)
    bf = np.array([[30, 3, 7, 11, -1, 9], [25, 12, -1, 3, 30, 7]], dtype=np.int32)
    ids, d = brute_topk_impl(torch.from_numpy(table), torch.from_numpy(norms),
                             torch.from_numpy(q), torch.from_numpy(bf), k=4)
    assert ids[0, :2].tolist() == [7, 30] and ids[1, :2].tolist() == [12, 25]
    jids, jd = jexec.brute_force_topk(table, norms, q, bf, k=4, use_ref=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert not mismatches(np.asarray(jids), np.asarray(jd), ids.numpy(), d.numpy())


def test_entry_points_need_a_device_or_cuda(case):
    """No silent CPU fallback: device=None means the card, and raises
    where there is none."""
    _, qs, _, exports = case
    tdg = exports["f32"][1]
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_batch(tdg, qs.vectors, qs.s_q, qs.t_q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdg.device()


def test_int32_label_export_is_not_searched(case):
    """An export without packed words (the rank-width fallback layout) is
    refused by the search rather than served by another branch."""
    _, qs, _, exports = case
    arrays = graph_arrays(exports["f32"][0])
    arrays["labels"] = jsearch.unpack_labels(arrays.pop("plabels"))
    tdg = device_graph_from_numpy(arrays, device="cpu")
    with pytest.raises(NotImplementedError, match="int32-label"):
        batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, device="cpu")
