"""The search core's int32, unfused and broad branches against the JAX package.

On the shared case of ``torch_cases`` (one JAX-built index per relation,
f32 and int8 exports): the port's int32 fused branch (an export carrying
int32 labels), its ``fused=False`` branch and ``execute_batch(fused=False)``
under every plan return what the JAX package's same branches return, ids
under the tie rule of ``repro_torch.data.parity`` and recall@10 equal; the
port's packed, int32 and unfused branches agree among themselves as the
reference's do (``tests/test_packed_labels.py``); the broad label-ignoring
search matches the reference's ``broad_batched_search`` over the same broad
adjacency; ``packed=False`` forces the int32 branch on a packed export, and
``packed=True`` refuses an export without packed words, in both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jexec
import repro.search as jsearch
from repro.core.predicates import RELATIONS
from repro_torch.data.parity import mismatches
from repro_torch.exec import PlannerConfig, brute_force_topk, execute_batch
from repro_torch.search import (
    BroadExport,
    batched_udg_search,
    broad_batched_search,
    prepare_states,
)
from torch_cases import K, assert_same, build_case, int32_export


@pytest.fixture(scope="module", params=sorted(RELATIONS))
def case(request):
    return build_case(request.param)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("branch,expand", [("int32", 1), ("int32", 2), ("unfused", 1)])
def test_branch_matches_jax(case, dtype, branch, expand):
    _, qs, _, exports = case
    jdg, tdg = exports[dtype]
    if branch == "int32":
        want = jsearch.batched_udg_search(
            jdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand, use_ref=True, packed=False)
        got = batched_udg_search(int32_export(jdg), qs.vectors, qs.s_q, qs.t_q, k=K,
                                 expand=expand, device="cpu")
    else:
        want = jsearch.batched_udg_search(
            jdg, qs.vectors, qs.s_q, qs.t_q, k=K, use_ref=True, fused=False)
        got = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, fused=False,
                                 device="cpu")
    assert_same(qs, want, got)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("plan", ["auto", "graph", "wide", "brute"])
def test_unfused_execution_matches_jax(case, plan, dtype):
    rel, qs, cfg, exports = case
    jdg, tdg = exports[dtype]
    ij, dj, jpb = jexec.execute_batch(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan, fused=False,
        config=jexec.PlannerConfig(**cfg), return_plans=True, use_ref=True)
    it, dt, tpb = execute_batch(
        tdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan, fused=False,
        config=PlannerConfig(**cfg), return_plans=True, device="cpu")
    if plan == "auto":
        np.testing.assert_array_equal(tpb.plans, jpb.plans)
    assert_same(qs, (ij, dj), (it, dt))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_packed_int32_and_unfused_branches_agree(case, dtype):
    """As ``tests/test_packed_labels.py`` pins the reference's branches:
    packed and int32 give the same ids and distances bit for bit; the
    unfused branch (norms recomputed from the rows) the same ids and
    distances within ``atol=1e-4``."""
    _, qs, _, exports = case
    jdg, tdg = exports[dtype]
    packed = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, device="cpu")
    int32 = batched_udg_search(int32_export(jdg), qs.vectors, qs.s_q, qs.t_q, k=K,
                               device="cpu")
    unfused = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, fused=False,
                                 device="cpu")
    np.testing.assert_array_equal(packed[0], int32[0])
    np.testing.assert_array_equal(packed[1].view(np.int32), int32[1].view(np.int32))
    assert not mismatches(*packed, *unfused)
    np.testing.assert_allclose(unfused[1], packed[1], atol=1e-4)


def test_unfused_branch_is_bitwise_on_the_ports_own_export():
    """The port's export caches norms summed as the unfused scorer
    recomputes them, so on an f32 export the two paths give the same ids
    and distances bit for bit, the planned executor's too (the widened beam
    with expand 1 on both, as the unfused executor runs it)."""
    import dataclasses

    import repro_torch.core as tcore
    from repro.data import generate_queries, make_dataset, make_queries_vectors
    from repro_torch.exec import export_planned_graph

    vecs, s, t = make_dataset(600, 16, seed=0)
    g, et, _ = tcore.build_index(vecs, s, t, "overlap", batched=False)
    dg = export_planned_graph(g, et, device="cpu")
    qv = make_queries_vectors(24, 16, seed=1)
    qs = generate_queries(qv, s, t, "overlap", 0.15, k=K, seed=2)
    fused = batched_udg_search(dg, qs.vectors, qs.s_q, qs.t_q, k=K, device="cpu")
    unfused = batched_udg_search(dg, qs.vectors, qs.s_q, qs.t_q, k=K, fused=False, device="cpu")
    cfg = dataclasses.replace(PlannerConfig(brute_max_valid=32, wide_max_fraction=0.3), wide_expand=1)
    planned = [execute_batch(dg, qs.vectors, qs.s_q, qs.t_q, k=K, config=cfg, fused=f,
                             device="cpu") for f in (True, False)]
    for a, b in ((fused, unfused), planned):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32))


@pytest.mark.parametrize("branch", ["int32", "unfused"])
def test_block_size_does_not_change_the_branch(case, branch):
    """Iterations after a row finished are no-ops on these branches too."""
    _, qs, _, exports = case
    jdg, tdg = exports["f32"]
    dg, fused = (int32_export(jdg), True) if branch == "int32" else (tdg, False)
    one = batched_udg_search(dg, qs.vectors, qs.s_q, qs.t_q, fused=fused, device="cpu", block=1)
    eight = batched_udg_search(dg, qs.vectors, qs.s_q, qs.t_q, fused=fused, device="cpu", block=8)
    np.testing.assert_array_equal(one[0], eight[0])
    np.testing.assert_array_equal(one[1].view(np.int32), eight[1].view(np.int32))


def test_unfused_branch_refuses_packed_labels_and_multi_expand(case):
    _, qs, _, exports = case
    tdg = exports["f32"][1]
    with pytest.raises(ValueError, match="expand"):
        batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, fused=False, expand=2,
                           device="cpu")
    from repro_torch.search import search_core

    di = tdg.device("cpu")
    q = torch.zeros((1, di.table.shape[1]))
    with pytest.raises(ValueError, match="int32"):
        search_core(di.table, di.nbr, di.labels, q, torch.zeros((1, 2), dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), k=K, beam=16, max_iters=4,
                    norms=di.norms, fused=False)


def _broad_adjacency(jdg, width):
    """A capped broad adjacency over the export's neighbor lists."""
    bx = BroadExport(jdg.nbr.shape[0], init_degree=width, max_width=width)
    for u in range(jdg.nbr.shape[0]):
        row = jdg.nbr[u]
        bx.add_edges(u, row[row >= 0])
    return bx.view()


@pytest.mark.parametrize("fused,expand", [(True, 1), (True, 4), (False, 1)])
def test_broad_search_matches_jax(case, fused, expand):
    """The constructor's label-ignoring search: the wave's objects searched
    from one entry over a broad adjacency, as ``_WaveBuildState.dispatch``
    calls it (k = beam = Z, padding rows with ep = -1)."""
    _, qs, _, exports = case
    jdg = exports["f32"][0]
    Z = 16
    nbr = _broad_adjacency(jdg, 32)
    table = np.asarray(jdg.vectors, np.float32)
    norms = np.einsum("ij,ij->i", table, table).astype(np.float32)
    ep = np.full(qs.vectors.shape[0], 5, np.int32)
    ep[-3:] = -1
    q = np.asarray(qs.vectors, np.float32)
    want = jsearch.broad_batched_search(
        jnp.asarray(table), jnp.asarray(norms), jnp.asarray(nbr), jnp.asarray(q),
        jnp.asarray(ep), k=Z, beam=Z, expand=expand, fused=fused, use_ref=True)
    got = broad_batched_search(
        torch.from_numpy(table), torch.from_numpy(norms),
        torch.from_numpy(np.ascontiguousarray(nbr)), torch.from_numpy(q),
        torch.from_numpy(ep), k=Z, beam=Z, expand=expand, fused=fused)
    got = (got[0].numpy(), got[1].numpy())
    want = (np.asarray(want[0]), np.asarray(want[1]))
    assert not mismatches(*want, *got)
    assert (got[0][-3:] == -1).all() and np.isinf(got[1][-3:]).all()
    assert (got[0][:-3] >= 0).all()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("expand", [1, 2])
def test_packed_false_forces_the_int32_branch(case, dtype, expand):
    """``packed=False`` on the packed export runs the int32 fused branch:
    what the reference's ``packed=False`` returns, and the int32 export's
    results bit for bit."""
    _, qs, _, exports = case
    jdg, tdg = exports[dtype]
    want = jsearch.batched_udg_search(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand, use_ref=True, packed=False)
    got = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, expand=expand,
                             packed=False, device="cpu")
    assert_same(qs, want, got)
    i32 = batched_udg_search(int32_export(jdg), qs.vectors, qs.s_q, qs.t_q, k=K,
                             expand=expand, device="cpu")
    np.testing.assert_array_equal(got[0], i32[0])
    np.testing.assert_array_equal(got[1].view(np.int32), i32[1].view(np.int32))
    assert tdg.serving_labels(packed=False, device="cpu").shape[-1] == 4


@pytest.mark.parametrize("plan", ["auto", "graph", "wide", "brute"])
def test_planned_packed_false_matches_jax(case, plan):
    rel, qs, cfg, exports = case
    jdg, tdg = exports["f32"]
    want = jexec.execute_batch(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan, packed=False,
        config=jexec.PlannerConfig(**cfg), use_ref=True)
    got = execute_batch(
        tdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan, packed=False,
        config=PlannerConfig(**cfg), device="cpu")
    assert_same(qs, want, got)


def test_packed_true_refuses_an_int32_export(case):
    _, qs, cfg, exports = case
    jdg, tdg = exports["f32"]
    idg = int32_export(jdg)
    for call in (
        lambda: batched_udg_search(idg, qs.vectors, qs.s_q, qs.t_q, packed=True, device="cpu"),
        lambda: execute_batch(idg, qs.vectors, qs.s_q, qs.t_q, packed=True,
                              config=PlannerConfig(**cfg), device="cpu"),
        lambda: idg.serving_labels(packed=True, fused=False, device="cpu"),
    ):
        with pytest.raises(ValueError, match="packed=True"):
            call()
    # as the reference refuses its own export with the labels unpacked
    jidg = dataclasses.replace(jdg, labels=jsearch.unpack_labels(jdg.plabels),
                               plabels=None, _cache=None)
    with pytest.raises(ValueError, match="packed=True"):
        jsearch.batched_udg_search(jidg, qs.vectors, qs.s_q, qs.t_q, packed=True,
                                   use_ref=True)
    # the packed export serves its words with packed=True
    assert tdg.serving_labels(packed=True, device="cpu") is tdg.device("cpu").labels


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_brute_force_topk_matches_jax(case, dtype):
    """The standalone brute scan over each query's exact valid set."""
    _, qs, _, exports = case
    jdg, tdg = exports[dtype]
    est = tdg.planner
    states, _ = prepare_states(tdg, qs.s_q, qs.t_q)
    V = 64
    bf = np.full((len(qs.vectors), V), -1, np.int32)
    for i, (a, c) in enumerate(states):
        ids = est.exact_valid_ids(int(a), int(c))[:V]
        bf[i, :ids.shape[0]] = ids
    di = tdg.device("cpu")
    ids, d = brute_force_topk(di.table, di.norms, torch.from_numpy(qs.vectors),
                              torch.from_numpy(bf), k=K, scales=di.scales)
    jdi = jdg.device()
    jids, jd = jexec.brute_force_topk(jdi.table, jdi.norms, jnp.asarray(qs.vectors),
                                      jnp.asarray(bf), k=K, use_ref=True, scales=jdi.scales)
    assert not mismatches(np.asarray(jids), np.asarray(jd), ids.numpy(), d.numpy())
    assert (ids.numpy() >= 0).sum() > 0
