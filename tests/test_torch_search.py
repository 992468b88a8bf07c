"""The port's search and planned executor against the JAX package, on the CPU.

One index per relation is built and exported by the JAX package and carried
over unchanged (``planned_graph_from_numpy``), so both packages search the
same index (``torch_cases``). The JAX side runs its jnp oracles
(``use_ref=True``); the port runs its plain PyTorch versions
(``device="cpu"``). Per row: the same plan and brute id list, ids equal under
the tie rule of ``repro_torch.data.parity``, distances within its tolerance,
recall@10 equal.
"""
import numpy as np
import pytest
import torch

import repro.exec as jexec
import repro.search as jsearch
from repro.core.predicates import RELATIONS
from repro_torch import resolve_device
from repro_torch.data.parity import mismatches
from repro_torch.exec import PlannerConfig, brute_topk_impl, execute_batch
from repro_torch.search import batched_udg_search
from torch_cases import K, assert_same, build_case, int32_export


@pytest.fixture(scope="module", params=sorted(RELATIONS))
def case(request):
    return build_case(request.param)


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
    searched through the int32 fused branch, which returns what the JAX
    package's int32 branch returns and the packed branch's ids and distances
    bit for bit."""
    _, qs, _, exports = case
    jdg, tdg = exports["f32"]
    idg = int32_export(jdg)
    assert idg.plabels is None and idg.serving_labels(device="cpu").shape[-1] == 4
    want = jsearch.batched_udg_search(
        jdg, qs.vectors, qs.s_q, qs.t_q, k=K, use_ref=True, packed=False)
    got = batched_udg_search(idg, qs.vectors, qs.s_q, qs.t_q, k=K, device="cpu")
    assert_same(qs, want, got)
    packed = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, device="cpu")
    np.testing.assert_array_equal(got[0], packed[0])
    np.testing.assert_array_equal(got[1].view(np.int32), packed[1].view(np.int32))
