"""The port's search counters (``stats=True``) against the JAX package's.

On the shared case of ``torch_cases`` (one JAX-built index per relation,
f32 and int8 exports carried over unchanged), every branch of the search
core (packed, int32, unfused) and every plan of the executor return per
query the same ``SearchStats`` as the reference, compared as integers, hop
tallies included; turning the counters on changes no result, no host sync
and no loop iteration; iterations after a row finished add nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jexec
import repro.obs as jobs
import repro.search as jsearch
from repro.core.predicates import RELATIONS
from repro_torch.exec import PlannerConfig, execute_batch
from repro_torch.obs import SearchStats, combine_stats, per_query_dict
from repro_torch.obs.stats import popcount32
from repro_torch.search import batched as search_mod
from repro_torch.search import batched_udg_search
from torch_cases import K, build_case

BRANCHES = {"packed": dict(), "int32": dict(packed=False), "unfused": dict(fused=False)}


@pytest.fixture(scope="module", params=sorted(RELATIONS))
def case(request):
    return build_case(request.param)


def assert_same_stats(want, got):
    """Every field equal as integers (the per-query ones and the hop tallies)."""
    assert set(SearchStats._fields) == set(jobs.SearchStats._fields)
    for name in SearchStats._fields:
        w = np.asarray(getattr(want, name)).astype(np.int64)
        g = np.asarray(getattr(got, name)).astype(np.int64)
        assert g.shape == w.shape, name
        bad = np.flatnonzero(g != w)
        assert bad.size == 0, f"{name} differs at {bad[:5]}: {g[bad[:5]]} vs {w[bad[:5]]}"


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_search_stats_match_jax(case, dtype, branch):
    _, qs, _, exports = case
    jdg, tdg = exports[dtype]
    kw = BRANCHES[branch]
    want = jsearch.batched_udg_search(jdg, qs.vectors, qs.s_q, qs.t_q, k=K, use_ref=True,
                                      stats=True, **kw)
    got = batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, stats=True,
                             device="cpu", **kw)
    assert_same_stats(want[2], got[2])
    assert got[2].iters.max() > 0 and got[2].kept.sum() > 0


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("plan", ["auto", "graph", "wide", "brute"])
def test_planned_stats_match_jax(case, dtype, plan):
    _, qs, cfg, exports = case
    jdg, tdg = exports[dtype]
    want = jexec.execute_batch(jdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan, use_ref=True,
                               config=jexec.PlannerConfig(**cfg), stats=True)
    got = execute_batch(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan,
                        config=PlannerConfig(**cfg), stats=True, device="cpu")
    assert_same_stats(want[-1], got[-1])
    if plan == "brute":
        assert not got[-1].iters.any()   # brute rows do no traversal


@pytest.mark.parametrize("branch", ["unfused", "int32"])
def test_planned_branch_stats_match_jax(case, branch):
    _, qs, cfg, exports = case
    jdg, tdg = exports["f32"]
    kw = BRANCHES[branch]
    want = jexec.execute_batch(jdg, qs.vectors, qs.s_q, qs.t_q, k=K, use_ref=True,
                               config=jexec.PlannerConfig(**cfg), stats=True, **kw)
    got = execute_batch(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, config=PlannerConfig(**cfg),
                        stats=True, device="cpu", **kw)
    assert_same_stats(want[-1], got[-1])


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_stats_change_no_result_sync_or_iteration(case, branch):
    _, qs, cfg, exports = case
    tdg = exports["f32"][1]
    kw = BRANCHES[branch]
    runs = []
    for stats in (False, True):
        for key in search_mod.LOOP_STATS:
            search_mod.LOOP_STATS[key] = 0
        out = execute_batch(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, config=PlannerConfig(**cfg),
                            stats=stats, device="cpu", **kw)
        runs.append((out, dict(search_mod.LOOP_STATS)))
    (off, loop_off), (on, loop_on) = runs
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1].view(np.int32), off[1].view(np.int32))
    assert loop_on == loop_off


def test_iterations_after_a_row_finished_add_nothing(case):
    """The block loop runs up to ``block - 1`` no-op iterations past the
    reference's stop; the counters are the same for any block size."""
    _, qs, _, exports = case
    tdg = exports["f32"][1]
    one, eight = (batched_udg_search(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, stats=True,
                                     device="cpu", block=b)[2] for b in (1, 8))
    assert_same_stats(one, eight)


def test_combine_stats_pads_hop_axes():
    def make(hit, H):
        ones = torch.ones(2, dtype=torch.int32)
        return SearchStats(*(ones for _ in range(7)), torch.full((2,), hit), ones,
                           torch.ones(H, dtype=torch.int32), torch.ones(H, dtype=torch.int32))

    m = combine_stats(make(False, 3), make(True, 5))
    assert m.hop_total.shape == (5,)
    np.testing.assert_array_equal(m.hop_total.numpy(), [2, 2, 2, 1, 1])
    assert bool((m.iters == 2).all()) and bool(m.hit_max_iters.all())
    d = per_query_dict(m)
    assert set(d) == set(SearchStats._fields) - {"hop_valid", "hop_total"}
    # as the reference's
    j = jobs.combine_stats(
        jobs.SearchStats(*(jnp.ones(2, jnp.int32) for _ in range(7)), jnp.zeros(2, bool),
                         jnp.ones(2, jnp.int32), jnp.ones(3, jnp.int32), jnp.ones(3, jnp.int32)),
        jobs.SearchStats(*(jnp.ones(2, jnp.int32) for _ in range(7)), jnp.ones(2, bool),
                         jnp.ones(2, jnp.int32), jnp.ones(5, jnp.int32), jnp.ones(5, jnp.int32)))
    assert_same_stats(j, m)


def test_popcount_counts_every_bit():
    rng = np.random.default_rng(0)
    words = rng.integers(-2**31, 2**31, size=(6, 40), dtype=np.int64).astype(np.int32)
    words[0, :3] = [-1, 0, -2**31]
    want = np.array([[bin(int(w) & 0xFFFFFFFF).count("1") for w in row] for row in words])
    np.testing.assert_array_equal(popcount32(torch.from_numpy(words)).numpy(), want)
