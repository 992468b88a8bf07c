"""The port's segmented tier against the JAX package's, on the CPU.

One segmented index is built by the JAX package at its own tests' size
(``tests/test_segmented.py``: ``make_dataset(1500, 8, seed=7)``, overlap,
``cells_per_axis=3``, M 8, Z 32, K_p 4, int8) and carried across unchanged
(``segmented_index_from_numpy``), so both packages search the same index:
the JAX side on its jnp oracles (``use_ref=True``), the port on its plain
versions (``device="cpu"``). Held:

* ``SegmentGrid``, ``canonicalize_batch`` and both routers equal to the
  reference's for all five relations, and the router's completeness;
* the coarse and the refined routes equal to the reference's, bit for bit;
* ``search`` with ``plan`` auto (default and small-segment planner
  thresholds), graph, wide and brute, fused and unfused: ids and distances
  equal under the tie rule of ``repro_torch.data.parity`` (tolerance
  ``1e-5·max(1, |d|)``), recall@10 equal, counters equal as integers; where
  the fused candidate sets are equal, the reranked answer bit-equal;
* ``scheduler=True`` bit-equal to ``scheduler=False`` (results and
  counters), one dispatch against one per routed segment; an empty
  worklist dispatches nothing;
* ``SegmentStack`` offsets, ``blank_segment`` and ``set_segment`` identity;
  quarantine and lift; the byte accounting;
* a port build at the same size: the same segments, capacities and (under
  the near-tie rule of ``test_torch_build.py``) adjacency, recall within
  0.5 pt of the reference's;
* ``segments_to_sharded_index`` and ``serve_batch`` against the reference's
  (``torch_segmented_ref.py``, run once in a subprocess with four host
  devices), with and without a quarantined segment.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.exec as jexec
import repro.scale as jscale
import torch_segmented_ref as sref
from repro.core import get_relation as jax_relation
from repro.core.predicates import RELATIONS
from repro.core.predicates import DominanceSpace as JaxSpace
from repro.data import generate_queries, ground_truth, make_dataset, make_queries_vectors, recall_at_k
from repro.data.workloads import QuerySet
from repro_torch.core.predicates import DominanceSpace, get_relation
from repro_torch.data.parity import mismatches
from repro_torch.distributed import make_host_mesh
from repro_torch.exec import PlannerConfig
from repro_torch.scale import (
    SegmentGrid,
    build_segmented_index,
    canonicalize_batch,
    dispatch_count,
    segmented_index_from_numpy,
    worklist_capacity,
)
from repro_torch.search import SegmentStack
from repro_torch.serve import segments_to_sharded_index, serve_batch
from repro_torch.serve.distributed import STACK_FIELDS
from torch_cases import K  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
RELATION_NAMES = sorted(RELATIONS)
N, D, NQ = 1500, 8, 24
BUILD = dict(cells_per_axis=3, M=8, Z=32, K_p=4, quantize_int8=True)
SMALL = dict(brute_max_valid=32, wide_max_fraction=0.3)   # every plan at these segment sizes
SEARCHES = [(p, f) for p in ("auto", "auto-small", "graph", "wide", "brute") for f in (True, False)]


def carry(jidx):
    return segmented_index_from_numpy(*sref.index_arrays(jidx), device="cpu")


@pytest.fixture(scope="module")
def env():
    vecs, s, t = make_dataset(N, D, seed=7)
    jidx = jscale.build_segmented_index(vecs, s, t, "overlap", **BUILD)
    qv = make_queries_vectors(NQ, D, seed=11)
    s_q, t_q = np.empty(NQ), np.empty(NQ)
    for j, sel in enumerate((0.01, 0.08, 0.4)):
        rows = np.arange(j, NQ, 3)
        part = generate_queries(qv[rows], s, t, "overlap", sel, k=10, seed=3 + j)
        s_q[rows], t_q[rows] = part.s_q, part.t_q
    qs = ground_truth(QuerySet("overlap", qv, s_q, t_q, 0.0, np.zeros(NQ), 10), vecs, s, t)
    return dict(vecs=vecs, s=s, t=t, jidx=jidx, idx=carry(jidx), qs=qs)


def _kw(plan):
    if plan == "auto-small":
        return dict(plan="auto"), dict(config=jexec.PlannerConfig(**SMALL)), dict(
            config=PlannerConfig(**SMALL))
    return dict(plan=plan), {}, {}


def both(env, plan, fused, **kw):
    qs = env["qs"]
    common, jcfg, tcfg = _kw(plan)
    args = (qs.vectors, qs.s_q, qs.t_q)
    kw = dict(k=10, beam=64, fused=fused, return_route=True, stats=True, **common, **kw)
    want = env["jidx"].search(*args, use_ref=True, **kw, **jcfg)
    got = env["idx"].search(*args, **kw, **tcfg)
    return want, got


# --- grid, canonicalization, routers ----------------------------------------------


def _intervals(rng, n, T=100.0):
    s = rng.uniform(0, T, n)
    return s, s + rng.uniform(0, 0.3 * T, n)


@pytest.mark.parametrize("relname", RELATION_NAMES)
def test_grid_and_routers_equal_the_reference(relname):
    for seed in range(3):
        rng = np.random.default_rng(seed)
        s, t = _intervals(rng, 160)
        sq, tq = _intervals(rng, 32)
        rel, jrel = get_relation(relname), jax_relation(relname)
        space = DominanceSpace.from_intervals(rel, s, t)
        jspace = JaxSpace.from_intervals(jrel, s, t)
        x_q, y_q = rel.query_map(sq, tq)
        for g in (2, 3, 5):
            grid = SegmentGrid.from_space(space, g)
            jgrid = jscale.SegmentGrid.from_space(jspace, g)
            for f in ("edges_x", "edges_y", "vals_x", "vals_y"):
                np.testing.assert_array_equal(getattr(grid, f), getattr(jgrid, f), f)
            xr, yr = space.ranks()
            np.testing.assert_array_equal(grid.assign_ranks(xr, yr), jgrid.assign_ranks(xr, yr))
            np.testing.assert_array_equal(grid.assign_values(space.X, space.Y),
                                          jgrid.assign_values(space.X, space.Y))
            a, c, valid = canonicalize_batch(space, x_q, y_q)
            for got, want in zip((a, c, valid), jscale.canonicalize_batch(jspace, x_q, y_q)):
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(grid.route_ranks(a, c, valid),
                                          jgrid.route_ranks(a, c, valid))
            np.testing.assert_array_equal(grid.route_values(x_q, y_q, valid),
                                          jgrid.route_values(x_q, y_q, valid))


@pytest.mark.parametrize("relname", RELATION_NAMES)
def test_router_completeness(relname):
    """Every valid object lives in a routed cell, for the rank and the
    value router (the reference's property, on the port's copy)."""
    rel = get_relation(relname)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        s, t = _intervals(rng, 160)
        X, Y = rel.transform_data(s, t)
        space = DominanceSpace.build(X, Y)
        sq, tq = _intervals(rng, 16)
        x_q, y_q = rel.query_map(sq, tq)
        a, c, valid = canonicalize_batch(space, x_q, y_q)
        for g in (2, 3, 5):
            grid = SegmentGrid.from_space(space, g)
            cell = grid.assign_ranks(*space.ranks())
            np.testing.assert_array_equal(grid.assign_values(X, Y), cell)
            route_r = grid.route_ranks(a, c, valid)
            route_v = grid.route_values(x_q, y_q, valid)
            for b in range(sq.shape[0]):
                vids = np.flatnonzero(rel.valid_mask(s, t, sq[b], tq[b]))
                if not valid[b]:
                    assert vids.size == 0 and not route_r[b].any() and not route_v[b].any()
                    continue
                assert route_r[b, cell[vids]].all() and route_v[b, cell[vids]].all(), (seed, g, b)


def test_routes_equal_the_reference(env):
    idx, jidx, qs = env["idx"], env["jidx"], env["qs"]
    for got, want in zip(idx.coarse_route(qs.s_q, qs.t_q), jidx.coarse_route(qs.s_q, qs.t_q)):
        np.testing.assert_array_equal(got, want)
    x_q, y_q, _, _, _ = idx._query_states(qs.s_q, qs.t_q)
    route, _ = idx.coarse_route(qs.s_q, qs.t_q)
    np.testing.assert_array_equal(idx._refine_route(route, x_q, y_q),
                                  jidx._refine_route(route, x_q, y_q))
    assert idx.num_segments == jidx.num_segments >= 4


def test_worklist_capacity_buckets():
    assert [worklist_capacity(w) for w in (0, 1, 7, 8, 9, 11, 39, 64, 65)] \
        == [8, 8, 8, 8, 10, 12, 40, 64, 80]
    for w in range(0, 3000, 7):
        assert worklist_capacity(w) == jscale.worklist_capacity(w)


# --- the segment stack ------------------------------------------------------------


def test_segment_stack_offsets_blank_and_set_segment(env):
    idx = env["idx"]
    ncap, E = idx.node_capacity, idx.edge_capacity
    st = SegmentStack(node_capacity=ncap, edge_capacity=E, device="cpu")
    for seg in idx.segments:
        st.append_segment(seg.dg, seg.ids)
    assert st.packed and st.quantized and st.num_segments == idx.num_segments
    nbr = st.flat("nbr").numpy()
    gids = st.flat("gids").numpy()
    for si, seg in enumerate(idx.segments):
        loc = seg.dg.nbr
        np.testing.assert_array_equal(nbr[si * ncap:(si + 1) * ncap],
                                      np.where(loc >= 0, loc + si * ncap, -1))
        want = np.full(ncap, -1, np.int32)
        want[: seg.ids.shape[0]] = seg.ids
        np.testing.assert_array_equal(gids[si * ncap:(si + 1) * ncap], want)
    np.testing.assert_array_equal(
        st.flat("labels_i32").numpy(),
        np.concatenate([seg.dg.labels_i32() for seg in idx.segments]))
    assert st.flat_labels(fused=False) is st.flat("labels_i32")
    assert st.flat_labels(fused=True) is st.flat("labels")
    before = [dict(st.part(i)) for i in range(st.num_segments)]
    flat0 = st.flat("table")
    st.blank_segment(1)
    blank = st.part(1)
    for key in ("table", "scales", "norms", "nbr", "labels", "gids"):
        assert blank[key].shape == before[1][key].shape and blank[key].dtype == before[1][key].dtype
    assert (blank["nbr"] == -1).all() and (blank["gids"] == -1).all() and not blank["table"].any()
    assert st.flat("table") is not flat0
    st.set_segment(1, idx.segments[1].dg, idx.segments[1].ids)
    for i in range(st.num_segments):
        for key in ("table", "scales", "norms", "nbr", "labels", "gids"):
            if i != 1:      # untouched parts keep their very tensors
                assert st.part(i)[key] is before[i][key], (i, key)
    assert st.part(1)["nbr"] is not before[1]["nbr"]
    np.testing.assert_array_equal(st.flat("nbr").numpy(), nbr)
    with pytest.raises(ValueError, match="node rows"):
        SegmentStack(node_capacity=ncap * 2, edge_capacity=E, device="cpu").append_segment(
            idx.segments[0].dg, idx.segments[0].ids)
    dev = st.nbytes_by_component()
    assert sum(dev.values()) == st.nbytes()
    assert dev["table"] == idx.num_segments * ncap * D and dev["labels"] == dev["nbr"] * 2


# --- search against the reference -------------------------------------------------


@pytest.mark.parametrize("plan,fused", SEARCHES)
def test_search_equals_the_reference(env, plan, fused):
    (ij, dj, rj, sj), (it, dt, rt, st) = both(env, plan, fused)
    np.testing.assert_array_equal(rt, rj)
    bad = mismatches(ij, dj, it, dt)
    assert not bad, bad[:5]
    assert recall_at_k(it, env["qs"]) == recall_at_k(ij, env["qs"])
    for name in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st, name)).astype(np.int64),
                                      np.asarray(getattr(sj, name)).astype(np.int64), name)
    # where the fused candidates are the same set, the rerank gives the
    # reference's answer bit for bit
    (cj, _, _, _), (ct, _, _, _) = both(env, plan, fused, rerank=False, fetch_k=20)
    same = [b for b in range(ct.shape[0]) if set(ct[b]) == set(cj[b])]
    assert len(same) >= ct.shape[0] // 2
    np.testing.assert_array_equal(it[same], ij[same])
    np.testing.assert_array_equal(dt[same].view(np.int32), dj[same].view(np.int32))


@pytest.mark.parametrize("plan,fused", SEARCHES)
def test_scheduler_equals_the_loop_bitwise(env, plan, fused):
    idx, qs = env["idx"], env["qs"]
    common, _, tcfg = _kw(plan)
    kw = dict(k=10, beam=64, fused=fused, stats=True, return_route=True, **common, **tcfg)
    for rerank in (False, True):
        d0 = dispatch_count()
        a = idx.search(qs.vectors, qs.s_q, qs.t_q, rerank=rerank, scheduler=True, **kw)
        d1 = dispatch_count()
        b = idx.search(qs.vectors, qs.s_q, qs.t_q, rerank=rerank, scheduler=False, **kw)
        d2 = dispatch_count()
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32))
        for name in a[3]._fields:
            np.testing.assert_array_equal(getattr(a[3], name), getattr(b[3], name), name)
        n_routed = int(a[2].any(axis=0).sum())
        assert n_routed >= 2 and d1 - d0 == 1 and d2 - d1 == n_routed


def test_empty_worklist_dispatches_nothing(env):
    idx = env["idx"]
    q = make_queries_vectors(4, D, seed=77)
    sq, tq = np.full(4, 1e9), np.full(4, 2e9)
    d0 = dispatch_count()
    ids, d, route, st = idx.search(q, sq, tq, k=5, return_route=True, stats=True)
    assert dispatch_count() == d0 and not route.any()
    assert np.all(ids == -1) and np.all(np.isinf(d))
    *_, st_l = idx.search(q, sq, tq, k=5, scheduler=False, stats=True)
    *_, st_j = env["jidx"].search(q, sq, tq, k=5, stats=True, use_ref=True)
    for name in st._fields:
        np.testing.assert_array_equal(getattr(st, name), getattr(st_l, name), name)
        np.testing.assert_array_equal(np.asarray(getattr(st, name)).astype(np.int64),
                                      np.asarray(getattr(st_j, name)).astype(np.int64), name)


def test_quarantine_and_lift(env):
    idx, qs = env["idx"], env["qs"]
    args = (qs.vectors, qs.s_q, qs.t_q)
    ids0, d0, route = idx.search(*args, k=10, return_route=True)
    victim = int(np.argmax(route.sum(axis=0)))
    stack = idx.device_stack()
    idx.quarantine_segment(victim)
    try:
        assert (stack.part(victim)["gids"] == -1).all()
        ids, d, info = idx.search(*args, k=10, return_partial=True)
        assert info.degraded and info.missing_segments == [victim]
        assert not np.isin(ids, idx.segments[victim].ids).any()
        loop = idx.search(*args, k=10, scheduler=False)
        np.testing.assert_array_equal(ids, loop[0])
        jidx = env["jidx"]
        jidx.quarantine_segment(victim)
        try:
            want = jidx.search(*args, k=10, use_ref=True, return_partial=True)
        finally:
            jidx.lift_quarantine(victim)
        assert want[2].missing_segments == info.missing_segments
        assert not mismatches(want[0], want[1], ids, d)
    finally:
        idx.lift_quarantine(victim)
    ids1, d1, info = idx.search(*args, k=10, return_partial=True)
    assert not info.degraded
    np.testing.assert_array_equal(ids1, ids0)
    np.testing.assert_array_equal(d1.view(np.int32), d0.view(np.int32))


def test_nbytes_by_component(env):
    idx, jidx = env["idx"], env["jidx"]
    comp = idx.nbytes_by_component()
    assert sum(comp.values()) == idx.nbytes()
    assert comp["router"] == idx.grid.nbytes() > 0
    assert comp["vec_q"] * 4 == comp["vectors"] and comp["scales"] == comp["norms"]
    assert comp == jidx.nbytes_by_component()


# --- a port build -----------------------------------------------------------------


def test_port_build_equals_the_reference_build(env):
    vecs, s, t, jidx, qs = env["vecs"], env["s"], env["t"], env["jidx"], env["qs"]
    tidx = build_segmented_index(vecs, s, t, "overlap", device="cpu", **BUILD)
    assert (tidx.node_capacity, tidx.edge_capacity, tidx.packed) == (
        jidx.node_capacity, jidx.edge_capacity, jidx.packed)
    v = vecs.astype(np.float64)
    for ts, js in zip(tidx.segments, jidx.segments):
        assert ts.cell == js.cell
        np.testing.assert_array_equal(ts.ids, js.ids)
        assert ts.report.num_tuples == js.report.num_tuples
        np.testing.assert_array_equal(ts.dg.vec_q, np.asarray(js.dg.vec_q))
        jlab = np.asarray(js.dg.plabels)
        for u in np.flatnonzero((ts.dg.nbr != np.asarray(js.dg.nbr)).any(axis=1)):
            # near-tie rule (tests/test_torch_build.py): the same tuples, in
            # another order only among neighbours at near-tied distances
            a = sorted(zip(js.dg.nbr[u].tolist(), jlab[u].tolist()))
            b = sorted(zip(ts.dg.nbr[u].tolist(), ts.dg.plabels[u].tolist()))
            assert a == b, (ts.cell, u)
            moved = np.flatnonzero(ts.dg.nbr[u] != np.asarray(js.dg.nbr)[u])
            g = ts.ids[ts.dg.nbr[u][moved]]
            d = ((v[g] - v[ts.ids[u]]) ** 2).sum(axis=1)
            assert d.max() - d.min() <= 1e-5 * d.max(), (ts.cell, u, d)
    r_t = recall_at_k(tidx.search(qs.vectors, qs.s_q, qs.t_q, k=10)[0], qs)
    r_j = recall_at_k(jidx.search(qs.vectors, qs.s_q, qs.t_q, k=10, use_ref=True)[0], qs)
    assert r_t >= r_j - 0.005, (r_t, r_j)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    vecs, s, t = make_dataset(64, 4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_segmented_index(vecs, s, t, "overlap", cells_per_axis=2, M=4, Z=8)


# --- segments served through the sharded step -----------------------------------


@pytest.fixture(scope="module")
def sharded_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("segmented_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, str(REPO / "tests" / "torch_segmented_ref.py"), str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return want, segmented_index_from_numpy(*sref.from_file(want), device="cpu")


@pytest.mark.parametrize("case", ["all", "quarantined"])
def test_segments_served_through_the_sharded_step(sharded_ref, case):
    want, idx = sharded_ref
    assert idx.num_segments == 4
    if case == "quarantined":
        idx.quarantine_segment(sref.QUARANTINED)
    try:
        sh, id_map = segments_to_sharded_index(idx)
    finally:
        idx.lift_quarantine(sref.QUARANTINED)
    p = case + "/"
    np.testing.assert_array_equal(id_map, want[p + "id_map"])
    for f in STACK_FIELDS:
        got, exp = getattr(sh, f), want[p + f]
        assert got.dtype == exp.dtype and got.shape == exp.shape, f
        if f == "norms":        # f64 lane order against an f32 einsum (ROADMAP C)
            np.testing.assert_allclose(got, exp, rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, exp, f)
    # the primed bundle: read by device(), derived from the stack, equal to
    # the host arrays; nothing staged again
    primed = sh._cache[("device", "cpu", None)]
    if case == "all":
        assert primed["labels"].data_ptr() == idx.device_stack("cpu").flat("labels").data_ptr()
    dev = sh.device("cpu")
    assert dev is primed and sh.device("cpu") is dev
    for f in STACK_FIELDS:
        host = getattr(sh, f)
        host = host.view(np.int32) if host.dtype == np.uint32 else host.copy()
        if case == "quarantined" and f in ("nbr", "labels"):   # the blanked slice
            host[sref.QUARANTINED] = -1 if f == "nbr" else 0
        np.testing.assert_array_equal(dev[f].numpy(), host, f)
    mesh = make_host_mesh(sh.num_shards, device="cpu")
    vecs, s, t = sref.dataset()
    qv, s_q, t_q = sref.queries(s, t)
    qs = ground_truth(QuerySet(sref.RELATION, qv, s_q, t_q, 0.0, np.zeros(sref.NQ), 10), vecs, s, t)
    rel = get_relation(sref.RELATION)
    for plan in ("auto", "graph"):
        for merge in sref.MERGES:
            ids, d = serve_batch(sh, mesh, qv, s_q, t_q, k=sref.K, beam=sref.BEAM, merge=merge,
                                 plan=plan, planner_config=PlannerConfig(**sref.PLANNER),
                                 id_map=id_map)
            key = p + f"{plan}/{merge}/"
            bad = mismatches(want[key + "ids"], want[key + "d"], ids, d)
            assert not bad, bad[:5]
            assert recall_at_k(ids, qs) == recall_at_k(want[key + "ids"], qs)
            for b in range(qv.shape[0]):
                row = ids[b][ids[b] >= 0]
                assert np.unique(row).size == row.size
                assert rel.valid_mask(s, t, s_q[b], t_q[b])[row].all()
            if case == "quarantined":
                assert not np.isin(ids, idx.segments[sref.QUARANTINED].ids).any()
