"""The port's wave constructor against the JAX package's, on the CPU.

``repro_torch.core.build_udg_batched(device="cpu")`` (the plain versions of
the kernels) against ``repro.core.build_batched.build_udg_batched(use_ref=
True)`` on the reference's own test case (``tests/test_batched_build.py``:
``make_dataset(1100, 16, seed=3)``, M=8, Z=32, K_p=4, wave=128), containment
and overlap.

Tuples are compared under a tie rule: per node the same tuples, in the same
order except where two neighbors sit at near-tied distances from the
inserted node (``|Δd| <= 1e-5·d`` in exact arithmetic). The port sums each
distance in f64 and rounds once; the reference sums in f32; at a near tie
the two can order a PRUNE's neighbors differently (node 901 of seed 3:
2.0086054 vs 2.0086065, ROADMAP C). The 0.5 pt recall rule of
``BENCH_build.json`` holds the wave graph against the sequential one.
"""
import numpy as np
import pytest

import repro.core.build_batched as jbb
import repro.search as jsearch
import repro_torch.core as tcore
import repro_torch.core.build_batched as tbb
from repro.data import generate_queries, ground_truth, make_dataset, make_queries_vectors, recall_at_k
from repro_torch.exec import export_planned_graph
from repro_torch.search import BroadExport, batched_udg_search

N, DIM, NQ, K = 1100, 16, 32, 10
BUILD_KW = dict(M=8, Z=32, K_p=4)
REPORT_COUNTS = ("n", "num_tuples", "num_patch_tuples", "sweep_rounds",
                 "broad_searches", "index_bytes", "waves")


def assert_same_graph(jg, tg, vectors):
    """Tuple for tuple, but for neighbors at near-tied distances whose order
    may differ (see the module docstring)."""
    assert tg.n == jg.n and tg.num_tuples == jg.num_tuples
    assert tg.num_patch_tuples == jg.num_patch_tuples
    v = np.asarray(vectors, np.float64)
    for u in range(jg.n):
        a, b = np.stack(jg.tuples(u), 1), np.stack(tg.tuples(u), 1)
        if np.array_equal(a, b):
            continue
        assert sorted(map(tuple, a.tolist())) == sorted(map(tuple, b.tolist())), u
        moved = np.flatnonzero((a != b).any(axis=1))
        d = ((v[a[moved, 0]] - v[u]) ** 2).sum(axis=1)
        assert d.max() - d.min() <= 1e-5 * d.max(), (u, a[moved, 0], d)


def assert_same_report(jr, tr):
    for f in REPORT_COUNTS:
        assert getattr(tr, f) == getattr(jr, f), f


@pytest.fixture(scope="module", params=["containment", "overlap"])
def built(request):
    rel = request.param
    vecs, s, t = make_dataset(N, DIM, seed=3)
    jg, jr = jbb.build_udg_batched(vecs, s, t, rel, wave=128, use_ref=True, **BUILD_KW)
    tg, tr = tbb.build_udg_batched(vecs, s, t, rel, wave=128, device="cpu", **BUILD_KW)
    return rel, (vecs, s, t), (jg, jr), (tg, tr)


def test_wave_build_gives_the_reference_graph(built):
    _, (vecs, _, _), (jg, jr), (tg, tr) = built
    assert_same_graph(jg, tg, vecs)
    assert_same_report(jr, tr)
    assert tr.waves == (N + 127) // 128 and tr.broad_searches == tr.waves - 1
    assert 0.0 < tr.search_seconds < tr.seconds


def _recall(g, vecs, s, t, rel, sigma=0.1):
    qv = make_queries_vectors(NQ, DIM, seed=9)
    qs = ground_truth(generate_queries(qv, s, t, rel, sigma, k=K, seed=10), vecs, s, t)
    dg = export_planned_graph(g, tcore.EntryTable(g), device="cpu")
    ids, _ = batched_udg_search(dg, qs.vectors, qs.s_q, qs.t_q, k=K, beam=64, device="cpu")
    return float(recall_at_k(ids, qs))


def test_wave_build_recall_within_half_a_point_of_sequential(built):
    rel, (vecs, s, t), _, (tg, _) = built
    g_seq, rep_seq = tcore.build_udg(vecs, s, t, rel, batched=False, **BUILD_KW)
    assert rep_seq.waves == 0 and rep_seq.broad_searches == N - 1
    r_seq, r_bat = _recall(g_seq, vecs, s, t, rel), _recall(tg, vecs, s, t, rel)
    assert r_bat >= r_seq - 0.005, (r_bat, r_seq)


def test_wave_size_one_matches_the_reference():
    vecs, s, t = make_dataset(90, DIM, seed=4)
    jg, jr = jbb.build_udg_batched(vecs, s, t, "containment", wave=1, use_ref=True, **BUILD_KW)
    tg, tr = tbb.build_udg_batched(vecs, s, t, "containment", wave=1, device="cpu", **BUILD_KW)
    assert tr.waves == 90 and tr.broad_searches == 89
    assert_same_graph(jg, tg, vecs)
    assert_same_report(jr, tr)


def test_concurrent_build_equals_per_graph_builds():
    parts = [make_dataset(n, DIM, seed=sd) for n, sd in ((300, 11), (180, 12), (240, 13))]
    kw = dict(wave=64, pad_nodes=512, device="cpu", **BUILD_KW)
    together = tbb.build_graphs_concurrent(parts, "overlap", **kw)
    for (vecs, s, t), (g, rep) in zip(parts, together):
        g1, rep1 = tbb.build_udg_batched(vecs, s, t, "overlap", **kw)
        assert g.num_tuples == g1.num_tuples and rep.waves == rep1.waves
        for u in range(g.n):
            for a, b in zip(g.tuples(u), g1.tuples(u)):
                np.testing.assert_array_equal(a, b)


def test_broad_export_equals_the_reference():
    """The same ``add_edges`` sequence as ``tests/test_batched_build.py``
    (dedup, self loops, growth, reverse-only growth, capped rows) leaves
    the same table in both packages."""
    rng = np.random.default_rng(0)
    for kw in (dict(init_degree=4, lane=4), dict(init_degree=4, lane=4, max_width=8),
               dict(init_degree=64, lane=32, max_width=40)):
        jb, tb = jsearch.BroadExport(64, **kw), BroadExport(64, **kw)
        steps = [(0, np.array([1, 2, 3, 1, 0])), (0, np.arange(1, 20))]
        steps += [(u, np.array([0])) for u in range(20, 30)]
        steps += [(int(rng.integers(64)), rng.integers(0, 64, size=int(rng.integers(1, 12))))
                  for _ in range(200)]
        for u, vs in steps:
            jb.add_edges(u, vs)
            tb.add_edges(u, vs)
            assert tb.max_degree == jb.max_degree
            assert tb.export_width() == jb.export_width()
            np.testing.assert_array_equal(tb.view(), jb.view())
        np.testing.assert_array_equal(tb.view(4), jb.view(4))


def test_auto_dispatch_switches_at_the_threshold(monkeypatch):
    """``batched=None`` builds sequentially below ``BATCHED_AUTO_MIN_N``
    objects and in waves at it, on the device it is given, as the reference
    (``repro.core.build``) switches."""
    import repro.core.build as jbuild

    assert tcore.BATCHED_AUTO_MIN_N == jbuild.BATCHED_AUTO_MIN_N == 4096
    calls = []

    def wave_build(vectors, *args, **kwargs):
        calls.append((vectors.shape[0], kwargs["device"], kwargs["wave"]))
        return None, None

    monkeypatch.setattr(tbb, "build_udg_batched", wave_build)
    n = tcore.BATCHED_AUTO_MIN_N
    vecs, s, t = make_dataset(n, 2, seed=0)
    tcore.build_udg(vecs, s, t, "containment", M=2, Z=4, wave=512, device="cpu")
    assert calls == [(n, "cpu", 512)]
    g, _, rep = tcore.build_index(vecs[:-1], s[:-1], t[:-1], "containment", M=2, Z=4)
    assert rep.waves == 0 and rep.broad_searches == n - 2 and len(calls) == 1
