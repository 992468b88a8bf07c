"""The port's hybrid-search baselines against the JAX package's, on the CPU.

Both packages run the baselines as host numpy, one query at a time, so the
same inputs (``make_dataset(1200, 16, seed=10)`` and the ``query_vectors``
fixture, as ``tests/test_baselines.py`` uses them) must give the same ids
and distances bit for bit: PostFilter and ACORN over three relations at
ef 16 and 64, Hi-PNG over containment, PreFilter over all five relations.
Also held: ``build_knn_graph``'s adjacency and ``index_bytes`` equal,
PreFilter exact against ``ground_truth``, Hi-PNG containment-only, and
only valid ids returned.
"""
import numpy as np
import pytest

import repro.baselines as jb
import repro_torch.baselines as tb
from repro.core.predicates import RELATIONS
from repro.data import generate_queries, ground_truth, make_dataset, recall_at_k
from repro_torch.core.predicates import get_relation
from torch_cases import K  # noqa: F401  (pins torch to one thread)

from conftest import pad_ids

GRAPH_RELATIONS = ("containment", "overlap", "both_after")
EFS = (16, 64)
# query_within_data needs a data interval around the query's: at 1200 capped
# uniform intervals 0.01 is the highest selectivity it reaches
SELECTIVITY = {rel: 0.05 for rel in RELATIONS}
SELECTIVITY["query_within_data"] = 0.01
MAKERS = {
    "postfilter": lambda m: m.PostFilterHNSW(M=10, ef_construction=48),
    "acorn": lambda m: m.Acorn(M=10, gamma=6, ef_construction=48),
    "hipng": lambda m: m.HiPNG(M=10, ef_construction=32, leaf_size=128, min_graph_size=96),
    "prefilter": lambda m: m.PreFilter(),
}


@pytest.fixture(scope="module")
def data():
    return make_dataset(1200, 16, seed=10)


@pytest.fixture(scope="module")
def queries(data, query_vectors):
    """``relation`` -> its query set with exact ground truth, made once."""
    made = {}

    def get(relation):
        if relation not in made:
            vecs, s, t = data
            qs = generate_queries(query_vectors, s, t, relation, SELECTIVITY[relation], k=10,
                                  seed=11)
            made[relation] = ground_truth(qs, vecs, s, t)
        return made[relation]
    return get


@pytest.fixture(scope="module")
def built(data):
    """``(method, relation)`` -> (JAX package's, port's) baseline built on
    ``data``, built once."""
    made = {}

    def get(method, relation):
        if (method, relation) not in made:
            vecs, s, t = data
            pair = [MAKERS[method](mod) for mod in (jb, tb)]
            for b in pair:
                b.build(vecs, s, t, relation)
            made[method, relation] = tuple(pair)
        return made[method, relation]
    return get


def _same_answers(jax_b, port_b, qs, ef):
    for i in range(qs.nq):
        args = (qs.vectors[i], qs.s_q[i], qs.t_q[i], 10, ef)
        ji, jd = (np.asarray(a) for a in jax_b.search(*args))
        pi, pd = port_b.search(*args)
        assert pi.dtype == ji.dtype and pd.dtype == jd.dtype
        np.testing.assert_array_equal(pi, ji, err_msg=f"query {i}")
        np.testing.assert_array_equal(pd.view(np.int32), jd.view(np.int32), err_msg=f"query {i}")


@pytest.mark.parametrize("ef", EFS)
@pytest.mark.parametrize("relation", GRAPH_RELATIONS)
@pytest.mark.parametrize("method", ["postfilter", "acorn"])
def test_graph_baselines_bit_identical(built, queries, method, relation, ef):
    jax_b, port_b = built(method, relation)
    assert port_b.index_bytes == jax_b.index_bytes
    _same_answers(jax_b, port_b, queries(relation), ef)


@pytest.mark.parametrize("ef", EFS)
def test_hipng_bit_identical(built, queries, ef):
    jax_b, port_b = built("hipng", "containment")
    assert port_b.index_bytes == jax_b.index_bytes
    _same_answers(jax_b, port_b, queries("containment"), ef)


@pytest.mark.parametrize("relation", RELATIONS)
def test_prefilter_bit_identical_and_exact(built, queries, relation):
    jax_b, port_b = built("prefilter", relation)
    assert port_b.index_bytes == jax_b.index_bytes
    qs = queries(relation)
    _same_answers(jax_b, port_b, qs, 0)
    res = np.stack([pad_ids(port_b.search(qs.vectors[i], qs.s_q[i], qs.t_q[i], 10)[0], 10)
                    for i in range(qs.nq)])
    np.testing.assert_array_equal(res, qs.gt_ids)
    assert recall_at_k(res, qs) == 1.0


@pytest.mark.parametrize("rule", [dict(diversify=True), dict(diversify=False),
                                  dict(keep_per_node=24, max_degree=48, diversify=False)])
def test_build_knn_graph_adjacency_equal(data, rule):
    vecs = data[0][:400]
    jg = jb.build_knn_graph(vecs, 8, 32, **rule)
    pg = tb.build_knn_graph(vecs, 8, 32, **rule)
    assert pg.n == jg.n and pg.max_degree == jg.max_degree
    for u in range(pg.n):
        np.testing.assert_array_equal(pg.adj[u], jg.adj[u], err_msg=f"node {u}")
    assert pg.index_bytes() == jg.index_bytes()
    q = data[0][1000]
    for a, b in zip(tb.graph_search(pg, q, 0, 32), jb.graph_search(jg, q, 0, 32)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("relation", ["overlap", "both_after"])
def test_hipng_is_containment_only(data, relation):
    vecs, s, t = data
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="containment"):
            mod.HiPNG().build(vecs, s, t, relation)


@pytest.mark.parametrize("method", ["postfilter", "acorn", "hipng", "prefilter"])
def test_only_valid_ids(data, built, queries, method):
    vecs, s, t = data
    rel = get_relation("containment")
    _, port_b = built(method, "containment")
    qs = queries("containment")
    for i in range(qs.nq):
        ids, d = port_b.search(qs.vectors[i], qs.s_q[i], qs.t_q[i], 10, 32)
        mask = rel.valid_mask(s, t, qs.s_q[i], qs.t_q[i])
        assert ids.size and mask[ids].all(), f"{method} query {i}"
        assert np.all(np.diff(d) >= 0)


def test_prefilter_keeps_the_references_order_of_exact_ties(data, query_vectors):
    """ROADMAP C4: duplicated rows tie exactly; both packages leave the tie
    in ``argpartition``'s order (the ground truth puts the smaller id
    first), so the port stays bit-identical to the reference, and equal
    to the ground truth as (distance, id) pairs."""
    vecs, s, t = data
    vecs = vecs.copy()
    vecs[600:1200] = vecs[:600]                   # every row has a twin
    qs = generate_queries(query_vectors, s, t, "containment", 0.05, k=10, seed=11)
    qs = ground_truth(qs, vecs, s, t)
    jax_b, port_b = jb.PreFilter(), tb.PreFilter()
    for b in (jax_b, port_b):
        b.build(vecs, s, t, "containment")
    _same_answers(jax_b, port_b, qs, 0)
    for i in range(qs.nq):
        ids, d = port_b.search(qs.vectors[i], qs.s_q[i], qs.t_q[i], 10)
        np.testing.assert_array_equal(d, qs.gt_dists[i])
        for dist in np.unique(d):
            assert set(ids[d == dist]) == set(qs.gt_ids[i][qs.gt_dists[i] == dist])
