"""The frozen data generators against the program's originals, and the
vectorised exact-count generator against the original's construction."""
import json

import numpy as np
import pytest

from repro_torch.core.predicates import get_relation
from repro_torch.data import synthetic, workloads
from udg_bench import datagen, traffic
from udg_bench.conftest import ROOT


def test_frozen_vectors_and_intervals_equal_the_originals():
    np.testing.assert_array_equal(
        datagen.make_vectors(500, 24, clusters=16, spread=0.35, seed=3),
        synthetic.make_vectors(500, 24, clusters=16, spread=0.35, seed=3))
    s, t = datagen.make_intervals(5000, seed=4)
    s0, t0 = synthetic.make_intervals(5000, distribution="uniform", seed=4)
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(t, t0)
    np.testing.assert_array_equal(datagen.mixture_centers(24, clusters=16, seed=3),
                                  np.random.default_rng(3).normal(size=(16, 24)))


def test_bounds_copy_equals_the_original():
    from repro_torch.kernels import bounds as original
    from udg_bench import bounds

    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "CMP_OPS_PER_S"):
        assert getattr(bounds, name) == getattr(original, name)
    assert bounds.bound(3e9, 1e12, bounds.FP32_OPS_PER_S) == original.bound(3e9, 1e12, original.FP32_OPS_PER_S)
    kw = dict(slots=100, labels=7, label_bytes=8, words=9, rows_read=11, row_bytes=3076,
              queries=4, per_query=3080)
    assert bounds.scorer_bytes(**kw) == original.scorer_bytes(**kw)
    assert bounds.scorer_ops(5, 768) == original.scorer_ops(5, 768)
    assert bounds.row_bytes(768, 4, False) == original.row_bytes(768, 4, False)
    mk = dict(B=4, L=64, C=720, sector_bytes=512, words=3)
    assert bounds.merge_bytes(**mk) == original.merge_bytes(**mk)
    assert bounds.merge_ops(B=4, L=64, C=720, live=99) == original.merge_ops(B=4, L=64, C=720, live=99)


def test_suffix_order_statistic():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 40, size=300).astype(np.float64)      # ties
    for m in (1, 7, 150, 300):
        got = datagen.suffix_order_stat(y, m)
        for lo in range(300):
            want = np.partition(y[lo:], m - 1)[m - 1] if 300 - lo >= m else np.nan
            assert got[lo] == want or (np.isnan(want) and np.isnan(got[lo]))


@pytest.mark.parametrize("relation", ["containment", "overlap", "both_after", "both_before"])
@pytest.mark.parametrize("selectivity", [0.003, 0.03, 0.3])
def test_exact_counts_as_the_original_construction(relation, selectivity):
    """At each generated position, the original's statements (the X-suffix
    from the first occurrence of x_q, the m-th smallest Y by np.partition,
    the inverse mapping, the predicate's count) give the same interval and
    the same count; the counts are those the original reaches."""
    n, k = 4000, 10
    s, t = datagen.make_intervals(n, seed=11)
    rel = get_relation(relation)
    out = datagen.exact_count_queries(s, t, relation, selectivity, 300, k=k,
                                      rng=np.random.default_rng(5))
    X, Y = rel.transform_data(s, t)
    order = np.argsort(X, kind="stable")
    x_sorted, y_by_x = X[order], Y[order]
    m = out["m"]
    assert m == max(int(round(selectivity * n)), k)
    counts = []
    for i, pos in enumerate(out["pos"]):
        x_q = float(x_sorted[pos])
        lo = int(np.searchsorted(x_sorted, x_q, side="left"))
        y_q = float(np.partition(y_by_x[lo:], m - 1)[m - 1])
        s_q, t_q = rel.untransform_query(x_q, y_q)
        assert (s_q, t_q) == (out["s_q"][i], out["t_q"][i])
        assert s_q <= t_q
        counts.append(int(rel.valid_mask(s, t, s_q, t_q).sum()))
    counts = np.array(counts)
    assert (counts >= m).all()
    qv = np.zeros((300, 4), np.float32)
    orig = workloads.generate_queries(qv, s, t, relation, selectivity, k=k, seed=5)
    orig_counts = np.rint(orig.achieved_selectivity * n).astype(int)
    assert orig_counts.min() == counts.min() == m
    assert orig_counts.max() - m <= 3 and counts.max() - m <= 3   # ties in Y only


def test_traffic_is_drawn_from_the_seed_in_equal_shares():
    cfg = json.loads((ROOT / "udg_bench/configs/udg128-overlap.json").read_text())
    cfg.update(n=3000)
    mix = dict(json.loads((ROOT / "udg_bench/traffic/bulk.json").read_text()),
               batch=101, distinct_batches=3)
    s, t = datagen.make_intervals(cfg["n"], seed=cfg["data"]["data_seed"])
    a = traffic.make_traffic(mix, cfg, s, t, 2 ** 31 + 5)
    b = traffic.make_traffic(mix, cfg, s, t, 2 ** 31 + 5)
    c = traffic.make_traffic(mix, cfg, s, t, 2 ** 31 + 6)
    for key in ("q", "s_q", "t_q", "sel"):
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["q"], c["q"]) and not np.array_equal(a["sel"], c["sel"])
    assert a["q"].shape == (303, 128) and a["q"].dtype == np.float32
    for i in range(3):
        rows = traffic.batch_rows(mix, i + 3)             # cycles over the distinct batches
        assert rows == slice(101 * i, 101 * (i + 1))
        share = np.bincount(a["sel"][rows], minlength=5)
        np.testing.assert_array_equal(share, np.bincount(np.arange(101) % 5))
    for seed in (1, 2 ** 31 + 7):
        bi, row = traffic.sample(mix, 7, seed)
        assert bi.size == min(mix["recall_sample"], 7 * 101)
        assert len(set(zip(bi.tolist(), row.tolist()))) == bi.size
        assert bi.max() < 7 and row.max() < 101


def test_validate_rejects_unknown_keys():
    mix = json.loads((ROOT / "udg_bench/traffic/bulk.json").read_text())
    with pytest.raises(ValueError):
        traffic.validate(dict(mix, rate=3))
    with pytest.raises(ValueError):
        traffic.validate({k: v for k, v in mix.items() if k != "batch"})
    with pytest.raises(ValueError):
        traffic.validate(dict(mix, cycle=False))
