"""The reference against a naive loop, ties included, and the comparison."""
import ast

import numpy as np
import pytest
import torch

from udg_bench import check, datagen
from udg_bench.conftest import ROOT
from udg_bench.reference import Corpus, to_tf32


def naive_topk(vecs, s, t, q, sq, tq, relation, k):
    """One query at a time: the predicate object by object, the distance
    as a float64 sum of squares, ties to the lower id."""
    valid = datagen.RELATIONS[relation]["valid"]
    ids, dist, count = [], [], []
    for i in range(q.shape[0]):
        cand = []
        for j in range(vecs.shape[0]):
            if valid(s[j], t[j], sq[i], tq[i]):
                diff = vecs[j].astype(np.float64) - q[i].astype(np.float64)
                cand.append((float(diff @ diff), j))
        cand.sort()
        top = cand[:k] + [(np.inf, -1)] * (k - min(k, len(cand)))
        ids.append([j for _, j in top])
        dist.append([d for d, _ in top])
        count.append(len(cand))
    return np.array(ids), np.array(dist), np.array(count)


def tie_data(seed, n=300, dim=6, nq=24):
    """Small integer vectors (exact in float32 and float64) with duplicated
    rows, so distances tie exactly; integer interval endpoints that tie too."""
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-3, 4, size=(n, dim)).astype(np.float32)
    vecs[n // 2:] = vecs[: n - n // 2]
    s = rng.integers(0, 50, size=n).astype(np.float64)
    t = s + rng.integers(0, 10, size=n)
    q = rng.integers(-3, 4, size=(nq, dim)).astype(np.float32)
    sq = rng.integers(0, 40, size=nq).astype(np.float64)
    tq = sq + rng.integers(0, 30, size=nq)
    sq[:3], tq[:3] = 200, 210       # past every interval: empty valid sets
    tq[3:6] = sq[3:6] + 1           # narrow: fewer than k valid
    return vecs, s, t, q, sq, tq


@pytest.mark.parametrize("relation", ["containment", "overlap"])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_equals_naive_loop(relation, seed):
    vecs, s, t, q, sq, tq = tie_data(seed)
    ref = Corpus(vecs, s, t, relation, "cpu")
    ids, dist, count = ref.topk(q, sq, tq, 10, block=7)
    want_ids, want_d, want_count = naive_topk(vecs, s, t, q, sq, tq, relation, 10)
    np.testing.assert_array_equal(count, want_count)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dist, want_d)
    assert (count == 0).any() and (count < 10).any() and (count >= 10).any()
    d_at, ok = ref.at(q, sq, tq, np.where(ids >= 0, ids, 0))
    live = ids >= 0
    np.testing.assert_array_equal(d_at[live], want_d[live])
    assert ok[live].all()


def test_at_flags_ids_outside_the_corpus_or_the_predicate():
    vecs, s, t, q, sq, tq = tie_data(3)
    ref = Corpus(vecs, s, t, "containment", "cpu")
    ids, _, count = ref.topk(q, sq, tq, 4)
    row = int(np.flatnonzero(count >= 4)[0])
    bad = ids[row:row + 1].copy()
    bad[0, 1] = vecs.shape[0]           # past the corpus
    bad[0, 2] = -5
    outside = np.flatnonzero(~datagen.RELATIONS["containment"]["valid"](s, t, sq[row], tq[row]))
    bad[0, 3] = outside[0]
    _, ok = ref.at(q[row:row + 1], sq[row:row + 1], tq[row:row + 1], bad)
    assert ok.tolist() == [[True, False, False, False]]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0000002])
    got = to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]
    bits = got.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()


def readings_of(ids, dist, vecs, s, t, q, sq, tq, relation="containment"):
    ref = Corpus(vecs, s, t, relation, "cpu")
    return check.judge_answers(ref, q, sq, tq, ids, dist, ids.shape[1])


def test_comparison_reads_the_reference_as_exact_and_faults_as_wrong():
    vecs, s, t, q, sq, tq = tie_data(5, n=400)
    ref = Corpus(vecs, s, t, "containment", "cpu")
    ids, dist, count = ref.topk(q, sq, tq, 10)
    read = readings_of(ids, dist, vecs, s, t, q, sq, tq)
    assert read["dist_err"] == 0.0 and read["bad_slots"] == 0 and read["recall"] == 1.0
    full = np.flatnonzero(count >= 10)
    cases = {}
    short = ids.copy()
    short[full[0], 5:] = -1
    short_d = np.where(short >= 0, dist, np.inf)
    cases["empty slot while more are valid"] = (short, short_d)
    dup = ids.copy()
    dup[full[0], 1] = dup[full[0], 0]
    cases["an id twice"] = (dup, dist)
    order = dist.copy()
    order[full[0], 1] = order[full[0], 0] - 1
    cases["distance below the slot before"] = (ids, order)
    lost = dist.copy()
    lost[full[0], 3] = np.inf
    cases["id without a distance"] = (ids, lost)
    for name, (a, d) in cases.items():
        assert readings_of(a, d, vecs, s, t, q, sq, tq)["bad_slots"] > 0, name
    moved = dist.copy()
    moved[full[0], 0] += 1.5
    assert readings_of(ids, moved, vecs, s, t, q, sq, tq)["dist_err"] >= 1.5 / max(dist[full[0], 0], 1)
    limits = {"dist_err": 1e-3, "bad_slots": 0, "recall": 0.9}
    ok, checks = check.judge(readings_of(ids, moved, vecs, s, t, q, sq, tq), limits)
    assert not ok and list(checks) == list(check.NUMBERS)
    assert check.judge(read, limits)[0]
    # valid, well-ordered answers at their own distances, only not the best:
    # the next ten of each row's exact list (rows with twenty or more valid
    # objects); recall alone sees them
    ids20, dist20, count20 = ref.topk(q, sq, tq, 20)
    rows = np.flatnonzero(count20 >= 20)
    assert rows.size >= 10
    worse = readings_of(ids20[rows, 10:], dist20[rows, 10:], vecs, s, t, q[rows], sq[rows],
                        tq[rows])
    assert worse["dist_err"] == 0.0 and worse["bad_slots"] == 0
    ok, checks = check.judge(worse, limits)
    assert not ok and checks["recall"]["value"] < 0.9 and checks["recall"]["held"] == "min"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "datagen.py", "traffic.py"):
        tree = ast.parse((ROOT / "udg_bench" / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        tops = {m.split(".")[0] for m in mods}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, (name, tops)
