"""The port's streaming index against the JAX package's, on the CPU.

The same sequence of inserts, deletes and compactions, applied to a
``repro.stream.StreamingIndex`` (jnp oracles, ``use_ref=True``) and to a
``repro_torch.stream.StreamingIndex`` (plain versions, ``device="cpu"``),
gives the same results under the tie rule of ``repro_torch.data.parity``
with ``plan`` auto, graph and wide, fused and unfused: at epoch 0 (the
delta tier alone), after a compaction forced by a full delta, and after
deletes in both tiers; the traversal counters agree, ``delta_valid``
included. Deleted ids never come back, an epoch swap under concurrent
queries serves one consistent epoch and keeps every device shape, and a
WAL plus snapshot written by the JAX package recovers in the port to the
results of the port's own never-crashed index, bit for bit.
"""
import os
import threading

import numpy as np
import pytest

import repro.exec as jexec
import repro.stream as jstream
from repro.core import get_relation as jax_relation
from repro.data import make_dataset, make_queries_vectors
from repro.fault import truncate_file
from repro_torch.data.parity import mismatches
from repro_torch.exec import PlannerConfig
from repro_torch.obs import SearchStats
from repro_torch.search.device_graph import RANK_LIMIT
from repro_torch.stream import (
    CompactionPolicy,
    StreamingIndex,
    WriteAheadLog,
    query_key_state,
    recover,
    sort_key,
)
from repro_torch.core.predicates import get_relation
from torch_cases import K

DIM, BEAM = 16, 48
KW = dict(node_capacity=512, delta_capacity=128, edge_capacity=96, M=8, Z=32)
PLANNER = dict(brute_max_valid=32, wide_max_fraction=0.3)
SEARCHES = [(plan, fused) for plan in ("auto", "graph", "wide") for fused in (True, False)]
CHECKPOINTS = ("epoch 0", "forced compaction", "deletes in both tiers")


def queries(s, t, nq=16, seed=1):
    """Query vectors and intervals from narrow to broad."""
    rng = np.random.default_rng(seed)
    qv = make_queries_vectors(nq, DIM, seed=seed)
    lo = rng.uniform(s.min(), s.max(), size=nq)
    width = rng.uniform(0.05, 1.0, size=nq) * (t.max() - s.min())
    return qv, lo, np.minimum(lo + width, t.max() + 1.0)


def search_both(jidx, tidx, q, plan, fused):
    want = jidx.search(*q, k=K, beam=BEAM, plan=plan, fused=fused, return_stats=True,
                       use_ref=True, planner_config=jexec.PlannerConfig(**PLANNER))
    got = tidx.search(*q, k=K, beam=BEAM, plan=plan, fused=fused, return_stats=True,
                      planner_config=PlannerConfig(**PLANNER))
    return want, got


@pytest.fixture(scope="module", params=["containment", "overlap"])
def history(request):
    """One mutation sequence applied to both packages; both indexes searched
    at each checkpoint in every (plan, fused)."""
    rel = request.param
    vecs, s, t = make_dataset(420, DIM, seed=0)
    q = queries(s, t)
    jidx = jstream.StreamingIndex(DIM, rel, **KW)
    tidx = StreamingIndex(DIM, rel, device="cpu", **KW)
    out = {}
    deleted = set()

    def both(fn):
        a, b = fn(jidx), fn(tidx)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return b

    def snap(name):
        assert jidx.epoch == tidx.epoch and jidx.live_count == tidx.live_count
        out[name] = {(p, f): search_both(jidx, tidx, q, p, f) for p, f in SEARCHES}

    both(lambda i: i.insert_batch(vecs[:100], s[:100], t[:100]))
    snap("epoch 0")
    ext = both(lambda i: i.insert_batch(vecs[100:300], s[100:300], t[100:300]))  # fills at 129
    assert tidx.epoch == 2
    snap("forced compaction")
    rng = np.random.default_rng(3)
    dead = rng.choice(ext, 40, replace=False)              # graph tier and delta
    for e in dead:
        both(lambda i: i.delete(int(e)))
        deleted.add(int(e))
    both(lambda i: i.compact().n_live)
    for e in rng.choice([x for x in range(300) if x not in deleted], 20, replace=False):
        both(lambda i: i.delete(int(e)))
        deleted.add(int(e))
    both(lambda i: i.insert_batch(vecs[300:380], s[300:380], t[300:380]))
    assert tidx.graph_dead > 0 and tidx._delta.live_count > 0
    snap("deletes in both tiers")
    return out, deleted


@pytest.mark.parametrize("checkpoint", CHECKPOINTS)
@pytest.mark.parametrize("plan,fused", SEARCHES)
def test_streaming_results_match_jax(history, checkpoint, plan, fused):
    out, deleted = history
    (ij, dj, sj), (it, dt, st) = out[checkpoint][(plan, fused)]
    bad = mismatches(ij, dj, it, dt)
    assert not bad, bad[:5]
    assert it.dtype == np.int32 and (it >= 0).any()
    for name in SearchStats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st, name)).astype(np.int64),
                                      np.asarray(getattr(sj, name)).astype(np.int64), name)
    assert st.delta_valid.sum() > 0
    if checkpoint == "epoch 0":
        assert not st.iters.any()            # the delta tier alone
    else:
        assert st.iters.any()
    if checkpoint == "deletes in both tiers":
        assert not (set(it.ravel().tolist()) & deleted)


def test_fused_and_unfused_scans_are_bitwise(history):
    """The delta norms are summed as the unfused scorer recomputes them, so
    the graph plan's fused and unfused searches agree bit for bit, and at
    epoch 0 (the delta alone) every plan's do. (Planned graph tiers differ:
    the unfused executor widens with expand 1.)"""
    out, _ = history
    pairs = [(c, "graph") for c in CHECKPOINTS] + [("epoch 0", p) for p in ("auto", "wide")]
    for checkpoint, plan in pairs:
        a, b = out[checkpoint][(plan, True)][1], out[checkpoint][(plan, False)][1]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32))


def test_sort_key_is_monotone_and_the_references():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(scale=100.0, size=500),
                        [0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30, np.inf, -np.inf]]).astype(np.float32)
    k = sort_key(v)
    assert np.all(np.diff(k[np.argsort(v, kind="stable")]) >= 0)
    assert sort_key(-0.0) == sort_key(0.0)
    np.testing.assert_array_equal(k, jstream.sort_key(v))
    assert k.dtype == jstream.sort_key(v).dtype
    s_q, t_q = rng.uniform(0, 50, 9), rng.uniform(50, 100, 9)
    for rel in ("containment", "overlap"):
        np.testing.assert_array_equal(
            query_key_state(get_relation(rel), s_q, t_q),
            jstream.query_key_state(jax_relation(rel), s_q, t_q))


def test_deletes_never_resurface_across_compaction():
    vecs, s, t = make_dataset(300, DIM, seed=2)
    idx = StreamingIndex(DIM, "containment", device="cpu", **KW)
    ext = idx.insert_batch(vecs[:200], s[:200], t[:200])
    qv = make_queries_vectors(4, DIM, seed=3)
    broad = (float(s.min()) - 1.0, float(t.max()) + 1.0)     # everything valid

    def returned():
        ids, _ = idx.search(qv, np.full(4, broad[0]), np.full(4, broad[1]), k=K, beam=BEAM)
        return set(int(x) for x in ids.ravel() if x >= 0)

    dead = set(int(e) for e in ext[:30])                      # from the delta
    for e in sorted(dead):
        assert idx.delete(e)
    assert not (returned() & dead)
    idx.compact()
    assert not (returned() & dead)
    dead2 = set(int(e) for e in ext[30:60])                   # graph tombstones
    for e in sorted(dead2):
        assert idx.delete(e)
    assert not (returned() & (dead | dead2))
    job = idx.begin_compaction()                              # racing the build
    racing = set(int(e) for e in ext[60:80])
    for e in sorted(racing):
        assert idx.delete(e)
    late = idx.insert_batch(vecs[200:220], s[200:220], t[200:220])
    idx.build_epoch(job)
    idx.finish_compaction(job)
    assert not (returned() & (dead | dead2 | racing))
    assert set(int(e) for e in late) <= set(int(e) for e in idx.live_ids())
    for j in (0, 7, 19):
        ids, d = idx.search(vecs[200 + j], broad[0], broad[1], k=K, beam=BEAM)
        assert int(ids[0]) == int(late[j]) and d[0] <= 1e-4
    assert not idx.delete(int(ext[0]))
    assert not idx.delete(10**9)


def bundle_shapes(idx):
    di = idx._dg.device(idx.device)
    return {k: (tuple(v.shape), v.dtype) for k, v in vars(di).items() if v is not None}


def test_epoch_swap_under_concurrent_queries():
    vecs, s, t = make_dataset(360, DIM, seed=4)
    idx = StreamingIndex(DIM, "overlap", device="cpu", policy=CompactionPolicy(0.05, 8), **KW)
    ext = idx.insert_batch(vecs[:240], s[:240], t[:240])
    idx.compact()
    deleted = set(int(e) for e in ext[:40])
    for e in sorted(deleted):
        idx.delete(e)
    idx.insert_batch(vecs[240:300], s[240:300], t[240:300])
    qv = make_queries_vectors(4, DIM, seed=5)
    bs, bt = np.full(4, float(s.min()) - 1.0), np.full(4, float(t.max()) + 1.0)
    shapes, epoch = bundle_shapes(idx), idx.epoch
    before = idx.search(qv, bs, bt, k=K, beam=BEAM)
    assert idx.should_compact()
    errors, results, stop = [], [], threading.Event()

    def serve():
        try:
            while not stop.is_set():
                results.append((idx.epoch, idx.search(qv, bs, bt, k=K, beam=BEAM)))
        except BaseException as exc:   # re-raised below
            errors.append(exc)

    server = threading.Thread(target=serve)
    server.start()
    try:
        job = idx.begin_compaction()
        build_thread = threading.Thread(target=idx.build_epoch, args=(job,))
        build_thread.start()
        build_thread.join(timeout=120)
        assert not build_thread.is_alive()
        rep = idx.finish_compaction(job)
    finally:
        stop.set()
        server.join(timeout=120)
    assert not server.is_alive() and not errors, errors
    assert idx.epoch == epoch + 1 and rep.delta_drained == 60 and rep.tombstones_cleared == 40
    assert idx._delta.live_count == 0 and idx.graph_dead == 0
    assert bundle_shapes(idx) == shapes
    live = set(int(e) for e in idx.live_ids())
    assert results
    for _, (ids, _) in results:
        got = set(int(x) for x in ids.ravel() if x >= 0)
        assert not (got & deleted) and got <= live
    # served before the swap: the pre-swap index's results (the epoch is
    # read before each search, so the last of them may straddle the swap)
    pre = [r for ep, r in results if ep == epoch]
    for ids, d in pre[:-1]:
        np.testing.assert_array_equal(ids, before[0])
        np.testing.assert_array_equal(d.view(np.int32), before[1].view(np.int32))


def test_packed_layout_is_fixed_at_construction(tmp_path):
    assert StreamingIndex(4, "containment", node_capacity=RANK_LIMIT, edge_capacity=8,
                          device="cpu")._packed_labels
    wide = StreamingIndex(4, "containment", node_capacity=RANK_LIMIT + 1, edge_capacity=8,
                          delta_capacity=16, device="cpu")
    assert not wide._packed_labels
    assert wide._dg.serving_labels(device="cpu").shape[-1] == 4
    path = wide.save_snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="label layout"):     # restored as packed
        data = dict(np.load(path))
        data["meta"][1] = RANK_LIMIT
        np.savez(str(tmp_path / "forced.npz"), **data)
        StreamingIndex.restore(str(tmp_path / "forced.npz"), device="cpu")


MUT_KW = dict(node_capacity=256, delta_capacity=64, edge_capacity=16, M=8, Z=32)


def mutate(idx, n, seed, deletes=()):
    rng = np.random.default_rng(seed)
    ids = []
    for _ in range(n):
        v = rng.standard_normal(8).astype(np.float32)
        a, b = np.sort(rng.uniform(0.0, 100.0, 2))
        ids.append(idx.insert(v, float(a), float(b)))
    for e in deletes:
        idx.delete(int(e))
    return ids


def wal_queries():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((12, 8)).astype(np.float32)
    s_q = rng.uniform(0.0, 40.0, 12)
    return q, s_q, s_q + rng.uniform(10.0, 50.0, 12)


def assert_bitwise(a, b):
    for plan in ("auto", "graph", "wide"):
        ia, da = a.search(*wal_queries(), k=10, plan=plan)
        ib, db = b.search(*wal_queries(), k=10, plan=plan)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da.view(np.int32), db.view(np.int32))


@pytest.mark.parametrize("relation", ["containment", "overlap"])
def test_jax_wal_and_snapshot_recover_in_the_port(relation, tmp_path):
    """The JAX package logs 70 inserts (one forced compaction at 65), a
    snapshot, then 20 inserts and a delete; the port recovers from that
    directory to the results of its own index that applied the same
    mutations and never crashed, bit for bit; each package restores the
    other's snapshot."""
    wal = jstream.WriteAheadLog(str(tmp_path), sync="never")
    jidx = jstream.StreamingIndex(8, relation, wal=wal, **MUT_KW)
    mutate(jidx, 70, seed=5, deletes=(3, 66))
    jidx.save_snapshot(str(tmp_path), prune_wal=False)
    tail = mutate(jidx, 20, seed=6, deletes=(tail_del := 80,))
    wal.close()
    oracle = StreamingIndex(8, relation, device="cpu", **MUT_KW)
    mutate(oracle, 70, seed=5, deletes=(3, 66))
    mutate(oracle, 20, seed=6, deletes=(tail_del,))
    rec, report = recover(str(tmp_path), dim=8, relation=relation, device="cpu", **MUT_KW)
    assert report.snapshot_found and report.records_replayed == 21 and not report.truncated
    assert rec.epoch == oracle.epoch == 1 and rec.wal_lsn == jidx.wal_lsn
    assert rec.live_count == oracle.live_count == jidx.live_count == 87
    assert len(tail) == 20
    assert_bitwise(rec, oracle)
    # the port's snapshot restores in the JAX package, the same results
    # under the tie rule
    path = oracle.save_snapshot(str(tmp_path / "port.npz"))
    back = jstream.StreamingIndex.restore(path)
    for plan in ("auto", "graph", "wide"):
        a = back.search(*wal_queries(), k=10, plan=plan, use_ref=True)
        b = oracle.search(*wal_queries(), k=10, plan=plan)
        assert not mismatches(a[0], a[1], b[0], b[1])


def test_torn_final_record_is_discarded_alike(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        d.mkdir()
    wal = jstream.WriteAheadLog(str(jdir), sync="never")
    jidx = jstream.StreamingIndex(8, "containment", wal=wal, **MUT_KW)
    mutate(jidx, 70, seed=8)
    jidx.save_snapshot(str(jdir), prune_wal=False)
    mutate(jidx, 15, seed=9)
    wal.close()
    seg = wal.active_segment_path
    truncate_file(seg, os.path.getsize(seg) - 5)          # tear the last record
    for name in os.listdir(jdir):
        with open(jdir / name, "rb") as src, open(tdir / name, "wb") as dst:
            dst.write(src.read())
    got, rep = recover(str(tdir), dim=8, relation="containment", device="cpu", **MUT_KW)
    want, jrep = jstream.recover(str(jdir), dim=8, relation="containment", **MUT_KW)
    assert rep.truncated and jrep.truncated
    assert rep.records_replayed == jrep.records_replayed == 14
    assert got.wal_lsn == want.wal_lsn == 84 and got.live_count == want.live_count == 84
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):                          # both truncated alike
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    oracle = StreamingIndex(8, "containment", device="cpu", **MUT_KW)
    replay = WriteAheadLog(str(tdir), sync="never")
    for r in replay.replay(after_lsn=0):
        oracle.apply_record(r)
    replay.close()
    assert_bitwise(got, oracle)
    for plan in ("auto", "graph"):
        a = want.search(*wal_queries(), k=10, plan=plan, use_ref=True)
        b = got.search(*wal_queries(), k=10, plan=plan)
        assert not mismatches(a[0], a[1], b[0], b[1])
    # the recovered index takes new mutations, continuing ids and LSNs
    assert got.insert(np.ones(8, np.float32), 10.0, 20.0) == 84 and got.wal_lsn == 85
    got._wal.close()
