"""The port's segmented streaming tier against the JAX package's, on the CPU.

The same inserts, deletes and compactions, applied to a
``repro.scale.SegmentedStreamingIndex`` (jnp oracles) and to a
``repro_torch.scale.SegmentedStreamingIndex`` (plain versions,
``device="cpu"``) over the same grid, at the sizes of
``tests/test_segmented_durability.py`` (d 8, node 256, delta 64, edge 16 a
cell, M 6, Z 24, K_p 4), give the same live ids, epochs and swap counts, and
search results equal under the tie rule of ``repro_torch.data.parity``
(tolerance ``1e-5·max(1, |d|)``) with ``plan`` auto, graph and wide, fused
and unfused. Also held:

* an epoch swap repatches only its cell's slice of ``device_stack()``;
* a directory written by the JAX package (manifest, snapshots, WALs)
  recovers in the port, bit-equal to the port's own never-crashed index;
* the port's own checkpoints: recovery bit-equal after a post-checkpoint
  tail, torn WAL tails in some cells, a corrupt snapshot (full-WAL fallback;
  quarantine when the history is pruned), a runtime quarantine healed by
  ``maybe_rebuild``, and a sub-index whose search raises;
* ``read_manifest`` rejects a bad CRC, magic, length or payload, and each
  package reads the other's manifest.
"""
import os

import numpy as np
import pytest
import torch

import repro.scale as jscale
import repro.stream.index as jstream
from repro.core.predicates import DominanceSpace as JaxSpace
from repro.core.predicates import get_relation as jax_relation
from repro.fault import corrupt_byte, truncate_file
from repro_torch.data.parity import mismatches
from repro_torch.scale import (
    CorruptManifestError,
    SegmentedStreamingIndex,
    SegmentGrid,
    read_manifest,
    recover_segmented,
    write_manifest,
)
from repro_torch.scale.durability import grid_from_manifest, segment_dir
from repro_torch.stream import CompactionPolicy, WriteAheadLog
from torch_cases import K  # noqa: F401  (pins torch to one thread)

DIM = 8
KW = dict(node_capacity=256, delta_capacity=64, edge_capacity=16)
BK = dict(M=6, Z=24, K_p=4)
POLICY = dict(max_delta_fraction=0.05, min_mutations=16)
SEARCHES = [(p, f) for p in ("auto", "graph", "wide") for f in (True, False)]


def _dataset(n=140, seed=0, span=100.0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    s = rng.uniform(0.0, span * 0.6, n)
    t = s + rng.uniform(1.0, span * 0.4, n)
    return vecs, s, t


def _grids(relation, s, t, cells_per_axis=2):
    jgrid = jscale.SegmentGrid.from_space(
        JaxSpace.from_intervals(jax_relation(relation), s, t), cells_per_axis)
    grid = SegmentGrid(**{f: getattr(jgrid, f) for f in ("edges_x", "edges_y", "vals_x", "vals_y")})
    return jgrid, grid


def _make(relation, grid, storage=None, **over):
    kw = dict(KW, policy=CompactionPolicy(**POLICY), build_kwargs=dict(BK), **BK)
    kw.update(over)
    return SegmentedStreamingIndex(DIM, relation, grid, storage_dir=storage, device="cpu", **kw)


def _make_jax(relation, grid, storage=None):
    return jscale.SegmentedStreamingIndex(
        DIM, relation, grid, storage_dir=storage, policy=jstream.CompactionPolicy(**POLICY),
        build_kwargs=dict(BK), **KW, **BK)


def _queries(nq=6, seed=9):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    return q, np.full(nq, 20.0), np.full(nq, 80.0)


def _recover(root, **over):
    kw = dict(policy=CompactionPolicy(**POLICY), build_kwargs=dict(BK), device="cpu")
    kw.update(over)
    return recover_segmented(str(root), **kw)


def _assert_parity(a, b):
    q, sq, tq = _queries()
    ia, da = a.search(q, sq, tq, k=7)
    ib, db = b.search(q, sq, tq, k=7)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da.view(np.int32), db.view(np.int32))


def _close_wals(idx):
    for w in idx._wals:
        if w is not None:
            w.close()


def _mutate(idx, vecs, s, t):
    """The shared mutation sequence: a load (hot cells flush-compact while
    it lands), deletes in one cell, a compaction poll, a second load."""
    ext = idx.insert_batch(vecs[:120], s[:120], t[:120])
    hot = int(np.argmax(idx.epochs()))
    for e in idx.subs[hot].live_ids()[:20]:
        assert idx.delete(int(e))
    for e in ext[::17]:
        idx.delete(int(e))
    idx.maybe_compact()
    idx.insert_batch(vecs[120:], s[120:], t[120:])
    return ext


@pytest.fixture(scope="module", params=["overlap", "containment"])
def history(request):
    rel = request.param
    vecs, s, t = _dataset(seed=6)
    jgrid, grid = _grids(rel, s, t)
    jidx, tidx = _make_jax(rel, jgrid), _make(rel, grid)
    _mutate(jidx, vecs, s, t)
    _mutate(tidx, vecs, s, t)
    return jidx, tidx


def test_the_same_mutations_give_the_reference_state(history):
    jidx, tidx = history
    np.testing.assert_array_equal(tidx.live_ids(), jidx.live_ids())
    assert tidx.epochs() == jidx.epochs() and tidx.swap_counts == jidx.swap_counts
    assert any(e >= 1 for e in tidx.epochs()) and tidx.live_count == jidx.live_count


@pytest.mark.parametrize("plan,fused", SEARCHES)
def test_search_equals_the_reference(history, plan, fused):
    jidx, tidx = history
    vecs, s, t = _dataset(n=12, seed=3)
    lo = np.minimum(s, 30.0)
    hi = np.maximum(t, 60.0)
    for q, sq, tq in (_queries(), (vecs, lo, hi)):
        ij, dj, infoj = jidx.search(q, sq, tq, k=7, beam=32, plan=plan, fused=fused,
                                    return_partial=True)
        it, dt, info = tidx.search(q, sq, tq, k=7, beam=32, plan=plan, fused=fused,
                                   return_partial=True)
        bad = mismatches(ij, dj, it, dt)
        assert not bad, bad[:5]
        assert (it >= 0).any() and not info.degraded and not infoj.degraded
        assert not np.isin(it, np.setdiff1d(np.arange(it.max() + 1), tidx.live_ids())).any()


def test_stack_patch_is_segment_local():
    vecs, s, t = _dataset(n=300, seed=44)
    _, grid = _grids("overlap", s, t)
    idx = _make("overlap", grid, node_capacity=512, delta_capacity=128, edge_capacity=64)
    idx.insert_batch(vecs, s, t)
    stack = idx.device_stack()
    assert stack.num_segments == idx.num_segments and stack.device == torch.device("cpu")
    before = [dict(stack.part(ci)) for ci in range(stack.num_segments)]
    flat0 = stack.flat("nbr")
    hot = int(np.argmax(idx.epochs()))
    for e in idx.subs[hot].live_ids()[:24]:
        assert idx.delete(int(e))
    reports = idx.maybe_compact()
    assert hot in reports
    for ci in range(stack.num_segments):
        for key in ("table", "nbr", "labels", "gids"):
            same = stack.part(ci)[key] is before[ci][key]
            assert same == (ci not in reports), (ci, key)
    assert stack.flat("nbr") is not flat0
    ncap = stack.node_capacity
    gids = stack.flat("gids").numpy()[hot * ncap:(hot + 1) * ncap]
    assert set(gids[gids >= 0].tolist()) == set(idx.subs[hot].live_ids().tolist())


def test_a_jax_written_directory_recovers_in_the_port(tmp_path):
    """Manifest, snapshots and WALs written by the JAX package, recovered by
    the port: bit-equal to the port's own never-crashed index."""
    vecs, s, t = _dataset(seed=6)
    jgrid, grid = _grids("overlap", s, t)
    jidx = _make_jax("overlap", jgrid, storage=str(tmp_path))
    tidx = _make("overlap", grid)
    for idx in (jidx, tidx):
        idx.insert_batch(vecs, s, t)
    assert jidx.save_snapshot() == 1
    vecs2, s2, t2 = _dataset(n=25, seed=7)
    for idx in (jidx, tidx):
        ids2 = idx.insert_batch(vecs2, s2, t2)
        for e in ids2[:4]:
            assert idx.delete(int(e))
    _close_wals(jidx)
    rec, report = _recover(tmp_path)
    assert report.quarantined == [] and report.generation == 1
    assert report.records_replayed >= 25 + 4
    np.testing.assert_array_equal(rec.live_ids(), tidx.live_ids())
    assert rec.epochs() == tidx.epochs()
    _assert_parity(rec, tidx)
    _close_wals(rec)


class TestPortDurability:
    def _populated(self, tmp_path, seed=6, **over):
        vecs, s, t = _dataset(seed=seed)
        _, grid = _grids("overlap", s, t)
        idx = _make("overlap", grid, storage=str(tmp_path), **over)
        idx.insert_batch(vecs, s, t)
        return idx, grid

    def test_checkpoint_then_recover_bit_identical(self, tmp_path):
        idx, _ = self._populated(tmp_path)
        assert idx.save_snapshot() == 1
        vecs2, s2, t2 = _dataset(n=25, seed=7)
        ids2 = idx.insert_batch(vecs2, s2, t2)
        for e in ids2[:4]:
            assert idx.delete(int(e))
        _close_wals(idx)
        rec, report = _recover(tmp_path)
        assert report.quarantined == [] and report.generation == 1
        assert all(sub.device == torch.device("cpu") for sub in rec.subs)
        _assert_parity(rec, idx)
        new = rec.insert(np.ones(DIM, np.float32), 10.0, 30.0)
        assert new not in set(idx.live_ids().tolist())
        _close_wals(rec)

    def test_torn_tails_in_some_cells(self, tmp_path):
        idx, grid = self._populated(tmp_path, seed=10)
        idx.save_snapshot()
        vecs2, s2, t2 = _dataset(n=30, seed=11)
        idx.insert_batch(vecs2, s2, t2)
        _close_wals(idx)
        torn = []
        for ci in (0, 2):
            seg = segment_dir(str(tmp_path), ci)
            path = os.path.join(seg, sorted(n for n in os.listdir(seg) if n.startswith("wal-"))[-1])
            if os.path.getsize(path) > 8:
                truncate_file(path, os.path.getsize(path) - 5)
                torn.append(ci)
        assert torn
        rec, report = _recover(tmp_path)
        assert report.quarantined == []
        assert {r.cell for r in report.segments if r.truncated} == set(torn)
        oracle = _make("overlap", grid)
        for ci in range(oracle.num_segments):
            ro = WriteAheadLog(segment_dir(str(tmp_path), ci), sync="never")
            for r in ro.replay(after_lsn=0):
                oracle.subs[ci].apply_record(r)
            ro.close()
        _assert_parity(rec, oracle)
        _close_wals(rec)

    @pytest.mark.parametrize("seg_bytes", [1 << 20, 1024])
    def test_corrupt_snapshot(self, tmp_path, seg_bytes):
        """A corrupt snapshot falls back to a full WAL replay while the log
        holds the whole history, and quarantines the cell once it does not;
        searches then stay exact over the survivors."""
        idx, _ = self._populated(tmp_path, seed=14, wal_segment_bytes=seg_bytes)
        idx.save_snapshot()
        vecs2, s2, t2 = _dataset(n=20, seed=15)
        idx.insert_batch(vecs2, s2, t2)
        _close_wals(idx)
        man = read_manifest(str(tmp_path))
        corrupt_byte(os.path.join(segment_dir(str(tmp_path), 0), man["segments"][0]["snapshot"]), 120)
        rec, report = _recover(tmp_path, wal_segment_bytes=seg_bytes)
        if seg_bytes == 1 << 20:
            assert report.quarantined == []
            assert "full WAL replay" in report.segments[0].reason
            _assert_parity(rec, idx)
            return
        assert report.quarantined == [0] and sorted(rec.quarantined) == [0]
        q, sq, tq = _queries()
        ids, d, info = rec.search(q, sq, tq, k=7, return_partial=True)
        assert info.degraded and info.missing_segments == [0]
        assert not np.any((ids >= 0) & (ids % rec.num_segments == 0))
        idx.quarantine_segment(0, "oracle mask")
        oid, od = idx.search(q, sq, tq, k=7)
        np.testing.assert_array_equal(ids, oid)
        np.testing.assert_array_equal(d.view(np.int32), od.view(np.int32))
        assert rec.maybe_rebuild() == {0: False} and 0 in rec.quarantined
        _close_wals(rec)

    def test_runtime_quarantine_and_storage_rebuild(self, tmp_path):
        idx, _ = self._populated(tmp_path, seed=16)
        idx.maybe_compact()
        idx.save_snapshot()
        q, sq, tq = _queries()
        pre = idx.search(q, sq, tq, k=7)
        st = idx.device_stack()
        hot = int(np.argmax([sub.live_count for sub in idx.subs]))
        idx.quarantine_segment(hot, "poisoned")
        assert (st.part(hot)["gids"] == -1).all()
        assert idx.subs[hot].device == torch.device("cpu")
        ids, _, info = idx.search(q, sq, tq, k=7, return_partial=True)
        assert not np.any((ids >= 0) & (ids % idx.num_segments == hot))
        assert idx.maybe_rebuild() == {hot: True} and not idx.quarantined
        post = idx.search(q, sq, tq, k=7)
        np.testing.assert_array_equal(pre[0], post[0])
        np.testing.assert_array_equal(pre[1].view(np.int32), post[1].view(np.int32))
        assert st.part(hot)["gids"].max() >= 0
        _close_wals(idx)

    def test_a_raising_sub_index_is_quarantined(self):
        vecs, s, t = _dataset(seed=17)
        _, grid = _grids("overlap", s, t)
        idx = _make("overlap", grid)
        idx.insert_batch(vecs, s, t)
        q, sq, tq = _queries()
        _, _, routed = idx.search(q, sq, tq, k=7, return_partial=True)
        assert not routed.degraded
        victim = int(np.argmax([sub.live_count for sub in idx.subs]))

        def fail(*args, **kwargs):
            raise RuntimeError("injected")

        idx.subs[victim].search = fail
        ids, _, info = idx.search(q, sq, tq, k=7, return_partial=True)
        assert info.degraded and victim in info.missing_segments and victim in idx.quarantined
        assert "injected" in idx.quarantine_reasons[victim]
        assert idx.maybe_rebuild() == {victim: True} and not idx.quarantined


@pytest.mark.parametrize("damage", ["crc", "magic", "short", "json"])
def test_read_manifest_rejects_damage(tmp_path, damage):
    write_manifest(str(tmp_path), {"generation": 0, "segments": []})
    path = os.path.join(str(tmp_path), "MANIFEST")
    if damage == "crc":
        corrupt_byte(path, os.path.getsize(path) - 2)
    elif damage == "magic":
        corrupt_byte(path, 0)
    elif damage == "short":
        truncate_file(path, 5)
    else:
        corrupt_byte(path, 10)
    with pytest.raises(CorruptManifestError):
        read_manifest(str(tmp_path))


def test_each_package_reads_the_others_manifest(tmp_path):
    _, s, t = _dataset(seed=1)
    jgrid, grid = _grids("overlap", s, t)
    from repro_torch.scale.durability import grid_to_manifest

    man = {"generation": 3, "relation": "overlap", "dim": DIM, **KW, **BK,
           "grid": grid_to_manifest(grid),
           "segments": [{"snapshot": None, "digest": None, "lsn": 0}] * 4}
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_manifest(str(tmp_path / "a"), man)
    jscale.write_manifest(str(tmp_path / "b"), man)
    assert jscale.read_manifest(str(tmp_path / "a")) == man == read_manifest(str(tmp_path / "b"))
    assert (tmp_path / "a" / "MANIFEST").read_bytes() == (tmp_path / "b" / "MANIFEST").read_bytes()
    g2 = grid_from_manifest(read_manifest(str(tmp_path / "a"))["grid"])
    for f in ("edges_x", "edges_y", "vals_x", "vals_y"):
        np.testing.assert_array_equal(getattr(g2, f), getattr(jgrid, f))


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, s, t = _dataset(seed=1)
    _, grid = _grids("overlap", s, t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentedStreamingIndex(DIM, "overlap", grid, **KW)
