"""Chaos scenario: one seeded end-to-end run through every fault path.

Five independent phases, each against live serving objects (no mocks of
the code under test — the injector wraps real methods from the outside):

  ``compaction``      killed compaction workers: an injected exception
                      fires inside ``build_epoch`` on the worker thread;
                      the server must keep serving the old epoch, walk
                      the exponential-backoff ladder, and land a clean
                      epoch swap once the fault heals;
  ``poison``          NaN/Inf query vectors and NaN intervals must be
                      rejected at ``submit`` with a ``ValueError``,
                      never reaching the device;
  ``overload``        a submit burst beyond the admission bound must
                      shed (bounded queue) while every admitted request
                      is answered;
  ``crash_recovery``  the active WAL segment is torn mid-record at a
                      seeded offset; recovery (snapshot + surviving
                      tail) must answer bit-identically to a fresh
                      oracle that applies the same surviving records
                      from scratch;
  ``segmented``       seeded crash-point sweep over the segmented
                      durability stack — crash mid-insert (torn
                      per-cell WAL tail), mid-compaction of the hot
                      cell, between two segment snapshots of one
                      coordinated checkpoint, random byte corruption in
                      one cell's WAL and in one cell's snapshot. Each
                      point pairs with a different predicate relation
                      (rotating with the seed over all five); recovery
                      must be bit-identical to its oracle, and the
                      corrupt-snapshot case must QUARANTINE the cell,
                      answer exactly over the survivors (flagging
                      ``missing_segments``) and self-heal via
                      ``maybe_rebuild`` when storage permits.

Run directly::

    python -m repro_torch.fault.chaos --tiny --seed 0 [--device cpu] [--json out.json]

Exit status is non-zero when any phase invariant fails, so the command
doubles as a self-checking smoke test.

The JAX package's ``repro.fault.chaos`` on the port: the same phases, sizes
and seeded draws, so every field that is a function of the seed equals the
reference's. Every index, recovery and oracle lives on ``device`` (``None``:
the card, which raises without CUDA; ``"cpu"`` runs the kernels' plain
versions). A kernel that fails to build or launch fails the run: nothing
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from repro_torch.core.predicates import DominanceSpace, get_relation
from repro_torch.device import resolve_device
from repro_torch.fault.inject import (
    FaultInjector,
    FaultSpec,
    corrupt_byte,
    poison_vector,
    truncate_file,
)
from repro_torch.scale import SegmentGrid, SegmentedStreamingIndex
from repro_torch.scale.durability import read_manifest, segment_dir
from repro_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    RequestShed,
)
from repro_torch.serve.batching import StreamingServer
from repro_torch.stream.index import CompactionPolicy, StreamingIndex
from repro_torch.stream.wal import WriteAheadLog, recover

DIM = 8
SPAN = 100.0


def _insert_stream(rng, idx, n):
    ids = []
    for _ in range(n):
        v = rng.standard_normal(DIM).astype(np.float32)
        s, t = np.sort(rng.uniform(0.0, SPAN, 2))
        ids.append(idx.insert(v, float(s), float(t)))
    return ids


def _phase_compaction(rng, inj, kw) -> dict:
    """Injected build failures → backoff → eventual clean swap, with the
    old epoch serving correct results throughout."""
    idx = StreamingIndex(
        DIM, "containment",
        policy=CompactionPolicy(max_delta_fraction=0.02, min_mutations=8),
        **kw,
    )
    ids = _insert_stream(rng, idx, kw["delta_capacity"] // 2)
    for e in ids[: len(ids) // 3]:
        idx.delete(int(e))
    server = StreamingServer(
        idx, batch_size=4, k=5, timeout_s=0.0,
        compaction_backoff_s=0.005, compaction_backoff_seed=inj.seed,
    )
    epoch_before = idx.epoch
    q = rng.standard_normal(DIM).astype(np.float32)
    ref_ids, ref_d = idx.search(q, 20.0, 80.0, k=5)[:2]
    inj.add("compaction.build", FaultSpec("error", max_hits=2))
    backoff_waits = 0
    with inj.injected(idx, "build_epoch", "compaction.build"):
        deadline = time.monotonic() + 30.0
        while idx.epoch == epoch_before and time.monotonic() < deadline:
            started = server.maybe_compact_async()
            if not started:
                backoff_waits += 1
            if server._worker is not None:
                server._worker.join()
            # the old epoch keeps serving identical results mid-failure
            mid_ids, mid_d = idx.search(q, 20.0, 80.0, k=5)[:2]
            if idx.epoch == epoch_before:
                assert np.array_equal(np.asarray(mid_ids), np.asarray(ref_ids))
            time.sleep(0.002)
    failures = sum(1 for p, k, _ in inj.fired if p == "compaction.build")
    return {
        "injected_failures": failures,
        "backoff_waits": backoff_waits,
        "epoch_recovered": idx.epoch > epoch_before,
        "ok": (failures == 2 and idx.epoch > epoch_before
               and server.last_compaction_error is None),
    }


def _phase_poison(rng, kw) -> dict:
    """Non-finite inputs rejected at the serving boundary."""
    idx = StreamingIndex(DIM, "containment", **kw)
    _insert_stream(rng, idx, 16)
    server = StreamingServer(idx, batch_size=4, k=5, timeout_s=0.0)
    attempts, rejected = 0, 0
    for kind in ("nan", "inf", "-inf"):
        attempts += 1
        try:
            server.submit(poison_vector(DIM, kind=kind, seed=attempts), 10.0, 90.0)
        except ValueError:
            rejected += 1
    good = rng.standard_normal(DIM).astype(np.float32)
    for s_q, t_q in ((float("nan"), 90.0), (10.0, float("inf"))):
        attempts += 1
        try:
            server.submit(good, s_q, t_q)
        except ValueError:
            rejected += 1
    # a clean query still goes through after the rejections
    rid = server.submit(good, 10.0, 90.0)
    out = server.step(force=True)
    return {
        "attempts": attempts, "rejected": rejected,
        "ok": rejected == attempts and rid in out,
    }


def _phase_overload(rng, kw) -> dict:
    """Bounded queue: the burst overflow is shed, the rest answered."""
    idx = StreamingIndex(DIM, "containment", **kw)
    _insert_stream(rng, idx, 32)
    adm = AdmissionController(
        AdmissionConfig(max_queue=16, default_deadline_s=5.0), batch_size=4,
    )
    server = StreamingServer(idx, batch_size=4, k=5, timeout_s=0.0,
                             admission=adm)
    submitted, shed = 0, 0
    max_depth = 0
    for _ in range(48):
        try:
            server.submit(rng.standard_normal(DIM).astype(np.float32),
                          10.0, 90.0)
            submitted += 1
        except RequestShed:
            shed += 1
        max_depth = max(max_depth, server.batcher.pending)
    answered = {}
    while server.batcher.pending:
        answered.update(server.step(force=True))
    return {
        "submitted": submitted, "shed": shed, "answered": len(answered),
        "max_queue_depth": max_depth,
        "ok": (shed > 0 and len(answered) == submitted
               and max_depth <= adm.config.max_queue),
    }


def _phase_crash(rng, seed, kw) -> dict:
    """Torn WAL tail: snapshot + surviving-tail recovery must be
    bit-identical to a from-scratch replay of the same surviving records."""
    workdir = tempfile.mkdtemp(prefix="repro-torch-chaos-wal-")
    try:
        wal = WriteAheadLog(workdir, segment_bytes=4096, sync="rotate")
        idx = StreamingIndex(DIM, "containment", wal=wal, **kw)
        _insert_stream(rng, idx, kw["delta_capacity"] + 10)
        idx.save_snapshot(workdir, prune_wal=False)
        tail_ids = _insert_stream(rng, idx, 12)
        for e in tail_ids[:3]:
            idx.delete(int(e))
        wal.close()
        seg = wal.active_segment_path
        # tear inside the final record: cut 1..12 bytes off the end
        cut = int(np.random.default_rng(seed).integers(1, 13))
        torn_at = truncate_file(
            seg, keep_bytes=max(0, os.path.getsize(seg) - cut)
        )
        rec, report = recover(workdir, dim=DIM, relation="containment", **kw)
        oracle = StreamingIndex(DIM, "containment", **kw)
        ro = WriteAheadLog(workdir, sync="never")
        n_oracle = 0
        for r in ro.replay(after_lsn=0):
            oracle.apply_record(r)
            n_oracle += 1
        ro.close()
        q = rng.standard_normal((8, DIM)).astype(np.float32)
        sq, tq = np.full(8, 20.0), np.full(8, 80.0)
        i1, d1 = rec.search(q, sq, tq, k=5)[:2]
        i2, d2 = oracle.search(q, sq, tq, k=5)[:2]
        parity = (np.array_equal(np.asarray(i1), np.asarray(i2))
                  and np.array_equal(np.asarray(d1), np.asarray(d2)))
        return {
            "cut_bytes": cut, "torn_size": torn_at,
            "snapshot_found": report.snapshot_found,
            "truncated": report.truncated,
            "tail_replayed": report.records_replayed,
            "recovery_seconds": round(report.recovery_seconds, 4),
            "parity": parity,
            "ok": parity and report.snapshot_found and report.truncated,
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# --- segmented tier: seeded crash-point sweep ---------------------------------

_CRASH_POINTS = ("mid_insert", "mid_compaction", "between_snapshots",
                 "wal_corrupt", "snapshot_corrupt")
_RELATIONS = ("containment", "overlap", "query_within_data",
              "both_after", "both_before")


def _segmented_fixture(relation, rng, kw, storage, *, wal_segment_bytes):
    n = 120
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    lo = rng.uniform(0.0, SPAN * 0.6, n)
    hi = lo + rng.uniform(1.0, SPAN * 0.4, n)
    rel = get_relation(relation)
    grid = SegmentGrid.from_space(
        DominanceSpace.from_intervals(rel, lo, hi), 2
    )
    idx = SegmentedStreamingIndex(
        DIM, relation, grid,
        policy=CompactionPolicy(max_delta_fraction=0.05, min_mutations=16),
        build_kwargs=dict(M=6, Z=24, K_p=4), M=6, Z=24, K_p=4,
        storage_dir=storage, wal_segment_bytes=wal_segment_bytes,
        **kw,
    )
    return idx, grid, vecs, lo, hi


def _segmented_queries(rng):
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    sq = np.full(6, SPAN * 0.2)
    tq = np.full(6, SPAN * 0.8)
    return q, sq, tq


def _close_wals(idx):
    """Simulate the crash: abandon the in-memory index, releasing its WAL
    handles so recovery reopens the files cleanly."""
    for w in idx._wals:
        if w is not None:
            w.close()


def _replay_oracle(idx_recovered, workdir, grid, relation, kw):
    """Never-crashed oracle: a fresh storage-free index that applies each
    cell's SURVIVING WAL records from scratch (replay stops at any
    corruption on its own — the same surviving set recovery saw). Valid
    whenever the WALs were never pruned (full history, LSN 1 onward)."""
    oracle = SegmentedStreamingIndex(
        DIM, relation, grid,
        policy=CompactionPolicy(max_delta_fraction=0.05, min_mutations=16),
        build_kwargs=dict(M=6, Z=24, K_p=4), M=6, Z=24, K_p=4, **kw,
    )
    for ci in range(oracle.num_segments):
        ro = WriteAheadLog(segment_dir(workdir, ci), sync="never")
        for r in ro.replay(after_lsn=0):
            oracle.subs[ci].apply_record(r)
        ro.close()
    return oracle


def _parity(a, b) -> bool:
    return (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
            and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))


def _run_crash_point(point, relation, inj, seed, kw) -> dict:
    """One seeded crash scenario against the segmented durability stack.
    Returns a dict with an ``ok`` verdict; parity is always bit-exact ids
    AND distances against the scenario's oracle."""
    rng = np.random.default_rng(seed * 1009 + _CRASH_POINTS.index(point))
    sub_rng = np.random.default_rng(seed * 2027 + _CRASH_POINTS.index(point))
    workdir = tempfile.mkdtemp(prefix=f"repro-torch-chaos-seg-{point}-")
    # quarantine needs genuinely pruned WAL history -> tiny segments;
    # replay-oracle scenarios need the FULL history -> big segments
    seg_bytes = 1024 if point == "snapshot_corrupt" else (1 << 20)
    out = {"point": point, "relation": relation}
    try:
        idx, grid, vecs, lo, hi = _segmented_fixture(
            relation, rng, kw, workdir, wal_segment_bytes=seg_bytes,
        )
        idx.insert_batch(vecs, lo, hi)
        idx.save_snapshot()
        # per-cell WAL high-water marks at the checkpoint: corruption at
        # or past these offsets is guaranteed post-checkpoint
        ckpt_sizes = [
            os.path.getsize(w.active_segment_path) if w is not None else 0
            for w in idx._wals
        ]
        tail_v = rng.standard_normal((24, DIM)).astype(np.float32)
        tail_lo = rng.uniform(0.0, SPAN * 0.6, 24)
        tail_hi = tail_lo + rng.uniform(1.0, SPAN * 0.4, 24)
        tail_ids = idx.insert_batch(tail_v, tail_lo, tail_hi)
        for e in tail_ids[:5]:
            idx.delete(int(e))
        hot = int(np.argmax([sub.live_count for sub in idx.subs]))
        q, sq, tq = _segmented_queries(rng)
        pre = idx.search(q, sq, tq, k=5)
        rkw = dict(
            policy=CompactionPolicy(max_delta_fraction=0.05,
                                    min_mutations=16),
            build_kwargs=dict(M=6, Z=24, K_p=4),
            wal_segment_bytes=seg_bytes,
            device=kw["device"],
        )

        if point == "mid_insert":
            # crash inside a WAL append: tear 1..12 bytes off the hot
            # cell's active segment, mid-record
            _close_wals(idx)
            path = os.path.join(
                segment_dir(workdir, hot),
                sorted(p for p in os.listdir(segment_dir(workdir, hot))
                       if p.startswith("wal-"))[-1],
            )
            cut = int(sub_rng.integers(1, 13))
            truncate_file(path, keep_bytes=max(
                0, os.path.getsize(path) - cut))
            rec, report = SegmentedStreamingIndex.recover(workdir, **rkw)
            oracle = _replay_oracle(rec, workdir, grid, relation, kw)
            ok = (_parity(rec.search(q, sq, tq, k=5),
                          oracle.search(q, sq, tq, k=5))
                  and report.quarantined == [])
            out.update(cut_bytes=cut, replayed=report.records_replayed,
                       ok=ok)

        elif point == "mid_compaction":
            # crash while the hot cell compacts: the injected error aborts
            # build_epoch mid-flight; on-disk state is untouched WAL + the
            # checkpoint, so recovery must not notice
            victims = idx.subs[hot].live_ids()[:20]
            for e in victims:
                idx.delete(int(e))
            pre = idx.search(q, sq, tq, k=5)
            inj.add(f"chaos.seg.compact.{point}", FaultSpec("error",
                                                            max_hits=1))
            raised = False
            with inj.injected(idx.subs[hot], "build_epoch",
                              f"chaos.seg.compact.{point}"):
                try:
                    idx.maybe_compact()
                except Exception:
                    raised = True
            _close_wals(idx)
            rec, report = SegmentedStreamingIndex.recover(workdir, **rkw)
            oracle = _replay_oracle(rec, workdir, grid, relation, kw)
            ok = (raised
                  and _parity(rec.search(q, sq, tq, k=5),
                              oracle.search(q, sq, tq, k=5))
                  and _parity(rec.search(q, sq, tq, k=5), pre)
                  and report.quarantined == [])
            out.update(injected=raised, ok=ok)

        elif point == "between_snapshots":
            # crash between two segment snapshots of ONE coordinated
            # checkpoint: cells before the fault wrote their new
            # generation, the manifest was never published -> recovery
            # lands on the previous generation + full WAL tails,
            # bit-identical to the pre-crash index
            inj.add(f"chaos.seg.snap.{point}", FaultSpec("error",
                                                         max_hits=1))
            raised = False
            with inj.injected(idx.subs[1], "save_snapshot",
                              f"chaos.seg.snap.{point}"):
                try:
                    idx.save_snapshot()
                except Exception:
                    raised = True
            gen_on_disk = int(read_manifest(workdir)["generation"])
            _close_wals(idx)
            rec, report = SegmentedStreamingIndex.recover(workdir, **rkw)
            # orphan generation-2 files from the aborted checkpoint are GC'd
            orphans = [
                p for ci in range(rec.num_segments)
                for p in os.listdir(segment_dir(workdir, ci))
                if p.startswith("snapshot-") and "00000002" in p
            ]
            ok = (raised and gen_on_disk == 1 and report.generation == 1
                  and not orphans
                  and _parity(rec.search(q, sq, tq, k=5), pre)
                  and report.quarantined == [])
            out.update(injected=raised, orphans=len(orphans), ok=ok)

        elif point == "wal_corrupt":
            # random byte corruption in a cell's post-checkpoint WAL
            # region: the CRC framing localizes it; everything after the
            # bad byte is dead, everything before survives. (Corruption
            # BEFORE the checkpoint LSN would make recovery — snapshot +
            # tail — legitimately beat a full-replay oracle, so the
            # offset is drawn from the post-checkpoint bytes of the cell
            # with the longest tail.)
            tgt = int(np.argmax([
                os.path.getsize(w.active_segment_path) - ckpt_sizes[ci]
                for ci, w in enumerate(idx._wals)
            ]))
            _close_wals(idx)
            path = os.path.join(
                segment_dir(workdir, tgt),
                sorted(p for p in os.listdir(segment_dir(workdir, tgt))
                       if p.startswith("wal-"))[-1])
            size = os.path.getsize(path)
            off = int(sub_rng.integers(ckpt_sizes[tgt], size))
            corrupt_byte(path, off)
            rec, report = SegmentedStreamingIndex.recover(workdir, **rkw)
            oracle = _replay_oracle(rec, workdir, grid, relation, kw)
            ok = (_parity(rec.search(q, sq, tq, k=5),
                          oracle.search(q, sq, tq, k=5))
                  and report.quarantined == [])
            out.update(corrupt_offset=off, ok=ok)

        elif point == "snapshot_corrupt":
            # corrupt the manifest-referenced snapshot of one cell whose
            # WAL history was pruned at checkpoint -> the cell is
            # unrecoverable and must be QUARANTINED, with searches exact
            # over the survivors and the gap flagged
            _close_wals(idx)
            man = read_manifest(workdir)
            # the victim must sit on the query route, or the answer would
            # not be degraded: most-live cell among the routed ones
            x_q, y_q = get_relation(relation).query_map(sq, tq)
            routed = np.flatnonzero(
                grid.route_values(x_q, y_q).any(axis=0))
            victim = int(max(
                routed, key=lambda ci: idx.subs[ci].live_count,
            )) if routed.size else hot
            # healthy recovery while the dir is still intact: the
            # degraded-answer oracle AND the runtime-fault self-heal check
            healthy, _ = SegmentedStreamingIndex.recover(workdir, **rkw)
            healthy.quarantine_segment(victim, "runtime poison")
            oids, od, oinfo = healthy.search(q, sq, tq, k=5,
                                             return_partial=True)
            healthy_rebuilt = healthy.maybe_rebuild()
            heal_ok = (healthy_rebuilt == {victim: True}
                       and _parity(healthy.search(q, sq, tq, k=5), pre))
            _close_wals(healthy)
            # now the crash: random byte corruption in the victim's
            # manifest-referenced snapshot (its WAL history was pruned at
            # checkpoint -> unrecoverable -> quarantine)
            snap = os.path.join(segment_dir(workdir, victim),
                                man["segments"][victim]["snapshot"])
            off = int(sub_rng.integers(0, os.path.getsize(snap)))
            corrupt_byte(snap, off)
            # a victim whose WAL never rotated past the checkpoint kept its
            # whole history (LSN 1 onward), so recovery rebuilds it from the
            # log: nothing is quarantined and the answer is the pre-crash
            # one. (The JAX package expects a quarantine here too, and its
            # run fails whenever this point draws such a cell: ROADMAP C3.)
            ro = WriteAheadLog(segment_dir(workdir, victim), sync="never")
            first = next(iter(ro.replay(after_lsn=0)), None)
            ro.close()
            whole = first is not None and first.lsn == 1
            rec, report = SegmentedStreamingIndex.recover(workdir, **rkw)
            ids, d, info = rec.search(q, sq, tq, k=5, return_partial=True)
            C = rec.num_segments
            leaked = bool(np.any((ids >= 0) & (ids % C == victim)))
            rebuild = rec.maybe_rebuild()     # storage still corrupt
            if whole:
                ok = (report.quarantined == [] and not info.degraded
                      and _parity((ids, d), pre)
                      and rebuild == {}
                      and heal_ok)
            else:
                ok = (report.quarantined == [victim]
                      and info.degraded and info.missing_segments == [victim]
                      and oinfo.missing_segments == [victim]
                      and _parity((ids, d), (oids, od))
                      and not leaked
                      and rebuild == {victim: False}
                      and heal_ok)
            out.update(victim=victim, history_whole=whole,
                       degraded=bool(info.degraded),
                       rebuild_blocked=rebuild == {victim: False},
                       heal_ok=heal_ok, ok=ok)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _phase_segmented(inj, seed, kw) -> dict:
    """Deterministic segmented crash sweep: every crash point runs once,
    each against a different predicate relation (the pairing rotates with
    the seed, so a 5-seed sweep covers the full product)."""
    runs = []
    for i, point in enumerate(_CRASH_POINTS):
        relation = _RELATIONS[(i + seed) % len(_RELATIONS)]
        runs.append(_run_crash_point(point, relation, inj, seed, kw))
    return {
        "runs": runs,
        "ok": all(r["ok"] for r in runs),
    }


def run_chaos(seed: int = 0, *, tiny: bool = False, device=None) -> dict:
    """Run all phases; returns a summary dict with per-phase ``ok``
    verdicts. The fault schedule, mutation stream, and corruption offset
    are pure functions of ``seed``; only wall-clock measurements vary.
    Every index lives on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    inj = FaultInjector(seed)
    kw = (dict(node_capacity=256, delta_capacity=64, edge_capacity=16)
          if tiny else
          dict(node_capacity=1024, delta_capacity=128, edge_capacity=32))
    kw["device"] = device
    summary = {"seed": seed, "tiny": tiny, "device": str(device)}
    summary["compaction"] = _phase_compaction(rng, inj, kw)
    summary["poison"] = _phase_poison(rng, kw)
    summary["overload"] = _phase_overload(rng, kw)
    summary["crash_recovery"] = _phase_crash(rng, seed, kw)
    summary["segmented"] = _phase_segmented(inj, seed, kw)
    summary["faults_fired"] = len(inj.fired)
    summary["ok"] = all(
        summary[p]["ok"]
        for p in ("compaction", "poison", "overload", "crash_recovery",
                  "segmented")
    )
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos scenario over the fault-tolerant serving core",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="small sizes for CI smoke")
    ap.add_argument("--json", type=str, default=None,
                    help="write the summary dict to this path")
    ap.add_argument("--device", type=str, default=None,
                    help="where every index lives (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    summary = run_chaos(args.seed, tiny=args.tiny, device=args.device)
    out = json.dumps(summary, indent=2, default=str)
    print(out)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(out + "\n")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
