#!/usr/bin/env python3
"""The readings the limits of ``check.py`` are set from, in one process.

    python3 udg_bench/calibrate.py --workload NAME --seeds 1,2,... --seconds S
        [--control-seeds 1,2,3] [--faults one_block,graph_only --fault-seeds 4,5,6]

Restores (or builds) the cell's index once, then for each seed makes the
seed's traffic, sends two warm-up batches, runs the closed loop for
``--seconds`` and reads the program's numbers on the sample a run judges
(``run.judge_window``): one ``program`` line a seed. For each control seed
the reference in TF32 (``reference.py``, ``precision="tf32"``) answers the
same sampled queries in the program's place and is read by the same
comparison: one ``control`` line a seed. For each fault (``faults.py``) and
fault seed, the program runs the same window with the fault planted
underneath and is read the same way: one ``fault`` line each. The last
line gives, for each number, the program's worst reading (the largest, or
for a number held to a floor the smallest), the control's and each
fault's best reading on the other side, and the cell's limits. Needs the
card.

A sharded cell (``sharded.py``) runs the same windows in every rank, each
fault planted in every rank, and rank 0 reads them. Its first window's
first batches are then served again in rank 0 alone, on a host mesh over
every shard, and each rank's answers are compared with those bit for bit:
one ``mesh`` line.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from udg_bench import check, faults, run, spec, traffic  # noqa: E402


def worst(side: str, name: str, a, b):
    """The program's worst reading of ``name``, or a control's or fault's
    reading nearest to passing."""
    high = (check.NUMBERS[name] == "max") == (side == "program")
    return max(a, b) if high else min(a, b)


def calibrate(cell, seeds: list, controls: set, planted: list, seconds: float, *,
              device="cuda", cache_dir: Path = run.index_cache.CACHE_DIR) -> dict:
    """Emit one line a reading and return, for each side ("program",
    "control" and each planted fault's name), its worst reading of each
    number (``worst``). ``planted``: (fault name, seed) pairs."""
    if "serve" in cell.config:
        return calibrate_sharded(cell, seeds, controls, planted, seconds, device=device,
                                 cache_dir=cache_dir)
    import pytest

    from udg_bench.reference import Corpus

    run.import_program()
    dg, setup = run.load_index(cell, device, cache_dir)
    run.emit({"index": setup})
    data = cell.config["data"]
    s, t = run.datagen.make_intervals(cell.config["n"], T=data["T"], seed=data["data_seed"])
    vecs, _, _ = run.corpus(cell.config)
    exact = Corpus(vecs, s, t, cell.config["relation"], device, "exact")
    tf32 = Corpus(vecs, s, t, cell.config["relation"], device, "tf32")
    k = cell.config["search"]["k"]
    reads = {}

    note = noter(cell, reads)

    def window(seed):
        qs = traffic.make_traffic(cell.traffic, cell.config, s, t, seed, device)
        run.warm_up(cell, dg, qs, device)
        win = run.run_window(cell, dg, qs, seconds, False, device)
        return win, run.sampled(cell, qs, win, seed)

    for seed in seeds:
        win, smp = window(seed)
        q, sq, tq = smp["q"], smp["s_q"], smp["t_q"]
        note("program", seed, win, check.judge_answers(exact, q, sq, tq, smp["ids"], smp["dist"], k))
        if seed in controls:
            c_ids, c_dist, _ = tf32.topk(q, sq, tq, k)
            note("control", seed, win, check.judge_answers(exact, q, sq, tq, c_ids, c_dist, k))
    for name, seed in planted:
        with pytest.MonkeyPatch.context() as mp:
            faults.FAULTS[name](mp)
            win, smp = window(seed)
        note(name, seed, win, check.judge_answers(exact, smp["q"], smp["s_q"], smp["t_q"],
                                                  smp["ids"], smp["dist"], k))
    run.emit({"readings": reads, "limits": {n: cell.limits[n] for n in check.NUMBERS}})
    return reads


def noter(cell, reads: dict):
    """``note(side, seed, win, read)``: emit one reading and keep each
    side's worst in ``reads``."""

    def note(side, seed, win, read):
        run.emit({"fault" if side not in ("program", "control") else side:
                  {"side": side, "seed": seed, "batches": win["sent"], **read,
                   "correct": check.judge(read, cell.limits)[0]}})
        got = reads.setdefault(side, {})
        for name in check.NUMBERS:
            got[name] = worst(side, name, got.get(name, read[name]), read[name])

    return note


def calibrate_sharded(cell, seeds: list, controls: set, planted: list, seconds: float, *,
                      device="cuda", cache_dir: Path = run.index_cache.CACHE_DIR) -> dict:
    """``calibrate`` for a sharded cell: every window in every rank, read on
    rank 0; then the host-mesh comparison of the first window's first
    ``sharded.KEEP_BATCHES`` batches."""
    import time

    import numpy as np
    import torch

    from udg_bench import sharded
    from udg_bench.reference import Corpus

    run.import_program()
    from repro_torch.distributed.mesh import make_host_mesh
    from repro_torch.kernels import _build
    from repro_torch.serve.distributed import serve_batch

    if torch.device(device).type == "cuda":
        run.emit({"kernels": {"nvcc_s": _build.build_all(run.KERNELS)}})
    vecs, s, t = run.corpus(cell.config)
    exact = Corpus(vecs, s, t, cell.config["relation"], device, "exact")
    tf32 = Corpus(vecs, s, t, cell.config["relation"], device, "tf32")
    del vecs
    k = cell.config["search"]["k"]
    reads, kept = {}, {}
    note = noter(cell, reads)
    windows = ([{"seed": sd, "seconds": seconds, "trace": False, "fault": None, "keep": i == 0}
                for i, sd in enumerate(seeds)]
               + [{"seed": sd, "seconds": seconds, "trace": False, "fault": name}
                  for name, sd in planted])

    def judge(w, win, qs, records, setup):
        smp = run.sampled(cell, qs, win, w["seed"])
        q, sq, tq = smp["q"], smp["s_q"], smp["t_q"]
        note(w["fault"] or "program", w["seed"], win,
             check.judge_answers(exact, q, sq, tq, smp["ids"], smp["dist"], k))
        if w["fault"] is None and w["seed"] in controls:
            c_ids, c_dist, _ = tf32.topk(q, sq, tq, k)
            note("control", w["seed"], win, check.judge_answers(exact, q, sq, tq, c_ids, c_dist, k))
        if w.get("keep"):
            rows = [traffic.batch_rows(cell.traffic, b) for b in range(sharded.KEEP_BATCHES)]
            kept.update(qs=[{name: qs[name][r] for name in ("q", "s_q", "t_q")} for r in rows],
                        answers=[r["answers"] for r in records],
                        backends=[r["backend"] for r in records],
                        cards=[r["card"] for r in records],
                        graphs=[r["graphs"] for r in records],
                        plan_mix=[{n[5:]: v for n, v in r["counters"].items()
                                   if n.startswith("plan.")} for r in records])

    index = sharded.run_ranks(cell, windows, judge, device=device, cache_dir=cache_dir,
                              t_start=time.perf_counter())
    run.emit({"index": index})
    if kept:
        world = cell.config["serve"]["shards"]
        idx = sharded.restore_index(sharded.shard_files(cell, world, cache_dir))
        mesh = make_host_mesh(world, device=device)
        search = cell.config["search"]
        host = [serve_batch(idx, mesh, qs["q"], qs["s_q"], qs["t_q"], k=search["k"],
                            beam=search["beam"], merge=cell.config["serve"]["merge"],
                            plan=search["plan"])
                for qs in kept["qs"][:len(kept["answers"][0])]]
        equal = [[bool(np.array_equal(a[0], h[0]) and np.array_equal(a[1], h[1]))
                  for a, h in zip(answers, host)] for answers in kept["answers"]]
        run.emit({"mesh": {"batches": len(host), "bit_equal_by_rank": equal,
                           **{key: kept[key] for key in ("backends", "cards", "graphs", "plan_mix")}}})
    run.emit({"readings": reads, "limits": {n: cell.limits[n] for n in check.NUMBERS}})
    return reads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated names in faults.FAULTS")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def ints(text):
        return [int(x) for x in text.split(",") if x]

    calibrate(spec.load_cell(args.workload), ints(args.seeds), set(ints(args.control_seeds)),
              [(name, seed) for name in args.faults.split(",") if name
               for seed in ints(args.fault_seeds)], args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
