#!/usr/bin/env python3
"""A sharded cell: one process and one shard a card, the program's
``serve_batch`` over a process group.

A configuration with a ``serve`` group (``shards``, ``merge``) is the
udg-serve deployment as ``repro_torch.launch.serve`` runs it: the corpus of
``n`` rows split round-robin (row i on shard i mod S, as
``serve.distributed.build_sharded_index`` splits it), one UDG a shard, one
process and one card a shard. ``run.py`` is rank 0: it builds the kernels,
then starts ranks 1 .. S-1 from this file, each with ``CUDA_VISIBLE_DEVICES``
naming its own card, and their output on its standard error. The ranks meet
on a ``FileStore`` in a temporary directory; NCCL (gloo on the CPU) carries
the program's tensors, and a gloo group the harness's own flags and records.

A run, on every rank:

1. set-up: on a checkout's first run each rank builds its own shard's index
   on its card (``index_cache.build``, the single-card cells' constructor
   call) and saves it as ``udg_bench/cache/<config>/shard<r>-<key>.npz``;
   every run restores all of them on the host, stacks them (``stack_shards``)
   and stages its own shard on its card, makes the traffic from ``--seed``
   (every rank the same, which they check) and sends two batches;
2. the window (``run.run_window``): every rank sends the same batches to
   ``serve_batch`` on ``make_process_mesh(model=S)``; rank 0 times each call
   to its return, the merge and the wait for the slowest shard included,
   and after each batch decides whether another follows and tells the
   others (``Ranks.agree``), so that no rank waits in a collective the others
   never enter;
3. after it: each rank's counters, graph replays, memory peak and loaded
   modules go to rank 0, the ranks leave, and rank 0 frees the index and
   judges the sample against the reference over the whole corpus.

No run hangs: rank 0 watches the ranks it started and they watch rank 0, so
a rank that ends early ends the run within a second; a watchdog on each rank
ends the run when a stage outlasts its deadline (``DEADLINES``: a batch 60 s);
the process groups time out after ``PG_TIMEOUT_S`` besides. A run ended so
exits 3 and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import zlib
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from udg_bench import check, datagen, faults, index_cache, run, spec, traffic  # noqa: E402

# seconds a stage may take on a rank before its watchdog ends the run
DEADLINES = {"start": 300, "build": 1100, "set-up": 300, "batch": 60, "leave": 120}
PG_TIMEOUT_S = 1200          # the process groups' own timeout, a backstop
KEEP_BATCHES = 3             # answers each rank hands rank 0 where asked (calibrate.py)
# program entry points timed and labelled in a traced run: (module, attribute, label)
LABELS = (
    ("repro_torch.serve.distributed", "plan_sharded_batch", "shard_plan"),
    ("repro_torch.serve.distributed", "planned_exec_core", "shard_search"),
    ("repro_torch.serve.distributed", "_merge_across_shards", "shard_merge"),
    ("repro_torch.exec.executor", "search_core", "search_core"),
    ("repro_torch.exec.executor", "brute_topk_impl", "brute_scan"),
)


class Patch:
    """``setattr`` that ``undo`` takes back in reverse order: the part of
    ``pytest.MonkeyPatch`` that ``faults.py`` uses."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


class Watchdog:
    """Ends this process, and the ranks it started, when the armed stage
    outlasts its deadline, a rank it started ends before ``leaving`` is set,
    or the process that started it ends."""

    def __init__(self, rank: int, children=(), parent: int | None = None):
        self.rank, self.children, self.parent = rank, list(children), parent
        self.leaving = False        # from here on the ranks end, and rank 0 reads their codes
        self.stage, self.deadline = "start", time.monotonic() + DEADLINES["start"]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="udg_bench-watchdog",
                                        daemon=True)
        self._thread.start()

    def arm(self, stage: str) -> None:
        self.stage, self.deadline = stage, time.monotonic() + DEADLINES[stage]

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _watch(self) -> None:
        while not self._stop.wait(0.2):
            why = None
            if time.monotonic() > self.deadline:
                why = f"the stage {self.stage!r} outlasted its {DEADLINES[self.stage]} s"
            for r, proc in self.children:
                code = proc.poll()
                if code is not None and not self.leaving:
                    why = f"rank {r} ended with code {code} during {self.stage!r}"
            if self.parent is not None and os.getppid() != self.parent:
                why = "rank 0 ended"
            if why:
                self.fail(why)

    def fail(self, why: str) -> None:
        print(f"udg_bench: rank {self.rank}: {why}; ending the run", file=sys.stderr, flush=True)
        end_children(self.children)
        os._exit(3)


def end_children(children) -> None:
    """Kill the ranks still running and wait until each has ended."""
    for _, proc in children:
        if proc.poll() is None:
            proc.kill()
    for _, proc in children:
        proc.wait()


class Ranks:
    """This process's place in the run: its rank, the process group of the
    program's tensors (NCCL on cards, gloo on the CPU), a gloo group for the
    harness's flags and records, and its watchdog."""

    def __init__(self, rank: int, world: int, store: str, device, watchdog: Watchdog):
        self.rank, self.world, self.store, self.device = rank, world, store, device
        self.watchdog = watchdog
        self.ctl = None
        self.agree_s = 0.0

    def open(self) -> None:
        import torch
        import torch.distributed as dist

        timeout = timedelta(seconds=PG_TIMEOUT_S)
        store = dist.FileStore(self.store, self.world)
        if self.device.type == "cuda":
            dist.init_process_group("nccl", store=store, rank=self.rank, world_size=self.world,
                                    timeout=timeout, device_id=torch.device("cuda", 0))
        else:
            dist.init_process_group("gloo", store=store, rank=self.rank, world_size=self.world,
                                    timeout=timeout)
        self.ctl = dist.new_group(backend="gloo", timeout=timeout)

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    def agree(self, go: bool) -> bool:
        """Rank 0's ``go``, on every rank; arms the next batch's deadline."""
        import torch
        import torch.distributed as dist

        self.watchdog.arm("batch")
        t0 = time.perf_counter()
        flag = torch.tensor([int(bool(go))], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.ctl)
        self.agree_s += time.perf_counter() - t0
        return bool(flag.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.ctl)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.ctl)

    def same(self, value, what: str) -> None:
        """Raise unless every rank holds the same ``value``."""
        seen = self.gather(value)
        if any(v != seen[0] for v in seen):
            raise ValueError(f"the ranks disagree on {what}: {seen}")


def stack_shards(dgs: list, relation: str):
    """The program's ``ShardedIndex`` over one export a shard, stacked as
    ``serve.distributed.build_sharded_index`` stacks its builds: a copy of
    that function's second half, which the program does not expose on its
    own (``PERF.md`` section 7)."""
    from repro_torch.serve.distributed import ShardedIndex, _padE

    S = len(dgs)
    E = max(dg.max_degree for dg in dgs)
    ux = max(dg.U_X.shape[0] for dg in dgs)
    uy = max(dg.U_Y.shape[0] for dg in dgs)
    vec = np.stack([dg.vectors for dg in dgs])
    nbr = np.stack([_padE(dg.nbr, E, -1) for dg in dgs])
    if all(dg.plabels is not None for dg in dgs):
        lab = np.stack([_padE(dg.plabels, E, 0) for dg in dgs])
    else:
        lab = np.stack([_padE(dg.labels_i32(), E, 0) for dg in dgs])
    nrm = np.stack([dg.norms for dg in dgs])
    UX = np.full((S, ux), np.inf, np.float32)
    UY = np.full((S, uy), np.inf, np.float32)
    ent = np.full((S, ux), -1, np.int32)
    enty = np.full((S, ux), np.iinfo(np.int32).max, np.int32)
    num_y = np.zeros(S, np.int32)
    for i, dg in enumerate(dgs):
        kx = dg.U_X.shape[0]
        UX[i, :kx] = dg.U_X.astype(np.float32)
        UY[i, : dg.U_Y.shape[0]] = dg.U_Y.astype(np.float32)
        num_y[i] = dg.U_Y.shape[0]
        ent[i, :kx] = dg.entry_node
        enty[i, :kx] = dg.entry_y_rank
    return ShardedIndex(
        vectors=vec, nbr=nbr, labels=lab, norms=nrm, U_X=UX, U_Y=UY, num_y=num_y,
        entry_node=ent, entry_y_rank=enty, relation=relation, n_local=int(vec.shape[1]),
        planners=[dg.planner for dg in dgs])


def shard_files(cell, world: int, cache_dir: Path) -> list:
    """Each shard's cached export, under the configuration's own folder (so
    that no single-card configuration's clean-up reaches it)."""
    key = index_cache.digest(cell.config_file, ROOT / "src" / "repro_torch")
    return [Path(cache_dir) / cell.config_name / f"shard{r}-{key}.npz" for r in range(world)]


def build_shard(cell, ranks: Ranks, path: Path) -> dict:
    """Build this rank's shard (rows r, r + S, ...) on its device and save it."""
    t0 = time.perf_counter()
    vecs, s, t = run.corpus(cell.config)
    rows = np.arange(ranks.rank, cell.config["n"], ranks.world)
    vecs, s, t = np.ascontiguousarray(vecs[rows]), s[rows], t[rows]
    rec = {"rank": ranks.rank, "corpus_s": time.perf_counter() - t0}
    arrays, report = index_cache.build(cell.config, vecs, s, t, ranks.device)
    rec.update(report)
    t0 = time.perf_counter()
    index_cache.save(arrays, path)
    rec["save_s"] = time.perf_counter() - t0
    rec["cache_bytes"] = path.stat().st_size
    return rec


def load_shards(cell, ranks: Ranks, mesh, cache_dir: Path) -> tuple:
    """(ShardedIndex, set-up record): every shard built where its file is
    missing, then all restored on the host and stacked, this rank's staged."""
    import torch

    paths = shard_files(cell, ranks.world, cache_dir)
    rec = {"cache": [p.name for p in paths]}
    rec["built"] = ranks.agree(not all(p.exists() for p in paths))
    if rec["built"]:
        ranks.watchdog.arm("build")
        if ranks.rank == 0:
            for old in paths[0].parent.glob("*.npz"):
                if old not in paths:
                    old.unlink()
        mine = paths[ranks.rank]
        rec["shards"] = ranks.gather(None if mine.exists() else build_shard(cell, ranks, mine))
        gc.collect()
    ranks.watchdog.arm("set-up")
    if ranks.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    idx = restore_index(paths)
    staged = idx.device(mesh.device, mesh.local_shards)
    if ranks.device.type == "cuda":
        torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    rec["device_bytes"] = {k: int(v.numel() * v.element_size()) for k, v in staged.items()}
    rec["E"], rec["n_local"] = int(idx.nbr.shape[2]), int(idx.n_local)
    return idx, rec


def restore_index(paths: list):
    """Every shard's export restored on the host and stacked."""
    dgs = [index_cache.restore(p, "cpu") for p in paths]
    return stack_shards(dgs, dgs[0].relation)


def serve_send(cell, served, qs: dict, i: int, device) -> tuple:
    """The i-th batch through the program's sharded serving path: (ids, d)."""
    from repro_torch.serve.distributed import serve_batch

    idx, mesh = served
    rows = traffic.batch_rows(cell.traffic, i)
    search, serve = cell.config["search"], cell.config["serve"]
    return serve_batch(idx, mesh, qs["q"][rows], qs["s_q"][rows], qs["t_q"][rows],
                       k=search["k"], beam=search["beam"], merge=serve["merge"],
                       plan=search["plan"])


def graph_tally(patch: Patch) -> dict:
    """Count the search loop's captured searches: each call of
    ``search.batched._graph_entry`` (a packed, fused search on the card) that
    captured its graphs, replayed them, or ran eagerly."""
    from repro_torch.search import batched

    take = batched._graph_entry
    tally = {"captured": 0, "replayed": 0, "eager": 0}

    def counted(key, make):
        entry = take(key, make)
        tally["eager" if entry is None else "captured" if entry.setup is None else "replayed"] += 1
        return entry

    patch.setattr(batched, "_graph_entry", counted)
    return tally


def traffic_digest(qs: dict) -> int:
    return zlib.crc32(qs["t_q"].tobytes(), zlib.crc32(qs["s_q"].tobytes(),
                                                      zlib.crc32(qs["q"].tobytes())))


def session(cell, windows: list, ranks: Ranks, *, cache_dir: Path, t_start: float,
            on_window=None) -> dict:
    """Every rank's part of a run: set-up, then each window of ``windows``
    (``seed``, ``seconds``, ``trace``, ``fault``, ``keep``) in turn, each
    with its fault planted here; returns the index record. On rank 0
    ``on_window(w, win, qs, ranks_records, setup)`` takes each window."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_process_mesh
    from repro_torch.search import batched

    dev = ranks.device
    on_card = dev.type == "cuda"
    threads = torch.get_num_threads()
    # the ranks share one host: each takes the cores a one-card machine has
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks.world))
    try:
        ranks.open()
        if on_card:
            run.load_kernels()
        mesh = make_process_mesh(model=ranks.world, device=dev)
        idx, index_rec = load_shards(cell, ranks, mesh, cache_dir)
        data = cell.config["data"]
        s, t = datagen.make_intervals(cell.config["n"], T=data["T"], seed=data["data_seed"])
        for w in windows:
            ranks.watchdog.arm("set-up")
            setup = {"restore_s": index_rec["restore_s"]}
            patch = Patch()
            try:
                if w.get("fault"):
                    # a fresh graph cache: a fault inside the loop is captured with it
                    patch.setattr(batched, "_GRAPHS", batched.GraphCache())
                    faults.FAULTS[w["fault"]](patch)
                tally = graph_tally(patch)
                t0 = time.perf_counter()
                qs = traffic.make_traffic(cell.traffic, cell.config, s, t, w["seed"], dev)
                setup["traffic_s"] = time.perf_counter() - t0
                ranks.same(traffic_digest(qs), "the traffic")
                if on_card:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for b in range(min(2, cell.traffic["distinct_batches"])):
                    ranks.watchdog.arm("set-up")
                    serve_send(cell, (idx, mesh), qs, b, dev)
                setup["warmup_s"] = time.perf_counter() - t0
                setup["setup_s"] = time.perf_counter() - t_start
                clocks = {"before": run.smi(run.SMI_CLOCKS)} if on_card and ranks.rank == 0 else {}
                for key in tally:
                    tally[key] = 0
                ranks.barrier()         # every rank opens its window (and its trace) together
                ranks.agree_s = 0.0
                win = run.run_window(cell, (idx, mesh), qs, w["seconds"], w["trace"], dev,
                                     send=serve_send, agree=ranks.agree, labels=LABELS)
                if clocks:
                    clocks["after"] = run.smi(run.SMI_CLOCKS)
                win["clocks"], win["agree_s"] = clocks, ranks.agree_s
                tr = win.get("trace")
                mine = {
                    "rank": ranks.rank, "backend": str(dist.get_backend()),
                    "card": torch.cuda.get_device_name(0) if on_card else "cpu",
                    "batches": win["sent"], "counters": win["counters"], "graphs": dict(tally),
                    "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
                    "busy_s": tr["busy_s"] if tr else None,
                    "forbidden": run.forbidden_modules(),
                    "answers": win["outs"][:KEEP_BATCHES] if w.get("keep") else None}
                records = ranks.gather(mine)
            finally:
                patch.undo()
            if on_window is not None:
                on_window(w, win, qs, records, setup)
            del win, qs
        ranks.watchdog.arm("leave")
        ranks.watchdog.leaving = True
        ranks.barrier()
        return index_rec
    finally:
        torch.set_num_threads(threads)



def run_ranks(cell, windows: list, on_window, *, device="cuda", cache_dir: Path,
              t_start: float) -> dict:
    """Rank 0: start ranks 1 .. S-1, take part in the run (``session``), see
    every rank leave. Returns the index record; raises, or ends the process
    (``Watchdog``), when a rank fails."""
    import torch

    world = cell.config["serve"]["shards"]
    dev = torch.device(device)
    work = Path(tempfile.mkdtemp(prefix="udg_bench_ranks_"))
    store = str(work / "store")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(r) for r in range(world)]
    children = []
    watchdog = None
    ranks = None
    try:
        for r in range(1, world):
            env = dict(os.environ)
            if dev.type == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = cards[r]
            children.append((r, subprocess.Popen(
                [sys.executable, str(HERE / "sharded.py"), "--rank", str(r), "--world", str(world),
                 "--store", store, "--workload", cell.name, "--root", str(cell.root),
                 "--cache-dir", str(cache_dir), "--device", dev.type, "--windows",
                 json.dumps(windows)],
                cwd=str(cell.root), env=env, stdin=subprocess.DEVNULL, stdout=2)))
        watchdog = Watchdog(0, children)
        ranks = Ranks(0, world, store, dev, watchdog)
        index_rec = session(cell, windows, ranks, cache_dir=cache_dir, t_start=t_start,
                            on_window=on_window)
        ranks.close()
        watchdog.arm("leave")
        for r, proc in children:
            code = proc.wait(timeout=DEADLINES["leave"])
            if code != 0:
                raise RuntimeError(f"rank {r} ended with code {code}")
        return index_rec
    finally:
        if watchdog is not None:
            watchdog.leaving = True
        end_children(children)
        if ranks is not None:
            ranks.close()
        if watchdog is not None:
            watchdog.stop()
        shutil.rmtree(work, ignore_errors=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             cache_dir: Path = index_cache.CACHE_DIR, t_start: float = run.T_START,
             fault: str | None = None):
    """One run of a sharded ``cell`` from rank 0, as ``run.run_cell`` runs a
    single-card one; ``fault`` (``faults.FAULTS``) is planted in every rank.
    Returns the result object, or ``None`` after reporting why on standard
    error when the run may print none."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    run.import_program()
    from repro_torch.kernels import _build

    if on_card:
        run.emit({"card": {**run.card_info(), "nvidia_smi": run.smi("name,power.limit", cell.chips)}})
        # built once here, before the ranks start, so that no two compile at once
        run.emit({"kernels": {"nvcc_s": _build.build_all(run.KERNELS)}})
    program_s = time.perf_counter() - t_start
    got = {}

    def take(w, win, qs, records, setup):
        got.update(win=win, qs=qs, records=records, setup=setup)

    window = {"seed": seed, "seconds": seconds, "trace": trace, "fault": fault}
    index = run_ranks(cell, [window], take, device=device, cache_dir=cache_dir, t_start=t_start)
    win, records, setup = got["win"], got["records"], dict(got["setup"], program_s=program_s)
    run.emit({"index": index})
    run.emit({"setup": setup})
    c, batches = win["counters"], len(win["lat"])
    run.emit({"window": {
        "batches": batches, "queries": batches * cell.traffic["batch"], "window_s": win["window_s"],
        "plan_mix_by_shard": [{k[5:]: v for k, v in r["counters"].items() if k.startswith("plan.")}
                              for r in records],
        "graphs_by_rank": [r["graphs"] for r in records],
        "backends": [r["backend"] for r in records],
        "agree_ms_a_batch": 1e3 * win["agree_s"] / batches,
        "launches_a_batch": {k[9:]: v / batches for k, v in c.items() if k.startswith("launches.")},
        "loop_iterations_a_batch": c["loop_iterations"] / batches,
        "batch_ms": {"min": min(win["lat"]) * 1e3, "median": float(np.median(win["lat"])) * 1e3,
                     "max": max(win["lat"]) * 1e3},
        "qps_by_10s": run.qps_by_span(win["ends_s"], cell.traffic["batch"], 10.0),
        "clocks": win["clocks"],
        "memory_peak_bytes_by_rank": [r["memory_peak_bytes"] for r in records]}})
    tr = win.get("trace")
    if tr:
        run.emit({"trace": {**{k: v for k, v in tr.items() if k not in ("device_ops", "idle_gaps")},
                            "busy_s_by_rank": [r["busy_s"] for r in records]}})
    bad = sorted(set(run.forbidden_modules()).union(*(r["forbidden"] for r in records)))
    if bad:
        print(f"udg_bench: loaded modules {bad} in a rank of the run", file=sys.stderr)
        return None
    gc.collect()            # the index, staged by the session, goes with it
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    read = run.judge_window(cell, got["qs"], win, seed, device)
    correct, checks = check.judge(read, cell.limits)
    run.emit({"reference": {**read, "seconds": time.perf_counter() - t0}})
    ctx = {"setup_s": setup["setup_s"], "setup": setup, "batch": cell.traffic["batch"],
           "latencies_s": win["lat"], "window_s": win["window_s"], "spans": win["spans"],
           "counters": c, "batches": batches, "recall": read["recall"], "trace": tr}
    peak = max(r["memory_peak_bytes"] for r in records)
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": batches * cell.traffic["batch"], "failed": 0,
              "metrics": spec.read_metrics(cell.per_layer if trace else cell.end_to_end, ctx,
                                           cell.root),
              "device": device_rec}
    if trace and tr:
        # each card's busy time in the traced batches, averaged over the cards,
        # and the traced slice as rank 0 timed it: another rank's own slice
        # also holds its wait for rank 0's profiler to start
        device_rec["busy_s"] = float(np.mean([r["busy_s"] for r in records]))
        device_rec["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    """Ranks 1 .. S-1 of a run that ``run.py`` (rank 0) started."""
    ap = argparse.ArgumentParser(description="one rank of a sharded udg_bench run")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--windows", required=True, help="the run's windows, JSON")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    watchdog = Watchdog(args.rank, parent=os.getppid())
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.import_program()
    cell = spec.load_cell(args.workload, Path(args.root))
    ranks = Ranks(args.rank, args.world, args.store, torch.device(args.device), watchdog)
    try:
        session(cell, json.loads(args.windows), ranks, cache_dir=Path(args.cache_dir),
                t_start=t_start)
        ranks.close()
    except BaseException:
        # a rank that fails says why and ends at once: a process group's
        # teardown must not keep it alive
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    watchdog.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
