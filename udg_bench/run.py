#!/usr/bin/env python3
"""Run one cell of the UDG port's benchmark once.

    python3 udg_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``udg_bench/configs``), a traffic mix (``udg_bench/traffic``)
and its metrics (``udg_bench/metrics``). A run:

1. set-up: builds the port's kernels if they are not built
   (``build/repro_torch_kernels``), builds and caches the index if this
   checkout has none for the configuration (``index_cache``), restores it,
   makes the traffic from ``--seed`` and sends two of its batches;
2. the window: one client sends batches to
   ``repro_torch.exec.execute_batch`` (with the configuration's ``plan``)
   back to back for ``--seconds`` (the last batch ends the window); with
   ``--trace 1`` the
   first ``trace_batches`` go through ``torch.profiler`` and the program's
   layers are timed from here (``LABELS``);
3. after it: the peak device memory, a check that no JAX module was loaded,
   then the program's state is freed and the reference (``reference.py``)
   judges a sample of the window's answers (``check.py``).

Earlier lines of standard output are JSON records of the run; the last is
the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit, which also end standard error. Exits 2 without a card.

A cell whose configuration has a ``serve`` group runs sharded instead, one
process a card, through the program's ``serve_batch`` (``sharded.py``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import math  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from udg_bench import check, datagen, index_cache, spec, traffic  # noqa: E402
from udg_bench.devtrace import Tracer  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
KERNELS = ("filter_dist", "beam_merge")       # the kernel libraries the cells launch
SMI_CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"   # read before and after a window
# program entry points the harness times and labels in a traced run:
# (module, attribute, label)
LABELS = (
    ("repro_torch.exec.executor", "prepare_states_extended", "prepare_states"),
    ("repro_torch.exec.executor", "plan_queries", "planner"),
    ("repro_torch.exec.executor", "search_core", "search_core"),
    ("repro_torch.exec.executor", "brute_topk_impl", "brute_scan"),
)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def import_program():
    """The port, from this checkout's ``src`` and nowhere else."""
    import repro_torch

    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        raise ImportError(f"repro_torch was loaded from {where}, not from {ROOT / 'src'}")
    return repro_torch


def load_kernels() -> None:
    """Load the kernel libraries the cells launch before the first search: a
    search's captured graph is keyed on the libraries loaded, so one loaded
    inside the warm-up's first search would make the window's first batch
    capture that search again."""
    from repro_torch.kernels import _build

    for name in KERNELS:
        _build.library(name)


def card_info() -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    out["nvidia_smi"] = smi("name,power.limit")
    return out


def smi(fields: str, cards: int = 1):
    """``nvidia-smi``'s reading of ``fields`` on the first card, or a list
    over the first ``cards`` cards when that is more than one."""
    try:
        done = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read: {exc}"
    if done.returncode != 0:
        return f"not read: rc {done.returncode}"
    lines = done.stdout.strip().splitlines()
    return lines[0] if cards == 1 else lines[:cards]


def corpus(cfg: dict) -> tuple:
    d = cfg["data"]
    vecs = datagen.make_vectors(cfg["n"], cfg["dim"], clusters=d["clusters"], spread=d["spread"],
                                seed=d["data_seed"])
    s, t = datagen.make_intervals(cfg["n"], T=d["T"], seed=d["data_seed"])
    return vecs, s, t


def load_index(cell, device, cache_dir: Path) -> tuple:
    """(DeviceGraph, set-up record): built and cached on a checkout's first
    run of the configuration, restored on every run."""
    import torch

    key = index_cache.digest(cell.config_file, ROOT / "src" / "repro_torch")
    path = index_cache.cache_file(cell.config_name, key, cache_dir)
    rec = {"cache": path.name, "built": not path.exists()}
    if rec["built"]:
        t0 = time.perf_counter()
        vecs, s, t = corpus(cell.config)
        rec["corpus_s"] = time.perf_counter() - t0
        arrays, report = index_cache.build(cell.config, vecs, s, t, device)
        rec.update(report)
        for old in Path(cache_dir).glob(f"{cell.config_name}-*.npz"):
            old.unlink()
        t0 = time.perf_counter()
        index_cache.save(arrays, path)
        rec["save_s"] = time.perf_counter() - t0
        rec["cache_bytes"] = path.stat().st_size
        del arrays, vecs
        gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dg = index_cache.restore(path, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    di = dg.device(device)
    rec["device_bytes"] = {k: int(v.numel() * v.element_size())
                           for k, v in vars(di).items() if v is not None}
    rec["E"] = dg.max_degree
    rec["n"] = int(dg.nbr.shape[0])
    return dg, rec


@contextmanager
def layer_spans(spans: dict, labels=LABELS):
    """Time and label the program's layers (``labels``) for the block."""
    import importlib

    from torch.profiler import record_function

    saved = []

    def wrap(fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(label):
                out = fn(*args, **kwargs)
            spans.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        return timed

    for mod_name, attr, label in labels:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr), label))
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def counters() -> dict:
    from repro_torch.exec.plan import PLAN_NAMES
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import get_registry
    from repro_torch.search.batched import LOOP_STATS

    routes = get_registry().counter("repro_planner_routes_total")
    return {"loop_iterations": LOOP_STATS["iterations"], "loop_syncs": LOOP_STATS["syncs"],
            **{f"launches.{k}": v for k, v in ops.LAUNCHES.items()},
            **{f"plan.{name}": routes.value(plan=name) for name in PLAN_NAMES.values()}}


def send(cell, dg, qs: dict, i: int, device) -> tuple:
    """The i-th batch through the program's planned query path: (ids, d)."""
    from repro_torch.exec import executor

    rows = traffic.batch_rows(cell.traffic, i)
    search = cell.config["search"]
    return executor.execute_batch(dg, qs["q"][rows], qs["s_q"][rows], qs["t_q"][rows],
                                  k=search["k"], beam=search["beam"], plan=search["plan"],
                                  device=device)


def warm_up(cell, dg, qs: dict, device) -> None:
    """Two batches: every batch has the same shapes, and the second finds
    every kernel loaded."""
    for b in range(min(2, cell.traffic["distinct_batches"])):
        send(cell, dg, qs, b, device)


def run_window(cell, dg, qs: dict, seconds: float, trace: bool, device, *, send=send,
               agree=bool, labels=LABELS) -> dict:
    """The closed loop: returns each batch's answers and latency, the
    window's length, counter deltas and, traced, spans and the trace.
    ``send(cell, dg, qs, i, device)`` sends batch i; ``agree(go)`` turns
    this process's decision whether another batch follows into the one
    every process of the run takes (``sharded.py``: rank 0's)."""
    mix = cell.traffic
    outs, lat, ends, spans = [], [], [], {}
    before = counters()

    def one(i):
        t0 = time.perf_counter()
        outs.append(send(cell, dg, qs, i, device))
        ends.append(time.perf_counter())
        lat.append(ends[-1] - t0)

    traced = mix["trace_batches"] if trace else math.inf
    with layer_spans(spans, labels) if trace else nullcontext():
        with Tracer(label for *_, label in labels) if trace else nullcontext() as tr:
            start = time.perf_counter()
            i = 0
            while agree(i == 0 or (i < traced and time.perf_counter() - start < seconds)):
                one(i)
                i += 1
        while agree(time.perf_counter() - start < seconds):
            one(i)
            i += 1
        end = time.perf_counter()
    after = counters()
    res = {"outs": outs, "lat": lat, "ends_s": [e - start for e in ends],
           "window_s": end - start, "sent": i, "spans": spans,
           "counters": {k: after[k] - before[k] for k in after}}
    if tr is not None:
        t0 = time.perf_counter()
        res["trace"] = tr.summary(min(i, mix["trace_batches"]))
        res["trace"]["summary_s"] = time.perf_counter() - t0
    return res


def qps_by_span(ends_s: list, batch: int, span: float) -> list:
    """Queries a second in each whole ``span`` seconds of the window, by the
    batches that ended in it: how the rate moves within one run."""
    which = (np.asarray(ends_s, dtype=float) // span).astype(int)
    n = int(which.max(initial=0))
    return [float(c * batch / span) for c in np.bincount(which, minlength=n + 1)[:n]]


def sampled(cell, qs: dict, win: dict, seed: int) -> dict:
    """The judged sample of the window's answers (``traffic.sample``): the
    queries and what the program answered them."""
    mix = cell.traffic
    bi, row = traffic.sample(mix, win["sent"], seed)
    qrow = (bi % mix["distinct_batches"]) * mix["batch"] + row
    return {"q": qs["q"][qrow], "s_q": qs["s_q"][qrow], "t_q": qs["t_q"][qrow],
            "ids": np.stack([win["outs"][b][0][r] for b, r in zip(bi, row)]),
            "dist": np.stack([win["outs"][b][1][r] for b, r in zip(bi, row)])}


def judge_window(cell, qs: dict, win: dict, seed: int, device) -> dict:
    """The reference's readings of a sample of the window's answers."""
    from udg_bench.reference import Corpus

    smp = sampled(cell, qs, win, seed)
    vecs, s, t = corpus(cell.config)
    ref = Corpus(vecs, s, t, cell.config["relation"], device)
    return check.judge_answers(ref, smp["q"], smp["s_q"], smp["t_q"], smp["ids"], smp["dist"],
                               cell.config["search"]["k"])


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             cache_dir: Path = index_cache.CACHE_DIR, t_start: float = T_START):
    """One run of ``cell``; returns the result object, or ``None`` after
    reporting why on standard error when the run may print none."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    import_program()
    from repro_torch.kernels import _build

    if on_card:
        emit({"card": card_info()})
        emit({"kernels": {"nvcc_s": _build.build_all(KERNELS)}})
        load_kernels()
    setup = {"program_s": time.perf_counter() - t_start}
    dg, index = load_index(cell, device, cache_dir)
    emit({"index": index})
    setup["restore_s"] = index["restore_s"]
    t0 = time.perf_counter()
    data = cell.config["data"]
    s, t = datagen.make_intervals(cell.config["n"], T=data["T"], seed=data["data_seed"])
    qs = traffic.make_traffic(cell.traffic, cell.config, s, t, seed, device)
    setup["traffic_s"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm_up(cell, dg, qs, device)
    setup["warmup_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    emit({"setup": {"setup_s": setup_s, **setup}})
    clocks = {"before": smi(SMI_CLOCKS)} if on_card else {}
    win = run_window(cell, dg, qs, seconds, trace, device)
    if on_card:
        clocks["after"] = smi(SMI_CLOCKS)
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    c = win["counters"]
    batches = len(win["lat"])
    emit({"window": {
        "batches": batches, "queries": batches * cell.traffic["batch"], "window_s": win["window_s"],
        "plan_mix": {k[5:]: v for k, v in c.items() if k.startswith("plan.")},
        "launches_a_batch": {k[9:]: v / batches for k, v in c.items() if k.startswith("launches.")},
        "loop_iterations_a_batch": c["loop_iterations"] / batches,
        "batch_ms": {"min": min(win["lat"]) * 1e3, "median": float(np.median(win["lat"])) * 1e3,
                     "max": max(win["lat"]) * 1e3},
        "qps_by_10s": qps_by_span(win["ends_s"], cell.traffic["batch"], 10.0),
        "clocks": clocks, "memory_peak_bytes": peak}})
    if win.get("trace"):
        emit({"trace": {k: v for k, v in win["trace"].items()
                        if k not in ("device_ops", "idle_gaps")}})
    bad = forbidden_modules()
    if bad:
        print(f"udg_bench: loaded modules {bad} in the measuring process", file=sys.stderr)
        return None
    del dg
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    read = judge_window(cell, qs, win, seed, device)
    correct, checks = check.judge(read, cell.limits)
    emit({"reference": {**read, "seconds": time.perf_counter() - t0}})
    ctx = {"setup_s": setup_s, "setup": setup, "batch": cell.traffic["batch"],
           "latencies_s": win["lat"], "window_s": win["window_s"], "spans": win["spans"],
           "counters": c, "batches": batches, "recall": read["recall"],
           "trace": win.get("trace")}
    entries = cell.per_layer if trace else cell.end_to_end
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": batches * cell.traffic["batch"], "failed": 0,
              "metrics": spec.read_metrics(entries, ctx, cell.root), "device": device_rec}
    if trace and win.get("trace"):
        tr = win["trace"]
        device_rec["busy_s"] = tr["busy_s"]
        device_rec["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"udg_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if "serve" in cell.config:
        from udg_bench import sharded

        result = sharded.run_cell(cell, args.seed, args.seconds, bool(args.trace))
    else:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        side = "at most" if c["held"] == "max" else "at least"
        print(f"check {name}: {c['value']} (limit: {side} {c['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
