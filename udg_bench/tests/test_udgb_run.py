"""A whole run on the CPU at a tiny size: the result line, the modules a run
loads, the traced run, and faults planted underneath the timed path."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from udg_bench import devtrace, faults, run, spec
from udg_bench.conftest import ROOT

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def tiny(tiny_root, tiny_cache):
    return lambda **kw: run.run_cell(spec.load_cell("tiny-cell", tiny_root), kw.pop("seed", 2 ** 31 + 3),
                                     kw.pop("seconds", 0.5), kw.pop("trace", False), device="cpu",
                                     cache_dir=tiny_cache, **kw)


def test_result_line_has_the_contract_keys(tiny):
    res = tiny()
    assert list(res) == RESULT_KEYS + ["checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] % 128 == 0
    assert set(res["metrics"]) == {"qps", "p95_ms", "recall_at_10", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(res["checks"]) == ["dist_err", "bad_slots", "recall"]
    assert all(set(c) == {"value", "limit", "held"} for c in res["checks"].values())
    json.dumps(res)


def test_traced_run_reports_the_per_layer_metrics(tiny):
    res = tiny(trace=True)
    assert list(res) == RESULT_KEYS + ["breakdown", "checks"]
    # on the CPU nothing runs on a device: only host and counter readings
    assert {"planner_ms", "loop_iterations", "loop_syncs", "restore_s"} <= set(res["metrics"])
    assert not {"scorer_ms", "merge_ms", "idle_share", "other_device_ms"} & set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_run_loads_no_jax_module():
    """A fresh interpreter runs a tiny cell through run_cell: no loaded
    module's top-level name is jax, jaxlib, flax or repro (repro_torch is
    not repro: names are compared whole)."""
    code = (
        "import sys, json, tempfile, pathlib\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from udg_bench.conftest import make_tiny_root\n"
        "from udg_bench import run, spec\n"
        "d = pathlib.Path(tempfile.mkdtemp())\n"
        "root = make_tiny_root(d / 'root')\n"
        "res = run.run_cell(spec.load_cell('tiny-cell', root), 5, 0.2, False, device='cpu',"
        " cache_dir=d / 'cache')\n"
        "print(json.dumps({'correct': res['correct'], 'found': run.forbidden_modules(),"
        " 'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] and last["found"] == []
    assert "repro_torch" in last["tops"] and "repro" not in last["tops"]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "repro"]


def test_main_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "udg768-contain-bulk", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_run_needs_the_program_beside_it(tmp_path):
    """In a directory that holds only BENCHMARK.json and udg_bench, the
    command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "udg_bench", tmp_path / "udg_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache", "tests"))
    out = subprocess.run([sys.executable, "udg_bench/run.py", "--workload", "udg768-contain-bulk",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_percentile_and_rate_readers():
    ctx = {"latencies_s": [0.3, 0.1, 0.2, 0.5, 0.4] * 4, "batch": 1000, "batches": 20,
           "window_s": 8.0}
    assert spec.reader("qps")(ctx) == 20 * 1000 / 8.0
    # 20 batches of 1000: rank ceil(0.95 * 20000) = 19000 falls in the 19th batch
    assert spec.reader("p95_ms")(ctx) == pytest.approx(500.0)
    ctx["latencies_s"] = list(np.arange(1, 101) / 1000)
    ctx["batches"] = 100
    assert spec.reader("p95_ms")(ctx) == pytest.approx(95.0)


def test_trace_summary_unions_device_time_and_names_gaps():
    dev = [(0, 10, "filter_dist_kernel<float>"), (5, 20, "beam_merge_kernel"),
           (40, 50, "filter_dist_kernel<float>"), (50, 60, "aten::sort")]
    host = [(0, 100, "search_core"), (20, 40, "planner"), (22, 26, "aten::nonzero")]
    tr = devtrace.summarize(dev, host, (0, 100, devtrace.WINDOW_LABEL), 100e-6, 2)
    assert tr["busy_s"] == pytest.approx(40e-6)
    assert tr["device_s"] == pytest.approx(45e-6)
    assert tr["scorer_s"] == pytest.approx(20e-6) and tr["merge_s"] == pytest.approx(15e-6)
    assert dict(tr["idle_gaps"]) == pytest.approx({"planner": 20e-6, "search_core": 40e-6})
    assert tr["device_ops"][0] == ["filter_dist_kernel<float>", pytest.approx(20e-6)]
    ctx = {"trace": tr}
    assert spec.reader("idle_share")(ctx) == pytest.approx(60.0)
    assert spec.reader("other_device_ms")(ctx) == pytest.approx(1e3 * 10e-6 / 2)


# --- faults planted underneath the timed path: correct has to come out false


# graph_only and half_candidates are read on the card at each cell's size
# (calibrate.py --faults): on the tiny cell the plain graph search and half
# the candidates still find nearly every answer (recall 0.98-0.995, as sound
# runs read), so no floor could tell them apart here.
ON_THE_CPU = ["unchanged_state", "half_batch", "altered_answer", "one_block"]


@pytest.mark.parametrize("fault", ON_THE_CPU)
def test_a_fault_underneath_makes_the_run_incorrect(tiny, monkeypatch, fault):
    faults.FAULTS[fault](monkeypatch)
    res = tiny(seed=11)
    assert res["correct"] is False, res["checks"]
