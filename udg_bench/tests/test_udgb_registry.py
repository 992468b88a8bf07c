"""Cells, configurations, mixes and metrics are found by name, and a new one
is picked up from new files and entries alone."""
import json

import pytest

from udg_bench import check, index_cache, run, spec
from udg_bench.conftest import ROOT, make_tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.config_file.parent == ROOT / "udg_bench" / "configs"
    assert spec.CONFIG_KEYS <= set(cell.config) <= spec.CONFIG_KEYS | set(spec.OPTIONAL_GROUPS)
    assert set(cell.limits) - {"set_from"} == set(check.NUMBERS)
    assert cell.traffic["batch"] > 0 and cell.traffic["selectivities"]
    assert {"qps", "p95_ms", "recall_at_10", "setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_every_file_is_named():
    """Each configuration, mix and reader under udg_bench is one that
    BENCHMARK.json names: no file is left over."""
    configs = {c["file"] for c in BENCH["configs"]}
    assert {f"udg_bench/configs/{p.name}" for p in (ROOT / "udg_bench/configs").glob("*.json")} == configs
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (ROOT / "udg_bench/traffic").glob("*.json")} == mixes
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert {p.stem for p in (ROOT / "udg_bench/metrics").glob("*.py")} == metrics
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (ROOT / "udg_bench/limits").glob("*.json")} == cells


def _config():
    return json.loads((ROOT / "udg_bench/configs/udg768-contain.json").read_text())


@pytest.mark.parametrize("change", [
    lambda c: c.update(limits={"dist_err": 1.0}),             # an unknown key
    lambda c: c["search"].update(planner="default"),          # an unknown key in a group
    lambda c: c["build"].update(constructor="batched"),
    lambda c: c["data"].pop("data_seed"),                     # a missing key
    lambda c: c.pop("dtype"),
    lambda c: c.update(dtype="bfloat16"),                     # a value the harness cannot make
    lambda c: c["data"].update(vectors="sift"),
    lambda c: c["data"].update(intervals="zipf"),
    lambda c: c["search"].update(plan="segmented"),
    lambda c: c.update(relation="before"),
])
def test_a_config_with_a_setting_that_would_have_no_effect_is_refused(change):
    cfg = _config()
    spec.validate_config(cfg)
    change(cfg)
    with pytest.raises(ValueError):
        spec.validate_config(cfg)


def test_limits_name_every_compared_number():
    limits = json.loads((ROOT / "udg_bench/limits/udg768-contain-bulk.json").read_text())
    spec.validate_limits(limits, "udg768-contain-bulk")
    with pytest.raises(ValueError):
        spec.validate_limits({k: v for k, v in limits.items() if k != "recall"}, "x")
    with pytest.raises(ValueError):
        spec.validate_limits(dict(limits, recal=0.5), "x")


def test_the_configured_plan_is_the_plan_run(tmp_path):
    """``search.plan`` reaches ``execute_batch``: a configuration that
    forces the graph search plans no row GRAPH_WIDE."""
    root = make_tiny_root(tmp_path / "root")
    cfg_file = root / "udg_bench" / "configs" / "tiny.json"
    cfg = json.loads(cfg_file.read_text())
    cfg["search"]["plan"] = "graph"
    cfg_file.write_text(json.dumps(cfg))
    cell = spec.load_cell("tiny-cell", root)
    from repro_torch.exec import executor

    seen = []
    inner = executor.execute_batch

    def spy(*a, **kw):
        seen.append(kw["plan"])
        return inner(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(executor, "execute_batch", spy)
        res = run.run_cell(cell, 9, 0.2, False, device="cpu", cache_dir=tmp_path / "cache")
    assert res["checks"]["bad_slots"]["value"] == 0
    assert seen and set(seen) == {"graph"}


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a mix and a metric added as files, with entries in
    BENCHMARK.json, run with no edit to any harness file."""
    root = make_tiny_root(tmp_path / "root")
    bench = root / "udg_bench"
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-overlap", relation="overlap")
    (bench / "configs" / "tiny-overlap.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    mix.update(selectivities=[0.05, 0.2])
    (bench / "traffic" / "tiny-two.json").write_text(json.dumps(mix))
    (bench / "metrics" / "batches_sent.py").write_text(
        "def read(ctx):\n    return float(ctx['batches'])\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="tiny-overlap",
                             file="udg_bench/configs/tiny-overlap.json"))
    b["workloads"].append(dict(b["workloads"][0], name="tiny-new", config="tiny-overlap",
                               traffic="tiny-two"))
    b["end_to_end"].append({"name": "batches_sent", "unit": "batches", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (bench / "limits" / "tiny-new.json").write_text((bench / "limits" / "tiny-cell.json").read_text())
    cell = spec.load_cell("tiny-new", root)
    assert cell.config["relation"] == "overlap" and cell.traffic["selectivities"] == [0.05, 0.2]
    res = run.run_cell(cell, 7, 0.5, False, device="cpu", cache_dir=tmp_path / "cache")
    assert res["correct"], res["checks"]
    assert res["metrics"]["batches_sent"]["value"] >= 1
    assert {"qps", "p95_ms", "recall_at_10", "setup_s"} <= set(res["metrics"])
    # the index was cached under the configuration's name and restored
    assert [p.name.split("-")[0:2] for p in (tmp_path / "cache").glob("*.npz")] == [["tiny", "overlap"]]


def test_cache_key_follows_config_and_program(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "a.py").write_text("x = 1\n")
    cfg = tmp_path / "c.json"
    cfg.write_text("{}")
    k0 = index_cache.digest(cfg, pkg)
    (pkg / "a.py").write_text("x = 2\n")
    k1 = index_cache.digest(cfg, pkg)
    cfg.write_text('{"n": 1}')
    k2 = index_cache.digest(cfg, pkg)
    assert len({k0, k1, k2}) == 3
    (pkg / "__pycache__").mkdir()
    (pkg / "__pycache__" / "a.pyc").write_bytes(b"\0")
    assert index_cache.digest(cfg, pkg) == k2
