"""Sharded cells (``sharded.py``) on the CPU: ranks over gloo at a tiny size,
held to the program's single-process mesh; a sharded configuration's
refusals; faults planted in every rank; a lost rank; the harness's copy of
the program's shard stacking."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from udg_bench import check, devtrace, faults, index_cache, sharded, spec, traffic
from udg_bench.conftest import ROOT, add_tiny_sharded, make_tiny_root

SEED = 2 ** 31 + 21


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("sharded"))
    for world in (2, 4):
        add_tiny_sharded(root, world)
    return root


@pytest.fixture(scope="module")
def shard_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("shard-cache")


def one_window(cell, cache, *, seed=SEED, seconds=1.5, fault=None):
    """Rank 0's window and every rank's record of it."""
    got = {}
    window = {"seed": seed, "seconds": seconds, "trace": False, "fault": fault, "keep": True}
    sharded.run_ranks(cell, [window], lambda w, win, qs, records, setup: got.update(
        win=win, qs=qs, records=records), device="cpu", cache_dir=cache,
        t_start=time.perf_counter())
    return got


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_answers_as_the_single_process_mesh(shard_root, shard_cache, world):
    """Each rank's view of each batch equals, bit for bit, what the program's
    serve_batch answers in one process on a host mesh over the same shards."""
    from repro_torch.distributed.mesh import make_host_mesh
    from repro_torch.serve.distributed import serve_batch

    cell = spec.load_cell(f"tiny-sharded{world}", shard_root)
    got = one_window(cell, shard_cache)
    records = got["records"]
    assert [r["rank"] for r in records] == list(range(world))
    assert {r["backend"] for r in records} == {"gloo"}
    assert not any(r["forbidden"] for r in records)
    idx = sharded.restore_index(sharded.shard_files(cell, world, shard_cache))
    mesh = make_host_mesh(world, device="cpu")
    search = cell.config["search"]
    for b in range(len(records[0]["answers"])):
        rows = traffic.batch_rows(cell.traffic, b)
        ids, d = serve_batch(idx, mesh, got["qs"]["q"][rows], got["qs"]["s_q"][rows],
                             got["qs"]["t_q"][rows], k=search["k"], beam=search["beam"],
                             merge="all_gather", plan=search["plan"])
        for r in records:
            np.testing.assert_array_equal(r["answers"][b][0], ids)
            np.testing.assert_array_equal(r["answers"][b][1], d)


def test_a_sharded_run_is_correct_and_reports_its_metrics(shard_root, shard_cache):
    cell = spec.load_cell("tiny-sharded2", shard_root)
    res = sharded.run_cell(cell, SEED + 1, 0.5, False, device="cpu", cache_dir=shard_cache)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"qps", "p95_ms", "recall_at_10", "setup_s"}
    assert res["device"]["count"] == 2 and res["attempted"] % cell.traffic["batch"] == 0
    traced = sharded.run_cell(cell, SEED + 2, 0.5, True, device="cpu", cache_dir=shard_cache)
    assert traced["correct"], traced["checks"]
    # on the CPU nothing runs on a device: the host and counter readings
    assert {"shard_plan_ms", "loop_iterations", "loop_syncs", "restore_s"} <= set(traced["metrics"])
    assert not {"collective_ms", "scorer_ms", "idle_share"} & set(traced["metrics"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert traced["device"]["window_s"] > 0 and traced["device"]["busy_s"] == 0.0


# every fault a sharded cell can have: the loop's state returned unchanged,
# half the batch left out, an answer altered where it is produced, the loop
# cut short, one shard's part left out of the merge, no exchange between cards
IN_EVERY_RANK = ["unchanged_state", "half_batch", "altered_answer", "one_block", "shard_dropped",
                 "exchange_skipped"]


@pytest.mark.parametrize("fault", IN_EVERY_RANK)
def test_a_fault_in_every_rank_makes_the_sharded_run_incorrect(shard_root, shard_cache, fault):
    cell = spec.load_cell("tiny-sharded2", shard_root)
    res = sharded.run_cell(cell, SEED + 3, 0.5, False, device="cpu", cache_dir=shard_cache,
                           fault=fault)
    assert res["correct"] is False, res["checks"]


def test_half_batch_reaches_the_sharded_path():
    """serve.distributed imported planned_exec_core by name: the fault is
    planted there too."""
    from repro_torch.exec import executor
    from repro_torch.serve import distributed

    patch = sharded.Patch()
    try:
        faults.half_batch(patch)
        assert distributed.planned_exec_core is executor.planned_exec_core
        assert distributed.planned_exec_core.__name__ == "half"
    finally:
        patch.undo()
    assert distributed.planned_exec_core.__name__ == "planned_exec_core"


RANK0 = """
import sys, time, pathlib
sys.path[:0] = [{root!r}, {src!r}]
from udg_bench import sharded, spec
cell = spec.load_cell("tiny-sharded2", pathlib.Path({tiny!r}))
sharded.run_cell(cell, 5, 300.0, False, device="cpu", cache_dir=pathlib.Path({cache!r}))
"""


def _children(pid: int) -> list:
    out = subprocess.run(["pgrep", "-P", str(pid), "-f", "sharded.py"], capture_output=True,
                         text=True)
    return [int(p) for p in out.stdout.split()]


def _start_rank0(shard_root, shard_cache):
    code = RANK0.format(root=str(ROOT), src=str(ROOT / "src"), tiny=str(shard_root),
                        cache=str(shard_cache))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    while not _children(proc.pid):
        assert time.monotonic() < deadline and proc.poll() is None, "no rank started"
        time.sleep(0.2)
    time.sleep(10)                  # into the window: the index is cached by the tests above
    return proc


@pytest.mark.parametrize("lost", ["rank 1", "rank 0"])
def test_a_lost_rank_ends_the_run_in_time(shard_root, shard_cache, lost):
    """A rank killed in the middle of a run ends it within seconds, non-zero
    and with no result, and leaves no rank behind."""
    cell = spec.load_cell("tiny-sharded2", shard_root)
    sharded.run_cell(cell, SEED, 0.2, False, device="cpu", cache_dir=shard_cache)   # the cache
    proc = _start_rank0(shard_root, shard_cache)
    child, = _children(proc.pid)
    t0 = time.monotonic()
    os.kill(child if lost == "rank 1" else proc.pid, signal.SIGKILL)
    if lost == "rank 1":
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 3 and "rank 1 ended" in err, err[-2000:]
        assert "correct" not in out
    else:
        proc.communicate(timeout=30)
    while True:             # the other rank notices within a second of the watchdog's poll
        try:
            os.kill(child, 0)
        except ProcessLookupError:
            break
        with open(f"/proc/{child}/stat") as f:
            if f.read().split(") ")[1].startswith("Z"):     # ended, not yet reaped
                break
        assert time.monotonic() - t0 < 10, "a rank outlived the run"
        time.sleep(0.1)
    assert time.monotonic() - t0 < 10


def test_stacked_shard_builds_equal_build_sharded_index(tmp_path):
    """stack_shards over one cached export a shard (rows r, r + S, ...) is the
    program's build_sharded_index: every stacked array and each planner."""
    from repro_torch.exec.estimator import STATE_FIELDS
    from repro_torch.serve.distributed import STACK_FIELDS, build_sharded_index

    from udg_bench import datagen

    n, dim, S = 2048, 16, 2
    vecs = datagen.make_vectors(n, dim, clusters=4, spread=0.35, seed=3)
    s, t = datagen.make_intervals(n, seed=3)
    cfg = {"relation": "containment", "build": {"M": 8, "Z": 32, "K_p": 4}}
    want = build_sharded_index(vecs, s, t, "containment", S, M=8, Z=32, K_p=4, device="cpu")
    paths = []
    for r in range(S):
        arrays, _ = index_cache.build(cfg, vecs[r::S], s[r::S], t[r::S], "cpu")
        paths.append(tmp_path / f"shard{r}.npz")
        index_cache.save(arrays, paths[-1])
    got = sharded.restore_index(paths)
    for name in STACK_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.relation, got.n_local, got.num_shards) == (want.relation, want.n_local, S)
    for a, b in zip(got.planners, want.planners):
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def test_the_sharded_choices_are_the_programs():
    from repro_torch.serve import distributed

    assert spec.MERGES == distributed.MERGES
    with pytest.raises(ValueError):
        distributed.serve_batch(None, None, np.zeros((1, 4), np.float32), [0.0], [1.0],
                                plan="wide")


def _shard_config():
    return json.loads((ROOT / "udg_bench/configs/udg768-contain-shard4.json").read_text())


@pytest.mark.parametrize("change", [
    lambda c: c["serve"].update(merge="ring"),                 # not one of the program's merges
    lambda c: c["search"].update(plan="wide"),                 # a plan serve_batch does not take
    lambda c: c.update(n=262145),                              # the shards do not divide n
    lambda c: c["serve"].update(shards=0),
    lambda c: c["serve"].pop("merge"),                         # a missing key in the group
    lambda c: c["serve"].update(replicas=2),                   # an unknown key in the group
])
def test_a_sharded_config_that_cannot_run_is_refused(change):
    cfg = _shard_config()
    spec.validate_config(cfg)
    change(cfg)
    with pytest.raises(ValueError):
        spec.validate_config(cfg)


@pytest.mark.parametrize("name,chips", [("udg768-sharded4", 2), ("udg768-contain-bulk", 4)])
def test_a_cell_whose_chips_are_not_its_shards_is_refused(name, chips):
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            w["chips"] = chips
    with pytest.raises(ValueError, match="chips"):
        spec.load_cell(name, bench=bench)


def test_collectives_are_read_apart_from_the_other_device_work():
    dev = [(0, 10, "filter_dist_kernel<float>"), (10, 30, "ncclDevKernel_AllGather_RING_LL"),
           (30, 40, "aten::sort")]
    tr = devtrace.summarize(dev, [], (0, 50, devtrace.WINDOW_LABEL), 50e-6, 2)
    assert tr["collective_s"] == pytest.approx(20e-6)
    ctx = {"trace": tr}
    assert spec.reader("collective_ms")(ctx) == pytest.approx(1e3 * 20e-6 / 2)
    assert spec.reader("other_device_ms")(ctx) == pytest.approx(1e3 * 10e-6 / 2)
    assert spec.reader("shard_plan_ms")({"spans": {"shard_plan": [0.002, 0.004]}}) == \
        pytest.approx(3.0)
    assert spec.reader("shard_plan_ms")({"spans": {}}) is None


def test_the_sharded_cell_judges_against_the_whole_corpus():
    """Its limits name every compared number, and its configuration serves
    as many shards as the cell asks chips."""
    cell = spec.load_cell("udg768-sharded4")
    assert cell.chips == cell.config["serve"]["shards"] == 4
    assert cell.config["n"] == 4 * 65536
    assert set(cell.limits) - {"set_from"} == set(check.NUMBERS)
