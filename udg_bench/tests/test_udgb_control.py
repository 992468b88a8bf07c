"""The control: the reference computed in TF32, put in the program's place,
comes out not correct under each cell's limits; the reference in
its own precision comes out correct.

On the CPU at a cut corpus (4096 rows, the configuration's own width); with
``-m card`` on the card at the cell's own size, three seeds a cell."""
import json

import pytest

from udg_bench import calibrate, check, datagen, spec, traffic
from udg_bench.conftest import ROOT
from udg_bench.reference import Corpus

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def control_readings(cell, seed, device, n=None, batch=None, sample=None):
    cfg = dict(cell.config, n=n or cell.config["n"])
    mix = dict(cell.traffic, distinct_batches=1, batch=batch or cell.traffic["batch"])
    data = cfg["data"]
    vecs = datagen.make_vectors(cfg["n"], cfg["dim"], clusters=data["clusters"],
                                spread=data["spread"], seed=data["data_seed"])
    s, t = datagen.make_intervals(cfg["n"], T=data["T"], seed=data["data_seed"])
    qs = traffic.make_traffic(mix, cfg, s, t, seed, device)
    pick = slice(0, sample or mix["recall_sample"])
    q, sq, tq = qs["q"][pick], qs["s_q"][pick], qs["t_q"][pick]
    k = cfg["search"]["k"]
    exact = Corpus(vecs, s, t, cfg["relation"], device)
    out = {}
    for side in ("exact", "tf32"):
        ids, dist, _ = Corpus(vecs, s, t, cfg["relation"], device, side).topk(q, sq, tq, k)
        out[side] = check.judge_answers(exact, q, sq, tq, ids, dist, k)
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_a_cut_corpus(workload):
    cell = spec.load_cell(workload)
    read = control_readings(cell, 2 ** 31 + 17, "cpu", n=4096, batch=512, sample=256)
    assert check.judge(read["exact"], cell.limits)[0]
    ok, checks = check.judge(read["tf32"], cell.limits)
    assert not ok, checks
    assert read["tf32"]["dist_err"] > 3 * cell.limits["dist_err"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
def test_control_fails_at_the_cells_size(cuda, workload, seed):
    cell = spec.load_cell(workload)
    read = control_readings(cell, seed, cuda)
    assert check.judge(read["exact"], cell.limits)[0]
    assert not check.judge(read["tf32"], cell.limits)[0], read["tf32"]


def test_calibrate_reads_program_control_and_fault(tiny_root, tiny_cache, capsys):
    """calibrate.py's readings on the tiny cell: the program within every
    limit, the control past dist_err's, the loop cut to one block under the
    recall floor."""
    cell = spec.load_cell("tiny-cell", tiny_root)
    reads = calibrate.calibrate(cell, [2 ** 31 + 41, 2 ** 31 + 42], {2 ** 31 + 41},
                                [("one_block", 2 ** 31 + 43)], 0.2, device="cpu",
                                cache_dir=tiny_cache)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [next(iter(x)) for x in lines] == ["index", "program", "control", "program", "fault",
                                              "readings"]
    assert check.judge(reads["program"], cell.limits)[0]
    assert reads["control"]["dist_err"] > cell.limits["dist_err"]
    assert reads["one_block"]["recall"] < cell.limits["recall"]
    assert lines[-1]["readings"] == reads
