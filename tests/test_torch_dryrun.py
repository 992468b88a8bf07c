"""The port's dry-run tools (``repro_torch.launch.dryrun``, ``roofline``,
``hlo``, ``report``, ``inspect_cell``).

* the twin of ``tests/test_distributed.py::test_dryrun_single_cell_subprocess``:
  ``python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
  decode_32k --mesh single`` (in a subprocess: it sets up a fake process
  group of 256 ranks) writes an ``ok`` record whose bottleneck is one of the
  three, with H100 roofline terms; it and a moonshot (MoE) cell carry
  ``n_params``, ``n_active_params``, ``tokens_per_step`` and
  ``model_flops_total`` equal to the numbers computed from the JAX
  package's ``init_params_shapes``; ``report`` tabulates the records and
  ``inspect_cell`` prints its breakdown;
* a chip counts only its share of the ``model`` axis' work: llama3.2-1b's
  ``train_4k`` FLOPs a chip times the chips lie between 1.0 and 1.6 x
  ``model_flops_total`` (attention and the "dots" recompute above it), and
  ``decode_32k``'s within 10 % of 8.66e11 (2 N and the attention over the
  32k cache, a token); the Mamba blocks split too: falcon-mamba-7b's and
  zamba2-2.7b's ``decode_32k`` FLOPs over the chips are the one-process
  decode step's (counted on ``meta``) plus only Mamba2's B and C columns,
  which every rank of the model group computes;
* the udg-serve record is ``ok`` for f32 and int8 (int8 moves fewer bytes),
  and its terms are the kernel table's bound model (``kernels/bounds.py``)
  at its upper end, at the FP32 and compare rates;
* ``hlo.collective_bytes`` gives the reference's dict shape from
  ``distributed.comm``'s counts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES, get_config as ref_get_config
from repro.launch.dryrun import _active_params as ref_active_params
from repro.models import init_params_shapes as ref_init_params_shapes
from repro_torch.configs import SHAPES as PORT_SHAPES, get_config
from repro_torch.distributed.sharding import mesh_sizes
from repro_torch.launch import dryrun, hlo, report, roofline
from repro_torch.models import decode_step, init_decode_state, init_params_shapes

REPO = Path(__file__).resolve().parents[1]
CELLS = (("llama3.2-1b", "decode_32k"), ("moonshot-v1-16b-a3b", "decode_32k"),
         ("llama3.2-1b", "train_4k"), ("falcon-mamba-7b", "decode_32k"),
         ("zamba2-2.7b", "decode_32k"))
SCRIPT = """
import sys
from repro_torch.launch import dryrun, inspect_cell
out = sys.argv[1]
for arch, shape in {cells}:
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single", "--out", out])
inspect_cell.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--top", "3"])
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", SCRIPT.format(cells=CELLS), str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = {(a, s): json.loads((out / f"{a}.{s}.pod16x16.json").read_text()) for a, s in CELLS}
    return out, recs, res.stdout


def test_dryrun_single_cell_subprocess(records):
    _, recs, stdout = records
    r = recs[("llama3.2-1b", "decode_32k")]
    assert r["ok"], r.get("error")
    assert "[OK] llama3.2-1b decode_32k pod16x16" in stdout
    rf = r["roofline"]
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert r["chips"] == 256 and r["kind"] == "decode" and r["probe_corrected"]
    assert r["cost"] == r["cost_raw_scanned"] and r["cost"]["flops"] > 0
    # H100 SXM terms
    assert rf["memory_s"] == pytest.approx(rf["hbm_bytes_per_chip"] / 3.35e12)
    assert rf["compute_s"] == pytest.approx(rf["flops_per_chip"] / 989e12)
    assert rf["collective_s"] == pytest.approx(rf["collective_bytes_per_chip"] / 450e9)
    assert r["collectives"]["all-gather"] > 0 and r["collectives"]["total"] > 0
    assert r["memory"]["temp_bytes"] > 0 and r["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=[a for a, _ in CELLS])
def test_counts_equal_the_references(records, cell):
    _, recs, _ = records
    arch, shape = cell
    r = recs[cell]
    assert r["ok"], r.get("error")
    cfg = ref_get_config(arch)
    n = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(ref_init_params_shapes(cfg)))
    active = ref_active_params(cfg, n)
    sh = SHAPES[shape]
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
    assert (r["n_params"], r["n_active_params"], r["tokens_per_step"]) == (n, active, tokens)
    assert r["roofline"]["model_flops_total"] == (6.0 if sh.kind == "train" else 2.0) * active * tokens
    if cfg.is_moe:
        assert active < n


def test_each_chip_counts_its_share_of_the_model_axis(records):
    _, recs, _ = records
    train, decode = recs[("llama3.2-1b", "train_4k")], recs[("llama3.2-1b", "decode_32k")]
    assert train["ok"] and decode["ok"], (train.get("error"), decode.get("error"))
    rf = train["roofline"]
    assert 1.0 <= rf["flops_per_chip"] * train["chips"] / rf["model_flops_total"] <= 1.6
    assert decode["roofline"]["flops_per_chip"] * decode["chips"] == pytest.approx(8.66e11, rel=0.1)


def one_process_decode_flops(arch: str, shape: str) -> float:
    """The FLOPs of the one-process ``decode_step`` of the cell (no model
    group), counted on ``meta`` tensors."""
    cfg, sh = get_config(arch), PORT_SHAPES[shape]
    cache = init_decode_state(cfg, sh.global_batch, sh.seq_len, device="meta")
    tokens = torch.empty((sh.global_batch, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((sh.global_batch,), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        decode_step(init_params_shapes(cfg), cfg, cache, tokens, pos)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_each_chip_counts_its_share_of_the_mamba_blocks(records, arch):
    """A decode step's FLOPs over the chips are the one-process step's plus
    Mamba2's B and C columns of ``in_proj``, which all 16 ranks of a model
    group compute for their rows: falcon-mamba-7b's useful share is 1 (it
    was 1/15.4 with the blocks repeated on every rank), and
    ``flops_per_chip * chips / model_flops_total`` is at most 2.0 for it.
    zamba2-2.7b's one-process step is itself 2.10 x ``model_flops_total``
    (its shared attention block runs 9 times on one set of weights, and
    attends over the 32k cache), and the B and C columns add 0.11 (it was
    16.0)."""
    _, recs, _ = records
    r = recs[(arch, "decode_32k")]
    assert r["ok"], r.get("error")
    cfg, sh = get_config(arch), PORT_SHAPES["decode_32k"]
    model = mesh_sizes(dryrun.make_production_mesh(multi_pod=False))["model"]
    n_mamba2 = cfg.num_layers - cfg.num_layers // cfg.hybrid_every if cfg.is_hybrid else 0
    bc = (model - 1) * 2 * cfg.d_model * 2 * cfg.ssm_state * n_mamba2 * sh.global_batch
    rf = r["roofline"]
    got = rf["flops_per_chip"] * r["chips"]
    assert got == pytest.approx(one_process_decode_flops(arch, "decode_32k") + bc, rel=1e-3)
    if not cfg.is_hybrid:
        assert got / rf["model_flops_total"] <= 2.0


def test_report_and_inspect_cell(records):
    out, recs, stdout = records
    loaded = report.baseline(report.load(str(out)))
    assert len(loaded) == len(CELLS)
    assert report.summary(loaded) == f"{len(CELLS)} compiled OK, 0 documented skips, 0 failures"
    table = report.roofline_table(loaded, "pod16x16")
    assert all(f"| {a} | {s} |" in table for a, s in CELLS)
    assert "| llama3.2-1b | decode_32k | OK |" in report.dryrun_table(loaded, "pod16x16")
    assert "collective bytes by kind" in stdout and "operators by bytes" in stdout


@pytest.mark.parametrize("vec_dtype", ["f32", "int8"])
def test_udg_serving_cell(vec_dtype):
    rec = dryrun.run_udg_serving_cell(False, vec_dtype=vec_dtype)
    assert rec["ok"], rec.get("error")
    assert rec["tag"] == f"all_gather.{vec_dtype}.b64.E96" and rec["expected_iters"] == 64
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert rec["queries_per_device"] == 4096 // 16
    assert rec["collectives"] == {"all-gather": 256 * 10 * 8, "all-gather_count": 2,
                                  "total": 256 * 10 * 8}
    f32 = dryrun.run_udg_serving_cell(False, vec_dtype="f32")
    if vec_dtype == "int8":
        assert rec["cost"]["bytes accessed"] < f32["cost"]["bytes accessed"]
    tour = dryrun.run_udg_serving_cell(True, vec_dtype=vec_dtype, merge="tournament")
    assert tour["ok"] and tour["collectives"]["collective-permute_count"] == 8


@pytest.mark.parametrize("vec_dtype,elt", [("f32", 4), ("bf16", 2), ("int8", 1)])
def test_udg_serving_cell_charges_the_kernel_tables_bounds(vec_dtype, elt):
    """B1's and B2's terms are the kernel table's bound model at its upper
    end (every slot live and kept, nothing shared), B1's operations at the
    FP32 rate and B2's compares at the compare rate."""
    from repro_torch.kernels import bounds

    rec = dryrun.run_udg_serving_cell(False, vec_dtype=vec_dtype)
    B, E, L, d = 256, 96, 64, 768
    row = d * elt + 4 + (4 if vec_dtype == "int8" else 0)
    it = rec["per_iter"]
    assert it["b1_bytes"] == B * E * (8 + 8 + 4 + row) + B * (d * 4 + 12)
    assert it["b1_ops"] == B * E * 2 * d
    assert it["b2_bytes"] == B * (18 * L + 17 * E)
    assert it["b2_ops"] == B * (L + E) * 8                     # ceil(log2(160)) = 8
    terms = rec["roofline"]
    want_compute = L * (it["b1_ops"] / 67e12 + it["b2_ops"] / 33.5e12)
    assert terms["compute_s"] == pytest.approx(want_compute, rel=1e-12)
    assert terms["memory_s"] == pytest.approx(L * (it["b1_bytes"] + it["b2_bytes"]) / 3.35e12,
                                              rel=1e-12)
    assert it["b1_bound_ms"] == bounds.bound(it["b1_bytes"], it["b1_ops"], 67e12)[0]
    assert it["b2_bound_ms"] == bounds.bound(it["b2_bytes"], it["b2_ops"], 33.5e12)[0]


def test_collective_bytes_has_the_references_shape():
    counts = {"all-gather": {"bytes": 100, "calls": 2}, "all-reduce": {"bytes": 40, "calls": 1},
              "all-to-all": {"bytes": 0, "calls": 0}}
    assert hlo.collective_bytes(counts) == {"all-gather": 100, "all-gather_count": 2,
                                            "all-reduce": 40, "all-reduce_count": 1, "total": 140}
    assert hlo.collective_bytes({}) == {"total": 0}
    terms = roofline.derive(arch="a", shape="s", mesh="m", chips=2, cost={"flops": 989e12},
                            coll={"total": 0}, kind="train", n_params=10, n_active_params=0,
                            tokens=3)
    assert terms.compute_s == pytest.approx(1.0) and terms.bottleneck == "compute"
    assert terms.model_flops_total == 180.0
