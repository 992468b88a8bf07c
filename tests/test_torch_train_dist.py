"""The port's distributed training (``repro_torch.distributed``,
``repro_torch.train.dp_trainer``, ``launch/train.py`` under torchrun) on
gloo ranks, against the JAX package and the port's one-process step.

``torch_train_dist_worker.py`` spawns 4 gloo ranks (a file store) and runs
every part in one process group; ``torch_train_dist_ref.py`` runs the
reference's side on eight host devices in two subprocesses (``REF_PARTS``:
its GSPMD compiles run one a process), at the same time.
Held:

* ``compressed_psum`` on 4 ranks against the reference's under
  ``shard_map`` on 4 devices, two rounds: residuals within 1e-6, means
  within one quantum (``scale / n``), every rank the same means;
* ``make_dp_train_step`` at data 4 on the f32 SMOKE llama3.2-1b from the
  reference's parameters: 8 losses within 1e-4 of the reference's, 1e-3
  with compression; the twin of ``test_dp_trainer_and_gradient_compression``
  (bf16: both losses fall, the compressed one tracks);
* the twin of ``test_elastic_restart_downscale`` from 4 ranks to 2: 30
  steps, one restart, the final ``w`` within 1e-6 of the reference
  runner's, ranks 2 and 3 left out;
* ``make_sharded_train_step`` at data 2 x model 2, pod 2 x data 2 and
  data 1 x model 4 (fewer KV heads than ranks on llama, two experts a rank
  on moonshot, 32 Mamba1 channels a rank on falcon-mamba, two Mamba2 heads
  a rank on zamba2) on the f32 SMOKE llama3.2-1b, moonshot, falcon-mamba
  and zamba2, 3 steps from the reference's parameters: loss, grad norm and
  the gathered parameters within 1e-5 of the one-process
  ``make_train_step`` and of the reference's ``make_train_step`` jitted
  with ``in_shardings`` on the same mesh shape (zamba2's later grad norms
  within the spread of the reference's own sharded steps where that is
  wider, ``metrics_atol``, and its parameters at ``ADAM_EDGE``'s bound);
  each rank's slices hold the leaf's bytes over its spec's
  slices; the ranks' FLOPs in one step (``FlopCounterMode``) add up, within
  5 %, to the one-process step's plus the work repeated on purpose (the
  router's product on every rank of the model group, the projection of a
  KV head two ranks share, Mamba2's B and C columns), so a rank computes
  only its share; ``read_policy`` reads a split Mamba block's leaves as
  its layers use them, and a block that does not split whole;
* ``make_sharded_serve_steps`` at data 2 x model 2 and data 1 x model 4:
  the prefill's and four decode steps' logits, gathered, within 1e-5 of
  the one-process ``prefill_step`` / ``decode_step`` and of the
  reference's ``prefill_step`` / ``decode_step`` jitted with
  ``in_shardings`` (``param_specs``, ``cache_specs``) on the same mesh
  shape, from the same parameters;
* zamba2's SSD scan and falcon-mamba's scan, chunked by 8, at data 1 x
  model 4: the sharded prefill's logits and one step's loss and grad norm
  within 1e-5 of the one-process steps and of the reference's sharded
  steps;
* the launcher at 4 ranks (data 2 x model 2) gives the one-process
  launcher's losses within 1e-5 in f32 (bf16 gradients meaned over two
  ranks round differently from one backward over the whole batch), and
  its checkpoint is the one-process layout, within 1e-5;
  ``--production-mesh`` at W != 256 names W;
* ``local_shard`` on a (2, 2, 2) mesh equals ``NamedSharding(...)
  .devices_indices_map`` over eight host devices.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_train_dist_worker as case
from repro import configs as ref_configs
from repro import models as ref_models
from repro_torch import models as tm
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.comm import ModelGroup
from repro_torch.distributed.fsdp import read_policy
from repro_torch.distributed.sharding import P, local_shard, to_placements
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.attention import head_split
from repro_torch.train import adamw
from torch_cases import K  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"


def _ref_f32(arch):
    return dataclasses.replace(ref_configs.get_config(arch, smoke=True), dtype="float32")


@pytest.fixture(scope="module")
def fsdp_init():
    """arch -> the reference's f32 SMOKE parameters (``PRNGKey(0)``), as numpy."""
    return {arch: jax.tree_util.tree_map(
        np.asarray, ref_models.init_params(_ref_f32(arch), jax.random.PRNGKey(0)))
        for arch in case.FSDP_ARCHS}


def _port_model(arch, tree):
    """The port's model holding the reference's parameter tree ``tree``."""
    return tm.params_from_numpy(ModelConfig(**dataclasses.asdict(_ref_f32(arch))), tree,
                                device="cpu")


# the reference script's parts, split over two subprocesses of about equal time
REF_PARTS = (("fsdp",), ("shard_maps", "psum", "dp", "elastic", "serve", "scans"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fsdp_init):
    """(the reference's arrays, each rank's arrays)."""
    work = tmp_path_factory.mktemp("train_dist")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    refs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_train_dist_ref.py"), str(work / f"ref{i}.npz"), *parts],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        cwd=TESTS, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, parts in enumerate(REF_PARTS)]
    try:
        cfg = dataclasses.replace(ref_configs.get_config("llama3.2-1b", smoke=True), dtype="float32")
        params = jax.tree_util.tree_map(np.asarray, ref_models.init_params(cfg, jax.random.PRNGKey(0)))
        model = tm.params_from_numpy(ModelConfig(**dataclasses.asdict(cfg)), params, device="cpu")
        np.savez(work / "init.npz", **{n: t.detach().numpy() for n, t in model.named_parameters()})
        for arch, tree in fsdp_init.items():
            np.savez(work / f"fsdp_init_{arch}.npz",
                     **{n: t.detach().numpy() for n, t in _port_model(arch, tree).named_parameters()})
        res = subprocess.run([sys.executable, str(TESTS / "torch_train_dist_worker.py"), str(work)],
                             env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    finally:
        for ref in refs:
            ref.kill()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-3000:]

    def load(name):
        with np.load(work / name) as z:
            return {k: z[k] for k in z.files}

    ref = {}
    for i in range(len(REF_PARTS)):
        ref.update(load(f"ref{i}.npz"))
    return ref, [load(f"rank{r}.npz") for r in range(case.WORLD)]


# --- compression -----------------------------------------------------------------------


def _scale(g, r):
    return np.float32(np.max(np.abs(g + r))) / np.float32(127.0)


def test_compressed_psum_matches_the_references(runs):
    want, ranks = runs
    grads, resid = case.psum_inputs()
    for rnd in range(2):
        for k in grads:
            r_in = resid[k] if rnd == 0 else want[f"psum/0/{k}/resid"]
            quantum = _scale(grads[k], r_in) / case.WORLD
            means = np.stack([got[f"psum/{rnd}/{k}/mean"] for got in ranks])
            res = np.stack([got[f"psum/{rnd}/{k}/resid"] for got in ranks])
            assert means.dtype == np.float32 and res.dtype == np.float32
            for r in range(1, case.WORLD):
                np.testing.assert_array_equal(means[r], means[0], err_msg=f"{rnd} {k} rank {r}")
            np.testing.assert_allclose(means, want[f"psum/{rnd}/{k}/mean"], rtol=0,
                                       atol=quantum, err_msg=f"round {rnd} {k} mean")
            np.testing.assert_allclose(res, want[f"psum/{rnd}/{k}/resid"], rtol=0, atol=1e-6,
                                       err_msg=f"round {rnd} {k} residual")


# --- the data-parallel trainer -----------------------------------------------------------


@pytest.mark.parametrize("compress,tol", [(False, 1e-4), (True, 1e-3)], ids=["pmean", "int8"])
def test_dp_trainer_matches_the_references(runs, compress, tol):
    want, ranks = runs
    got = ranks[0][f"dp/{int(compress)}"]
    for r in range(1, case.WORLD):
        np.testing.assert_array_equal(ranks[r][f"dp/{int(compress)}"], got)
    np.testing.assert_allclose(got, want[f"dp/{int(compress)}"], rtol=0, atol=tol)


def test_dp_trainer_and_gradient_compression(runs):
    """The twin of the reference's test, on the bf16 SMOKE config."""
    _, ranks = runs
    losses = {c: ranks[0][f"dp_bf16/{int(c)}"] for c in (False, True)}
    for c, ls in losses.items():
        assert np.all(np.isfinite(ls)) and ls[-1] < ls[0], (c, ls)
    diff = abs(losses[True][-1] - losses[False][-1])
    assert diff < 0.15 * abs(losses[False][0] - losses[False][-1]) + 0.05, losses


# --- elastic restarts --------------------------------------------------------------------


def test_elastic_restart_downscale(runs):
    want, ranks = runs
    for r, got in enumerate(ranks):
        steps, restarts, left = got["elastic/steps_restarts_left"]
        assert restarts == 1
        if r < case.WORLD // 2:
            assert steps == 30 and not left
            np.testing.assert_allclose(got["elastic/w"], want["elastic/w"], rtol=0, atol=1e-6)
        else:                                # outside the new mesh: no further step
            assert left and steps == case.FAIL_AT and "elastic/w" not in got


# --- the sharded step ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process(fsdp_init):
    """arch -> (metrics [steps, 2], parameters, the first step's FLOPs) of
    the one-process step, from the reference's parameters."""
    out = {}
    for arch in case.FSDP_ARCHS:
        cfg = case.f32_smoke(arch)
        model = _port_model(arch, fsdp_init[arch])
        opt = adamw(lr=case.FSDP_LR)
        state, step = opt.init(model), tm.make_train_step(cfg, opt)
        metrics = []
        for i, batch in enumerate(case.fsdp_batches(cfg)):
            with FlopCounterMode(display=False) as fc:
                m = step(model, state, batch)[2]
            if i == 0:
                flops = fc.get_total_flops()
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[arch] = (np.array(metrics), {n: p.detach().numpy() for n, p in model.named_parameters()},
                     flops)
    return out


def metrics_atol(ref, arch):
    """The absolute bound on a sharded step's loss and grad norm (beside
    ``rtol`` 1e-5): 1e-5, but for an ``ADAM_EDGE`` arch's grad norms after
    the first step, the spread of the reference's own sharded steps on the
    three layouts where that is wider. zamba2's second grad norm has one
    (1.6e-4): Adam's first step moves every parameter by about its learning
    rate whatever its gradient's size, so float rounding in gradient entries
    near zero moves the parameters, and the next gradient, by more than f32
    rounding; the port's one-process step moves that grad norm by 1.4e-4
    between two scan chunkings of the same values. The spread itself must
    stay under ``ADAM_EDGE_CEILING``, so that a reference whose layouts drift
    apart fails here rather than loosening the bound."""
    atol = np.full((case.FSDP_STEPS, 2), 1e-5)
    if arch in ADAM_EDGE:
        runs = np.stack([ref[f"fsdp/{arch}/{lay}/metrics"] for lay in case.FSDP_LAYOUTS])
        spread = runs.max(axis=0) - runs.min(axis=0)
        assert spread.max() <= ADAM_EDGE_CEILING, spread
        atol[1:, 1] = np.maximum(atol[1:, 1], spread[1:, 1])
    return atol


def assert_metrics_close(got, want, atol, what):
    bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
    assert not bad.any(), f"{what}: {got} against {want}, atol {atol}"


# Archs whose f32 parameters after FSDP_STEPS AdamW steps sit at the edge of
# a 1e-5 bound: Adam moves a parameter by about its learning rate whatever
# its gradient's size, so where a gradient entry lies near zero its float
# rounding moves the parameter by a share of a step. zamba2 SMOKE: the
# reference's own sharded steps leave its unsharded step by up to 1.05e-5,
# and the port's one-process step, with the scan chunked by 8 instead of
# 128 (the same values up to rounding), moves one of its 209944 parameters
# by 1.31e-5.
ADAM_EDGE = ("zamba2-2.7b",)
ADAM_EDGE_CEILING = 3e-4      # the most the reference's layouts may spread (1.6e-4 measured)


def assert_params_close(got, want, arch):
    """Every parameter within 1e-5 (atol and rtol); for an ``ADAM_EDGE``
    arch, all but one in 10^4 of its elements, and those within a quarter
    of one AdamW step (``FSDP_LR / 4``)."""
    diff = {n: np.abs(got[n] - w) for n, w in want.items()}
    bad = {n: d > 1e-5 + 1e-5 * np.abs(want[n]) for n, d in diff.items()}
    n_bad = sum(int(b.sum()) for b in bad.values())
    worst = max((float(diff[n][b].max()), n) for n, b in bad.items() if b.any()) if n_bad else None
    if arch not in ADAM_EDGE:
        assert n_bad == 0, (n_bad, worst)
        return
    total = sum(w.size for w in want.values())
    assert n_bad <= total // 10**4 and (worst is None or worst[0] <= case.FSDP_LR / 4), \
        (n_bad, total, worst)


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_sharded_step_matches_the_one_process_step(runs, one_process, arch, layout):
    ref, ranks = runs
    key = f"fsdp/{arch}/{layout}"
    want_m, want_p, _ = one_process[arch]
    atol = metrics_atol(ref, arch)
    for r, got in enumerate(ranks):
        assert_metrics_close(got[f"{key}/metrics"], want_m, atol, f"rank {r} loss / grad norm")
    assert_params_close({n: ranks[0][f"{key}/param/{n}"] for n in want_p}, want_p, arch)


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_sharded_step_matches_the_references_sharded_step(runs, fsdp_init, arch, layout):
    """Against the reference's ``make_train_step`` jitted with
    ``in_shardings`` on the same mesh shape, from the same parameters."""
    want, ranks = runs
    key = f"fsdp/{arch}/{layout}"
    atol = metrics_atol(want, arch)
    for r, got in enumerate(ranks):
        assert_metrics_close(got[f"{key}/metrics"], want[f"{key}/metrics"], atol,
                             f"rank {r} loss / grad norm")
    paths, treedef = jax.tree_util.tree_flatten_with_path(fsdp_init[arch])
    tree = jax.tree_util.tree_unflatten(
        treedef, [want[f"{key}/param{jax.tree_util.keystr(p)}"] for p, _ in paths])
    want_p = {n: w.detach().numpy() for n, w in _port_model(arch, tree).named_parameters()}
    assert_params_close({n: ranks[0][f"{key}/param/{n}"] for n in want_p}, want_p, arch)


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_each_rank_holds_its_slice_bytes(runs, arch, layout):
    _, ranks = runs
    key = f"fsdp/{arch}/{layout}"
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{key}/shard_bytes"], got[f"{key}/whole_over_slices"],
                                      err_msg=f"rank {r}")


def repeated_flops(cfg, model: int) -> float:
    """The FLOPs of one step that a model group of ``model`` ranks repeats on
    purpose, beyond the one-process step's: every rank runs the router's
    product on the same tokens (its forward and both backward products),
    each rank projects the KV heads its query heads read, so a KV head two
    ranks share is projected twice (``wk`` and ``wv``, forward and
    backward), and every rank computes a Mamba2 block's B and C columns of
    ``in_proj`` (forward and both backward products). Mamba1 repeats no
    counted product."""
    T, D = case.FSDP_BATCH * case.FSDP_SEQ, cfg.d_model
    G, P = cfg.layer_groups()
    n_ssm = G * (P - 1) if cfg.is_hybrid else (cfg.num_layers if cfg.ssm_kind else 0)
    n_attn = G if cfg.is_hybrid else cfg.num_layers - n_ssm
    router = 3 * 2 * T * D * cfg.num_experts * n_attn if cfg.is_moe else 0
    shared = 0
    if n_attn:
        projected = sum(head_split(cfg.num_heads, cfg.num_kv_heads, ModelGroup(None, model, r))[3]
                        for r in range(model))
        shared = 2 * 3 * 2 * T * D * cfg.head_dim * n_attn * (projected - cfg.num_kv_heads)
    bc = 3 * 2 * T * D * 2 * cfg.ssm_state * n_ssm if cfg.ssm_kind == "mamba2" else 0
    return (model - 1) * (router + bc) + shared


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_each_rank_computes_only_its_share(runs, one_process, arch, layout):
    """The ranks' FLOPs in one sharded step add up to the one-process
    step's plus only the work the design repeats on purpose."""
    _, ranks = runs
    got = sum(float(r[f"fsdp/{arch}/{layout}/flops"]) for r in ranks)
    model = case.FSDP_LAYOUTS[layout]["model"]
    want = one_process[arch][2] + repeated_flops(case.f32_smoke(arch), model)
    assert got == pytest.approx(want, rel=0.05), (got, one_process[arch][2], want)
    if model > 1:
        assert got < one_process[arch][2] * 1.25     # nothing like a whole step a rank


def test_read_policy_splits_the_mamba_blocks():
    """A split Mamba block reads each leaf as its layers use it; zamba2
    SMOKE's 8 heads do not split over a model extent of 16, and its Mamba
    leaves are then read whole."""
    mamba1 = {"in_proj": "parts", "conv_w": "slice", "conv_b": "slice", "x_proj": "slice",
              "dt_proj": "slice", "dt_bias": "parts", "A_log": "parts", "D": "parts",
              "out_proj": "slice"}
    mamba2 = {"in_proj": "parts", "conv_w": "parts", "conv_b": "parts", "dt_bias": "parts",
              "A_log": "parts", "D": "parts", "out_proj": "slice"}
    mesh4 = MeshSpec((1, 4), ("data", "model"))
    mesh16 = MeshSpec((16, 16), ("data", "model"))
    for arch, leaves, prefix in (("falcon-mamba-7b", mamba1, "layers.1.mamba."),
                                 ("zamba2-2.7b", mamba2, "layers.0.2.mamba.")):
        cfg = case.f32_smoke(arch)
        names = {n for n, _ in tm.init_params_shapes(cfg).named_parameters()}
        assert {prefix + leaf for leaf in leaves} <= names
        for leaf, read in leaves.items():
            assert read_policy(prefix + leaf, cfg, mesh4) == read, (arch, leaf)
        assert read_policy(prefix.replace("mamba.", "norm.scale"), cfg, mesh4) == "whole"
    zamba = case.f32_smoke("zamba2-2.7b")
    assert zamba.ssm_expand * zamba.d_model // zamba.ssm_head_dim == 8
    for leaf in mamba2:
        assert read_policy("layers.0.2.mamba." + leaf, zamba, mesh16) == "whole", leaf
    assert read_policy("shared_attn.attn.wq", zamba, mesh16) == "slice"


@pytest.fixture(scope="module")
def one_process_serve(fsdp_init):
    """arch -> the one-process prefill's and decode steps' logits,
    [1 + SERVE_NEW, B, (K,) V]."""
    out = {}
    S, B = case.SERVE_PROMPT, case.SERVE_BATCH
    for arch in case.FSDP_ARCHS:
        cfg = case.f32_smoke(arch)
        model = _port_model(arch, fsdp_init[arch])
        toks = torch.as_tensor(case.serve_tokens(cfg))
        logits, cache = tm.prefill_step(model, cfg, toks[:, :S])
        state = tm.init_decode_state(cfg, B, S + case.SERVE_NEW, device="cpu")
        case.copy_prefix(state, cache, S)
        steps = [logits.numpy()]
        for i in range(case.SERVE_NEW):
            logits, state = tm.decode_step(model, cfg, state, toks[:, S + i:S + i + 1],
                                           torch.full((B,), S + i))
            steps.append(logits.numpy())
        out[arch] = np.stack(steps)
    return out


@pytest.mark.parametrize("layout", case.SERVE_LAYOUTS)
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_sharded_prefill_and_decode_match_the_one_process_steps(runs, one_process_serve, arch,
                                                                layout):
    _, ranks = runs
    np.testing.assert_allclose(ranks[0][f"serve/{arch}/{layout}"], one_process_serve[arch],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", case.SERVE_LAYOUTS)
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_sharded_prefill_and_decode_match_the_references_sharded_steps(runs, arch, layout):
    """Against the reference's ``prefill_step`` / ``decode_step`` jitted
    with ``in_shardings`` on the same mesh shape (its dry-run's lowering),
    from the same parameters and tokens."""
    want, ranks = runs
    key = f"serve/{arch}/{layout}"
    np.testing.assert_allclose(ranks[0][key], want[key], rtol=1e-5, atol=1e-5)


def test_mamba1_decode_keeps_its_states_local(runs):
    """A split Mamba1 block keeps its ``conv`` and ``h`` as the rank's
    channels: the decode step gathers no state over ``model``. Mamba2's
    ``conv`` (split across [x, B, C]) is gathered, and each layer rebuilds
    its new row from the ranks' x channels."""
    _, ranks = runs
    G, P = case.f32_smoke("zamba2-2.7b").layer_groups()
    for r, got in enumerate(ranks):
        mamba1 = list(got["serve/falcon-mamba-7b/data1_model4/decode_collectives"])
        assert mamba1 and not any(c.endswith(" cache") for c in mamba1), (r, mamba1)
        assert "all-reduce tp.sum" in mamba1 and "all-gather tp.conv" not in mamba1
        mamba2 = list(got["serve/zamba2-2.7b/data1_model4/decode_collectives"])
        assert mamba2.count("all-gather tp.conv") == case.SERVE_NEW * G * (P - 1), (r, mamba2)
        assert mamba2.count("all-gather cache") == case.SERVE_NEW, (r, mamba2)


def _scan_one_process(name, fsdp_init):
    """(prefill logits, [loss, grad norm] of one step) of the one-process
    steps on ``SCAN_CASES[name]``."""
    arch, _ = case.SCAN_CASES[name]
    cfg = case.scan_config(name)
    model = tm.params_from_numpy(cfg, fsdp_init[arch], device="cpu")
    toks = torch.as_tensor(case.serve_tokens(cfg)[:, :case.SERVE_PROMPT])
    logits, _ = tm.prefill_step(model, cfg, toks)
    opt = adamw(lr=case.FSDP_LR)
    m = tm.make_train_step(cfg, opt)(model, opt.init(model), case.fsdp_batches(cfg)[0])[2]
    return logits.numpy(), [float(m["loss"]), float(m["grad_norm"])]


def _assert_scan_case(ranks, name, logits, metrics):
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{name}/prefill"], logits, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{name}/metrics"], metrics, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")


def test_sharded_ssd_scan_matches_the_one_process_step(runs, fsdp_init):
    """zamba2 with the chunked SSD scan (``ssm_impl="ssd"``, chunks of 8) at
    data 1 x model 4, two heads a rank: the sharded prefill's logits and one
    sharded step's loss and grad norm within 1e-5 of the one-process
    steps'."""
    _assert_scan_case(runs[1], "ssd", *_scan_one_process("ssd", fsdp_init))


def test_chunked_mamba1_scan_matches_the_one_process_step(runs, fsdp_init):
    """falcon-mamba with its scan chunked by 8 at data 1 x model 4, 32
    channels a rank, the state carried across chunks: as above."""
    _assert_scan_case(runs[1], "mamba1_chunked",
                      *_scan_one_process("mamba1_chunked", fsdp_init))


@pytest.mark.parametrize("name", list(case.SCAN_CASES))
def test_chunked_split_scans_match_the_references_sharded_steps(runs, name):
    """The same runs against the reference's ``prefill_step`` and
    ``make_train_step`` jitted with ``in_shardings`` on a (data 1, model 4)
    mesh, from the same parameters: within 1e-5."""
    ref, ranks = runs
    _assert_scan_case(ranks, name, ref[f"{name}/prefill"], ref[f"{name}/metrics"])


# --- the launcher ----------------------------------------------------------------------------


def test_launcher_at_four_ranks_gives_the_one_process_losses(runs, tmp_path, monkeypatch):
    _, ranks = runs
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(launcher, "get_config", lambda arch, smoke=False: case.f32_smoke(arch))
    res = launcher.main(case.LAUNCH + ["--ckpt-dir", str(tmp_path)])
    assert res["start"] == 0 and len(res["losses"]) == 4
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["launch/losses"], res["losses"], rtol=0, atol=1e-5,
                                   err_msg=f"rank {r}")
    # the sharded run's checkpoint is the unsharded tree in the one-process layout
    sharded = {k[len("launch/ckpt/"):]: v for k, v in ranks[0].items() if k.startswith("launch/ckpt/")}
    with np.load(tmp_path / "step_0000000004" / "arrays.npz") as z:
        assert sorted(z.files) == sorted(sharded)
        for k in z.files:
            assert z[k].shape == sharded[k].shape and z[k].dtype == sharded[k].dtype, k
            np.testing.assert_allclose(sharded[k], z[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_production_mesh_names_the_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="W = 1"):
        launcher.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--production-mesh"])
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(SystemExit, match="W = 8"):
        launcher.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--production-mesh"])


# --- placement -----------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(case.SHARD_CASES)))
def test_local_shard_equals_named_sharding(runs, i):
    want, _ = runs
    shape, spec = case.SHARD_CASES[i]
    mesh = MeshSpec((2, 2, 2), ("pod", "data", "model"))
    full = torch.arange(int(np.prod(shape))).reshape(shape)
    for dev, coords in enumerate(np.ndindex(2, 2, 2)):
        got = local_shard(full, P(*spec), mesh, coords)
        idx = tuple(slice(a, b) for a, b in want[f"shard/{i}"][dev])
        assert torch.equal(got, full[idx]), (spec, coords)


def test_to_placements_orders_a_split_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshSpec((2, 2, 2), ("pod", "data", "model"))
    assert to_placements(P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert to_placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert to_placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        to_placements(P("data", "data"), mesh)
