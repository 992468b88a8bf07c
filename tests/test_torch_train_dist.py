"""The port's distributed training (``repro_torch.distributed``,
``repro_torch.train.dp_trainer``, ``launch/train.py`` under torchrun) on
gloo ranks, against the JAX package and the port's one-process step.

``torch_train_dist_worker.py`` spawns 4 gloo ranks (a file store) and runs
every part in one process group; ``torch_train_dist_ref.py`` runs the
reference's side on eight host devices in a subprocess, at the same time.
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
  on moonshot) on the f32 SMOKE llama3.2-1b, moonshot and falcon-mamba, 3
  steps from the reference's parameters: loss, grad norm and the gathered
  parameters within 1e-5 of the one-process ``make_train_step`` and of the
  reference's ``make_train_step`` jitted with ``in_shardings`` on the same
  mesh shape; each rank's slices hold the leaf's bytes over its spec's
  slices; the ranks' FLOPs in one step (``FlopCounterMode``) add up, within
  5 %, to the one-process step's plus the work repeated on purpose (the
  router's product on every rank of the model group, and the projection of
  a KV head two ranks share), so a rank computes only its share;
* ``make_sharded_serve_steps`` at data 2 x model 2 and data 1 x model 4:
  the prefill's and four decode steps' logits, gathered, within 1e-5 of
  the one-process ``prefill_step`` / ``decode_step`` and of the
  reference's ``prefill_step`` / ``decode_step`` jitted with
  ``in_shardings`` (``param_specs``, ``cache_specs``) on the same mesh
  shape, from the same parameters;
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fsdp_init):
    """(the reference's arrays, each rank's arrays)."""
    work = tmp_path_factory.mktemp("train_dist")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ref = subprocess.Popen(
        [sys.executable, str(TESTS / "torch_train_dist_ref.py"), str(work / "ref.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        cwd=TESTS, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
        _, err = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]

    def load(name):
        with np.load(work / name) as z:
            return {k: z[k] for k in z.files}

    return load("ref.npz"), [load(f"rank{r}.npz") for r in range(case.WORLD)]


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


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_sharded_step_matches_the_one_process_step(runs, one_process, arch, layout):
    _, ranks = runs
    key = f"fsdp/{arch}/{layout}"
    want_m, want_p, _ = one_process[arch]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{key}/metrics"], want_m, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r} loss / grad norm")
    for n, w in want_p.items():
        np.testing.assert_allclose(ranks[0][f"{key}/param/{n}"], w, rtol=1e-5, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", case.FSDP_ARCHS)
def test_sharded_step_matches_the_references_sharded_step(runs, fsdp_init, arch, layout):
    """Against the reference's ``make_train_step`` jitted with
    ``in_shardings`` on the same mesh shape, from the same parameters."""
    want, ranks = runs
    key = f"fsdp/{arch}/{layout}"
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{key}/metrics"], want[f"{key}/metrics"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r} loss / grad norm")
    paths, treedef = jax.tree_util.tree_flatten_with_path(fsdp_init[arch])
    tree = jax.tree_util.tree_unflatten(
        treedef, [want[f"{key}/param{jax.tree_util.keystr(p)}"] for p, _ in paths])
    for n, w in _port_model(arch, tree).named_parameters():
        np.testing.assert_allclose(ranks[0][f"{key}/param/{n}"], w.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)


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
    product on the same tokens (its forward and both backward products), and
    each rank projects the KV heads its query heads read, so a KV head two
    ranks share is projected twice (``wk`` and ``wv``, forward and
    backward)."""
    T, D, L = case.FSDP_BATCH * case.FSDP_SEQ, cfg.d_model, cfg.num_layers
    router = 3 * 2 * T * D * cfg.num_experts * L if cfg.is_moe else 0
    projected = sum(head_split(cfg.num_heads, cfg.num_kv_heads, ModelGroup(None, model, r))[3]
                    for r in range(model))
    shared = 2 * 3 * 2 * T * D * cfg.head_dim * L * (projected - cfg.num_kv_heads)
    return (model - 1) * router + shared


@pytest.mark.parametrize("layout", list(case.FSDP_LAYOUTS))
@pytest.mark.parametrize("arch", ("llama3.2-1b", "moonshot-v1-16b-a3b"))
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
