"""The port's checkpointing (``repro_torch.train.checkpoint``) and training
launcher, against the JAX package's on-disk layout.

* the twins of ``tests/test_checkpoint.py``'s six cases on torch tensors;
* across packages: a ``(params, opt_state)`` checkpoint the reference writes
  after one step is restored by the port (in place), whose next step is
  within 1e-4 of the reference's next step; the reference restores the
  port's checkpoint with the hash verified; for the same state both write
  manifests with equal keys, shapes, dtypes and hash (f32 llama, and bf16
  zamba2 with its [G, P] layer stacks widened to f32);
* an async save is a snapshot: the in-place step taken right after it
  does not reach the file;
* ``python -m repro_torch.launch.train`` run for 4 steps, then resumed to 6,
  ends bit for bit where a 6-step run does.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref
from repro import train as ref_train
from repro.train.checkpoint import _flatten as ref_flatten
from repro_torch import models as tm
from repro_torch.configs.base import ModelConfig
from repro_torch.train import CheckpointManager, adamw, load_checkpoint, save_checkpoint
from repro_torch.train.checkpoint import list_checkpoints
from repro_torch.train.checkpoint import _flatten
from torch_cases import K  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.as_tensor(rng.normal(size=(8, 4)).astype(np.float32)),
                   "b": torch.as_tensor(rng.normal(size=(4,)).astype(np.float32))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(str(tmp_path), 7, st, extra={"note": "x"})
    target = _state(1)
    loaded, step, extra = load_checkpoint(str(tmp_path), target)
    assert step == 7 and extra["note"] == "x" and loaded is target
    assert torch.equal(loaded["params"]["w"], st["params"]["w"])
    assert loaded["step"].dtype == torch.int32 and int(loaded["step"]) == 7


def test_hash_verification_catches_corruption(tmp_path):
    st = _state()
    path = save_checkpoint(str(tmp_path), 1, st)
    man = json.load(open(os.path.join(path, "manifest.json")))
    man["hash"] = "0" * 64
    json.dump(man, open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(IOError):
        load_checkpoint(path, st)


def test_missing_key_detected(tmp_path):
    st = _state()
    save_checkpoint(str(tmp_path), 1, st)
    bigger = dict(st, extra_leaf=torch.zeros((2,)))
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path), bigger)


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_0000000003", "step_0000000004"]
    assert [Path(p).name for p in list_checkpoints(str(tmp_path))] == names
    target = _state()
    _, step, _ = mgr.restore_latest(target)
    assert step == 4 and torch.equal(target["params"]["w"], _state(4)["params"]["w"])


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, _state(5))
    mgr.wait()
    _, step, _ = mgr.restore_latest(_state())
    assert step == 5


def test_atomic_no_partial_on_existing(tmp_path):
    """A second save of the same step atomically replaces the first."""
    st = _state(1)
    save_checkpoint(str(tmp_path), 9, st)
    st2 = _state(2)
    save_checkpoint(str(tmp_path), 9, st2)
    loaded, _, _ = load_checkpoint(str(tmp_path), _state(3))
    assert torch.equal(loaded["params"]["w"], st2["params"]["w"])
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


# --- across packages ------------------------------------------------------------------


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def batch_of(cfg, seed):
    shape = (2, 16) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def port_state(cfg):
    """A port model and AdamW state of ``cfg``'s shapes (values to be restored)."""
    model = tm.init_params(ModelConfig(**dataclasses.asdict(cfg)), seed=5, device="cpu")
    return model, adamw(lr=1e-3).init(model)


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=["llama3.2-1b:f32", "zamba2-2.7b:bf16"])
def ref_run(request, tmp_path_factory):
    """The reference: one step, a checkpoint of (params, opt_state), then the
    next step's metrics and state."""
    arch, dtype = request.param.split(":")
    cfg = ref_configs.get_config(arch, smoke=True)
    cfg = f32(cfg) if dtype == "f32" else cfg
    work = tmp_path_factory.mktemp(f"ckpt_{arch}")
    params = ref.init_params(cfg, jax.random.PRNGKey(0))
    opt = ref_train.adamw(lr=1e-3)
    step = jax.jit(ref.make_train_step(cfg, opt))
    params, o, _ = step(params, opt.init(params), batch_of(cfg, 1))
    path = ref_train.save_checkpoint(str(work / "ref"), 1, (params, o))
    params, o, m = step(params, o, batch_of(cfg, 2))
    return cfg, work, path, {k: float(v) for k, v in m.items()}, (params, o)


def test_port_restores_the_references_checkpoint_and_steps_on(ref_run):
    cfg, work, path, want_m, want_state = ref_run
    model, st = port_state(cfg)
    _, step, _ = load_checkpoint(path, (model, st))
    assert step == 1 and int(st.step) == 1
    with np.load(os.path.join(path, "arrays.npz")) as z:      # restored exactly, bf16 too
        restored = _flatten((model, st))
        assert sorted(restored) == sorted(z.files)
        for k in z.files:
            np.testing.assert_array_equal(restored[k], z[k], err_msg=k)
    if cfg.dtype != "float32":      # the next step is held in f32
        return
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    _, _, m = tm.make_train_step(pcfg, adamw(lr=1e-3))(model, st, batch_of(cfg, 2))
    for k, v in want_m.items():
        np.testing.assert_allclose(float(m[k]), v, err_msg=k, **TOL)
    got, want = _flatten((model, st)), ref_flatten(want_state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_same_state_same_manifest_and_the_reference_restores_the_port(ref_run):
    cfg, work, path, _, _ = ref_run
    model, st = port_state(cfg)
    load_checkpoint(path, (model, st))
    mine = save_checkpoint(str(work / "port"), 1, (model, st), extra={"by": "port"})
    a, b = manifest(path), manifest(mine)
    for field in ("keys", "shapes", "dtypes", "hash", "step"):
        assert a[field] == b[field], field
    assert "1/.step" in a["keys"] and "0/embed/table" in a["keys"]
    assert all(len(a["shapes"][k]) >= (3 if cfg.is_hybrid else 2)
               for k in a["keys"] if k.startswith(("0/layers/", "1/.mu/layers/")))
    like = ref.init_params(cfg, jax.random.PRNGKey(3))
    tree, step, extra = ref_train.load_checkpoint(mine, (like, ref_train.adamw().init(like)))
    assert step == 1 and extra == {"by": "port"}
    want, _, _ = ref_train.load_checkpoint(path, (like, ref_train.adamw().init(like)))
    for x, y in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_async_save_is_not_torn_by_the_next_step(tmp_path):
    cfg = ModelConfig(**dataclasses.asdict(f32(ref_configs.get_config("llama3.2-1b", smoke=True))))
    model = tm.init_params(cfg, seed=0, device="cpu")
    opt = adamw(lr=1e-2)
    st = opt.init(model)
    step = tm.make_train_step(cfg, opt)
    step(model, st, batch_of(cfg, 1))
    before = _flatten((model, st))
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, (model, st))
    step(model, st, batch_of(cfg, 2))            # in place, while the writer runs
    mgr.wait()
    after = _flatten((model, st))
    assert any(not np.array_equal(after[k], before[k]) for k in before)
    with np.load(os.path.join(list_checkpoints(str(tmp_path))[-1], "arrays.npz")) as z:
        assert sorted(z.files) == sorted(before)
        for k in before:
            np.testing.assert_array_equal(z[k], before[k], err_msg=k)


def test_launcher_resume_continues_where_it_stopped(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))

    def launch(ckpt, *extra):
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                              "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", "4",
                              "--seq", "16", "--ckpt-dir", str(ckpt), *extra],
                             env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout

    launch(tmp_path / "a", "--steps", "4")
    out = launch(tmp_path / "a", "--resume", "--steps", "6")
    assert "resumed from step 4" in out and "step     5" in out
    launch(tmp_path / "b", "--steps", "6")
    got, want = (tmp_path / "a" / "step_0000000006"), (tmp_path / "b" / "step_0000000006")
    assert manifest(got)["hash"] == manifest(want)["hash"]
    with np.load(got / "arrays.npz") as a, np.load(want / "arrays.npz") as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
                          "--smoke", "--device", "cpu", "--model-parallel", "2"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "this run has W = 1" in res.stderr
