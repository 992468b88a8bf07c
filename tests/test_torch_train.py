"""The port's training path (``repro_torch.models.steps``, ``repro_torch.train``)
against the JAX package, architecture by architecture.

Every SMOKE config runs in f32 from the reference's parameters
(``repro.models.init_params(cfg, PRNGKey(0))``, carried across by
``params_from_numpy``) and one numpy batch: one ``make_train_step`` with
``adamw`` gives the reference's loss, aux, total and grad norm, and its new
parameters and every ``mu``, ``nu`` and ``master`` leaf (compared by
checkpoint key, the layers restacked), within 1e-4. The three remat
policies give bit-equal gradients on the CPU. Also: three llama steps under
``cosine_lr``, ``softmax_xent`` (with musicgen's ``[B, S, K, V]``), the
twins of the reference's train-step, ``softmax_xent`` and loss-decrease
tests in the configs' bf16, ``params_to_numpy`` as the exact inverse of
``params_from_numpy``, and the serving steps unchanged with gradients on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref
from repro.models.steps import softmax_xent as ref_softmax_xent
from repro.train import adamw as ref_adamw
from repro.train import cosine_lr as ref_cosine_lr
from repro.train.checkpoint import _flatten as ref_flatten
from repro_torch import configs
from repro_torch import models as tm
from repro_torch.configs.base import ModelConfig
from repro_torch.train import adamw, cosine_lr
from repro_torch.train.checkpoint import _flatten
from torch_cases import K  # noqa: F401  (pins torch to one thread)

ARCHS = configs.ARCH_NAMES
B, S = 2, 16
TOL = dict(atol=1e-4, rtol=1e-4)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def batch_of(cfg, b=B, s=S, seed=0):
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _port_cfg(cfg):
    """The port's config of the same fields as the reference's ``cfg``."""
    return ModelConfig(**dataclasses.asdict(cfg))


def assert_state_close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), (what, set(got) ^ set(want))
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}", **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def one_step(request):
    """The reference's f32 step from its parameters: (cfg, its params, the
    batch, its metrics, its flattened (params, opt_state) after the step)."""
    cfg = f32(ref_configs.get_config(request.param, smoke=True))
    params = ref.init_params(cfg, jax.random.PRNGKey(0))
    batch = batch_of(cfg)
    opt = ref_adamw(lr=1e-3)
    p2, o2, m = jax.jit(ref.make_train_step(cfg, opt))(params, opt.init(params), batch)
    return (cfg, jax.tree_util.tree_map(np.asarray, params), batch,
            {k: float(v) for k, v in m.items()}, ref_flatten((p2, o2)))


def test_train_step_matches_the_reference(one_step):
    cfg, params, batch, want_m, want = one_step
    pcfg = _port_cfg(cfg)
    model = tm.params_from_numpy(pcfg, params, device="cpu")
    opt = adamw(lr=1e-3)
    state = opt.init(model)
    model2, state2, m = tm.make_train_step(pcfg, opt)(model, state, batch)
    assert model2 is model and state2 is state and int(state.step) == 1
    assert sorted(m) == sorted(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(m[k]), v, err_msg=k, **TOL)
        assert m[k].dtype == torch.float32 and not m[k].requires_grad
    assert_state_close(_flatten((model, state)), want, cfg.name)


def _grads(model, cfg, batch):
    """The gradients, and the bytes autograd itself saved for the backward
    (a checkpointed block's activations are kept by the checkpoint instead)."""
    named = dict(model.named_parameters())
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = tm.loss_fn(model, cfg, torch.as_tensor(batch["tokens"]),
                              torch.as_tensor(batch["labels"]))
    return torch.autograd.grad(total, list(named.values()), materialize_grads=True), saved[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_bit_equal_gradients(arch):
    cfg = f32(configs.get_config(arch, smoke=True))
    model = tm.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    batch = batch_of(cfg, seed=3)
    runs = {remat: _grads(model, dataclasses.replace(cfg, remat=remat), batch)
            for remat in ("none", "dots", "full")}
    grads = {remat: g for remat, (g, _) in runs.items()}
    assert runs["dots"][1] < runs["none"][1] and runs["full"][1] < runs["none"][1]
    for remat in ("dots", "full"):
        for name, g, want in zip(dict(model.named_parameters()), grads[remat], grads["none"]):
            assert torch.isfinite(want).all(), name
            assert torch.equal(g, want), (remat, name)


def test_llama_three_steps_under_cosine_lr():
    cfg = f32(ref_configs.get_config("llama3.2-1b", smoke=True))
    params = ref.init_params(cfg, jax.random.PRNGKey(0))
    opt = ref_adamw(lr=ref_cosine_lr(3e-4, warmup=2, total=10))
    step = jax.jit(ref.make_train_step(cfg, opt))
    model = tm.params_from_numpy(_port_cfg(cfg), jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    topt = adamw(lr=cosine_lr(3e-4, warmup=2, total=10))
    tstep = tm.make_train_step(_port_cfg(cfg), topt)
    o, to = opt.init(params), topt.init(model)
    for i in range(3):
        batch = batch_of(cfg, seed=10 + i)
        params, o, m = step(params, o, batch)
        model, to, tmm = tstep(model, to, batch)
        for k in m:
            np.testing.assert_allclose(float(tmm[k]), float(m[k]), err_msg=f"step {i} {k}", **TOL)
        assert_state_close(_flatten((model, to)), ref_flatten((params, o)), f"step {i}")


def test_cosine_lr_matches_the_reference():
    ref_s, s = ref_cosine_lr(3e-4, warmup=2, total=10), cosine_lr(3e-4, warmup=2, total=10)
    for step in range(0, 14):
        want = float(ref_s(jnp.asarray(step, jnp.int32)))
        got = s(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(2, 5, 11), (2, 5, 3, 11)], ids=["BSV", "BSKV"])
def test_softmax_xent_matches_the_reference(shape):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(ref_softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = tm.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, **TOL)
    bf = tm.softmax_xent(torch.as_tensor(logits).to(torch.bfloat16), torch.as_tensor(labels))
    assert bf.dtype == torch.float32


def test_softmax_xent_sanity():
    logits = torch.tensor([[[10.0, 0.0], [0.0, 10.0]]])
    labels = torch.tensor([[0, 1]])
    assert float(tm.softmax_xent(logits, labels)) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_forward_and_train(arch):
    """One forward + one train step on the CPU in the config's dtype (bf16):
    output shapes, no NaNs, the parameters changed."""
    cfg = configs.get_config(arch, smoke=True)
    model = tm.init_params(cfg, seed=0, device="cpu")
    assert tm.param_count(model) > 0
    batch = batch_of(cfg)
    logits, aux = tm.forward(model, cfg, torch.as_tensor(batch["tokens"]))
    want = (B, S, cfg.num_codebooks, cfg.vocab_size) if cfg.num_codebooks > 1 \
        else (B, S, cfg.vocab_size)
    assert tuple(logits.shape) == want and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw(lr=1e-3)
    _, _, m = tm.make_train_step(cfg, opt)(model, opt.init(model),
                                           {"tokens": batch["tokens"], "labels": batch["tokens"]})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    delta = sum(float((p.detach().float() - before[n].float()).abs().max())
                for n, p in model.named_parameters())
    assert delta > 0
    assert all(p.dtype == before[n].dtype for n, p in model.named_parameters())


def test_tiny_lm_training_loss_decreases():
    """The training substrate end to end: loss drops on a memorizable task."""
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    model = tm.init_params(cfg, seed=0, device="cpu")
    opt = adamw(lr=3e-3)
    step = tm.make_train_step(cfg, opt)
    opt_state = opt.init(model)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    first = last = None
    for _ in range(25):
        model, opt_state, m = step(model, opt_state, batch)
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first * 0.7, (first, last)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b", "zamba2-2.7b", "musicgen-large",
                                  "deepseek-moe-16b", "falcon-mamba-7b"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    cfg = ref_configs.get_config(arch, smoke=True)       # bf16 leaves as ml_dtypes arrays
    tree = jax.tree_util.tree_map(np.asarray, ref.init_params(cfg, jax.random.PRNGKey(1)))
    back = tm.params_to_numpy(tm.params_from_numpy(_port_cfg(cfg), tree, device="cpu"))
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8), a.view(np.uint8), err_msg=str(k))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "gemma3-12b"])
def test_serving_steps_unchanged_with_gradients_on(arch):
    cfg = f32(configs.get_config(arch, smoke=True))
    model = tm.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(batch_of(cfg)["tokens"])

    def serve():
        lg, cache = tm.prefill_step(model, cfg, toks)
        st = tm.init_decode_state(cfg, B, S + 1, device="cpu")
        for key, sub in cache.items():
            for leaf, t in sub.items():
                (st[key][leaf] if key == "ssm" else st[key][leaf][..., :S, :, :]).copy_(t)
        dl, _ = tm.decode_step(model, cfg, st, toks[:, :1], torch.full((B,), S))
        fw, _ = tm.forward(model, cfg, toks)
        return lg, dl, fw

    off = serve()
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    on = serve()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert not on[0].requires_grad and not on[1].requires_grad     # no_grad steps
    assert on[2].requires_grad                                       # forward builds a graph


def test_ssd_scan_gradient_is_finite_where_the_references_is_not():
    """ROADMAP C8: above the diagonal the SSD exponent is positive and, with
    a large step, overflows; the reference's ``where(mask, exp(seg), 0)``
    then has a NaN gradient (0 * inf). The port masks the exponent: the
    same values, a finite gradient."""
    from repro.models.ssm import _ssd_scan as ref_ssd
    from repro_torch.models.ssm import _ssd_scan

    rng = np.random.default_rng(0)
    xh = rng.standard_normal((1, 16, 2, 4)).astype(np.float32)
    dt = np.full((1, 16, 2), 60.0, np.float32)
    A = np.array([-1.0, -2.0], np.float32)
    Bc, Cc = (rng.standard_normal((1, 16, 3)).astype(np.float32) for _ in range(2))

    def ref_sum(d):
        return ref_ssd(jnp.asarray(xh), d, jnp.asarray(A), jnp.asarray(Bc), jnp.asarray(Cc), 8)[0].sum()

    assert not bool(jnp.isfinite(jax.grad(ref_sum)(jnp.asarray(dt))).all())
    d = torch.tensor(dt, requires_grad=True)
    y = _ssd_scan(torch.tensor(xh), d, torch.tensor(A), torch.tensor(Bc), torch.tensor(Cc), 8)[0]
    y.sum().backward()
    assert torch.isfinite(d.grad).all()
    np.testing.assert_allclose(y.detach().sum().item(), float(ref_sum(jnp.asarray(dt))), **TOL)
