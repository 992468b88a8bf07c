"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package, architecture by architecture.

The JAX parameters (``repro.models.init_params(cfg, PRNGKey(0))``) are
carried across with ``params_from_numpy``; tokens come from numpy seeds. Each
architecture's SMOKE config runs in f32 (forward, prefill with its cache, 4
decode steps from a fresh state, every state leaf) within 1e-4; its forward
in bf16 (the configs' own dtype) is held against the f32 forward of the
same parameters, no farther from it than the reference's bf16 forward is,
plus 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref
from repro_torch import configs
from repro_torch import models as tm
from torch_cases import K  # noqa: F401  (pins torch to one thread)

ARCHS = configs.ARCH_NAMES
B, S, STEPS = 2, 16, 4
F32_TOL = dict(atol=1e-4, rtol=1e-4)

ref_forward = jax.jit(ref.forward, static_argnums=1)
ref_prefill = jax.jit(ref.prefill_step, static_argnums=1)
ref_decode = jax.jit(ref.decode_step, static_argnums=1)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def tokens(cfg, b, s, seed=0):
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def torch_tree(tree):
    return {k: torch_tree(v) if isinstance(v, dict) else v.float().numpy()
            for k, v in tree.items()}


def assert_trees_close(got: dict, want: dict, what: str, **tol):
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], f"{what}/{k}", **tol)
        else:
            assert got[k].shape == want[k].shape, (what, k, got[k].shape, want[k].shape)
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}/{k}", **tol)


def carried(cfg, key=jax.random.PRNGKey(0)):
    """(JAX params, the port's model holding the same values on the CPU)."""
    params = ref.init_params(cfg, key)
    return params, tm.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")


def sized_state(cfg, cache, b, s, new):
    """The port's prefill cache copied into a state of length s + new."""
    st = tm.init_decode_state(cfg, b, s + new, device="cpu")
    for key, sub in cache.items():
        for leaf, t in sub.items():
            (st[key][leaf] if key == "ssm" else st[key][leaf][..., :s, :, :]).copy_(t)
    return st


def ref_sized_state(cfg, cache, b, s, new):
    """The same for the reference's cache."""
    st = ref.init_decode_state(cfg, b, s + new)
    return {key: {leaf: t if key == "ssm" else st[key][leaf].at[..., :s, :, :].set(t)
                  for leaf, t in sub.items()} for key, sub in cache.items()}


# --- configs -------------------------------------------------------------------


def test_arch_names_match_the_reference():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert configs.SHAPES == {k: configs.ShapeConfig(**dataclasses.asdict(v))
                              for k, v in ref_configs.SHAPES.items()}
    assert configs.dtype_of(configs.get_config("llama3.2-1b")) == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        got = dataclasses.asdict(configs.get_config(arch, smoke=smoke))
        want = dataclasses.asdict(ref_configs.get_config(arch, smoke=smoke))
        assert got == want
        cfg = configs.get_config(arch, smoke=smoke)
        for shape in configs.SHAPES:
            assert configs.shape_supported(cfg, shape) == ref_configs.shape_supported(
                ref_configs.get_config(arch, smoke=smoke), shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_equals_the_reference(arch):
    model = tm.init_params_shapes(configs.get_config(arch))
    assert all(p.device.type == "meta" for p in model.parameters())
    assert tm.param_count(model) == ref.param_count(
        ref.init_params_shapes(ref_configs.get_config(arch)))


def test_init_params_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is the card")
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    for call in (lambda: tm.init_params(cfg), lambda: tm.init_decode_state(cfg, 1, 8),
                 lambda: tm.params_from_numpy(cfg, {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_init_params_on_the_cpu_draws_the_reference_distributions():
    cfg = f32(configs.get_config("falcon-mamba-7b", smoke=True))
    a = tm.init_params(cfg, seed=3, device="cpu")
    b = tm.init_params(cfg, seed=3, device="cpu")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    blk = a.layers[0].mamba
    assert torch.equal(blk.A_log[0], torch.log(torch.arange(1, cfg.ssm_state + 1.0)))
    assert torch.all(blk.D == 1) and torch.all(blk.conv_b == 0) and torch.all(a.final_norm.scale == 1)
    assert abs(float(a.embed.table.std()) - 0.02) < 2e-3
    assert abs(float(blk.in_proj.std()) - cfg.d_model ** -0.5) < 0.02


# --- SMOKE in f32 ----------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def smoke_f32(request):
    """The reference's f32 SMOKE outputs for one arch, and the port's model."""
    arch = request.param
    cfg = f32(ref_configs.get_config(arch, smoke=True))
    params, model = carried(cfg)
    toks = tokens(cfg, B, S + STEPS, seed=1)
    logits, aux = ref_forward(params, cfg, jnp.asarray(toks[:, :S]))
    pf_logits, pf_cache = ref_prefill(params, cfg, jnp.asarray(toks[:, :S]))
    state = ref.init_decode_state(cfg, B, S)
    steps = []
    for i in range(STEPS):
        lg, state = ref_decode(params, cfg, state, jnp.asarray(toks[:, i:i + 1]),
                               jnp.full((B,), i, jnp.int32))
        steps.append((np.asarray(lg), np_tree(state)))
    return dict(arch=arch, cfg=f32(configs.get_config(arch, smoke=True)), model=model,
                toks=toks, logits=np.asarray(logits), aux=float(aux),
                pf_logits=np.asarray(pf_logits), pf_cache=np_tree(pf_cache), steps=steps)


def test_smoke_forward_f32(smoke_f32):
    r = smoke_f32
    logits, aux = tm.forward(r["model"], r["cfg"], torch.from_numpy(r["toks"][:, :S]))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), r["logits"], **F32_TOL)
    np.testing.assert_allclose(float(aux), r["aux"], **F32_TOL)


def test_smoke_prefill_f32(smoke_f32):
    r = smoke_f32
    logits, cache = tm.prefill_step(r["model"], r["cfg"], torch.from_numpy(r["toks"][:, :S]))
    np.testing.assert_allclose(logits.numpy(), r["pf_logits"], **F32_TOL)
    assert_trees_close(torch_tree(cache), r["pf_cache"], f"{r['arch']} prefill cache", **F32_TOL)


def test_smoke_decode_f32(smoke_f32):
    r = smoke_f32
    cfg = r["cfg"]
    state = tm.init_decode_state(cfg, B, S, device="cpu")
    for i, (want_logits, want_state) in enumerate(r["steps"]):
        logits, out = tm.decode_step(r["model"], cfg, state, torch.from_numpy(r["toks"][:, i:i + 1]),
                                     torch.full((B,), i))
        assert out is state                                  # updated in place
        np.testing.assert_allclose(logits.numpy(), want_logits, err_msg=f"step {i}", **F32_TOL)
        assert_trees_close(torch_tree(state), want_state, f"{r['arch']} step {i}", **F32_TOL)


# --- SMOKE in bf16 ---------------------------------------------------------------


def row_err(got, want):
    """The largest |got - want| of a logits row over that row's max |want|."""
    return float(np.max(np.abs(got - want).max(-1) / np.abs(want).max(-1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_bf16(arch):
    """In bf16 the two packages round differently (per layer within bf16's
    rounding) and the random-init stacks amplify it, past 2e-2 of the row
    max on moonshot, zamba2 and falcon-mamba (ROADMAP C6). So each is held
    against the f32 forward of the same bf16-valued parameters: the port's
    row-relative error may exceed the reference's own by at most 2e-2."""
    cfg = ref_configs.get_config(arch, smoke=True)
    params, model = carried(cfg)
    toks = tokens(cfg, B, S, seed=2)
    want, _ = ref_forward(params, cfg, jnp.asarray(toks))
    truth, _ = ref_forward(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params),
                           f32(cfg), jnp.asarray(toks))
    got, _ = tm.forward(model, configs.get_config(arch, smoke=True), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    truth = np.asarray(truth)
    assert row_err(got.numpy(), truth) <= row_err(np.asarray(want), truth) + 2e-2


# --- caches ----------------------------------------------------------------------


def test_ring_local_decode_matches_full_cache():
    """gemma3's ring-buffer local caches decode as its full caches do, past
    the window (the reference's test of the same name, in f32)."""
    cfg = f32(configs.get_config("gemma3-12b", smoke=True))
    _, model = carried(f32(ref_configs.get_config("gemma3-12b", smoke=True)))
    steps = cfg.window_size + 4
    toks = torch.from_numpy(tokens(cfg, B, steps, seed=12))
    full = tm.init_decode_state(cfg, B, steps, device="cpu")
    ring = tm.init_decode_state(cfg, B, steps, ring_local=True, device="cpu")
    assert ring["kv_local"]["k"].shape[-3] == cfg.window_size
    for i in range(steps):
        pos = torch.full((B,), i)
        lf, full = tm.decode_step(model, cfg, full, toks[:, i:i + 1], pos)
        lr, ring = tm.decode_step(model, cfg, ring, toks[:, i:i + 1], pos)
        np.testing.assert_allclose(lr.numpy(), lf.numpy(), err_msg=f"step {i}", **F32_TOL)


def test_prefill_then_decode_in_a_sized_cache_matches_forward():
    """llama3.2-1b: prefill S tokens, copy the cache into a state of length
    S + new, decode the new tokens; both packages equal ``forward`` there."""
    cfg = f32(ref_configs.get_config("llama3.2-1b", smoke=True))
    params, model = carried(cfg)
    new = 4
    toks = tokens(cfg, B, S + new, seed=5)
    want, _ = ref_forward(params, cfg, jnp.asarray(toks))
    want = np.asarray(want)

    _, cache = ref_prefill(params, cfg, jnp.asarray(toks[:, :S]))
    state = ref_sized_state(cfg, cache, B, S, new)
    _, cache_t = tm.prefill_step(model, cfg, torch.from_numpy(toks[:, :S]))
    state_t = sized_state(cfg, cache_t, B, S, new)
    for i in range(S, S + new):
        lg, state = ref_decode(params, cfg, state, jnp.asarray(toks[:, i:i + 1]),
                               jnp.full((B,), i, jnp.int32))
        lg_t, state_t = tm.decode_step(model, cfg, state_t, torch.from_numpy(toks[:, i:i + 1]),
                                       torch.full((B,), i))
        np.testing.assert_allclose(np.asarray(lg), want[:, i], err_msg=f"reference {i}", **F32_TOL)
        np.testing.assert_allclose(lg_t.numpy(), want[:, i], err_msg=f"port {i}", **F32_TOL)


def test_decode_past_an_unsized_prefill_cache():
    """ROADMAP C5: decoding at pos = S on the prompt-sized prefill cache. The
    reference drops the K/V write silently and its logits leave ``forward``'s
    by more than its own tolerance; the port raises."""
    cfg = ref_configs.get_config("llama3.2-1b", smoke=True)
    params, model = carried(cfg)
    toks = tokens(cfg, B, S + 1, seed=6)
    want, _ = ref_forward(params, cfg, jnp.asarray(toks))
    _, cache = ref_prefill(params, cfg, jnp.asarray(toks[:, :S]))
    lg, _ = ref_decode(params, cfg, cache, jnp.asarray(toks[:, S:]), jnp.full((B,), S, jnp.int32))
    assert np.max(np.abs(np.asarray(lg) - np.asarray(want)[:, S])) > 2e-2

    cfg_t = configs.get_config("llama3.2-1b", smoke=True)
    _, cache_t = tm.prefill_step(model, cfg_t, torch.from_numpy(toks[:, :S]))
    with pytest.raises(ValueError, match="outside the cache of length 16"):
        tm.decode_step(model, cfg_t, cache_t, torch.from_numpy(toks[:, S:]), torch.full((B,), S))
