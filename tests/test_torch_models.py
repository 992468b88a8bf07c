"""The port's LM layers (``repro_torch.models``: layers, attention, moe, ssm)
against the JAX package's functions of the same names, on the same numpy
parameters and inputs, in f32 within 1e-4 (the reference's own tolerance for
reassociated scans). Expert ids and capacity positions are held exactly.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from torch_cases import K  # noqa: F401  (pins torch to one thread)

TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def ns(tree):
    """A reference parameter dict as the attribute object the port reads."""
    return SimpleNamespace(**{k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), **(tol or TOL))


# --- layers --------------------------------------------------------------------


def test_rmsnorm():
    x = normal((2, 5, 32), 0, 3.0)
    scale = normal((32,), 1)
    want = r_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    close(t_layers.rmsnorm(ns({"scale": scale}), torch.from_numpy(x), 1e-5), want)


def test_apply_rope():
    x = normal((2, 7, 3, 16), 2)
    pos = np.random.default_rng(3).integers(0, 4096, (2, 7))
    for theta in (10000.0, 500000.0):
        want = r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        close(t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta), want)


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp(mlp_type):
    p = r_layers.init_mlp(KEY, 32, 96, mlp_type, jnp.float32)
    x = normal((2, 6, 32), 4, 2.0)
    want = r_layers.mlp(p, jnp.asarray(x), mlp_type)
    got = t_layers.mlp(ns(p), torch.from_numpy(x), mlp_type)
    close(got, want)
    if mlp_type == "gelu":
        # jax.nn.gelu is the tanh form: the exact (erf) gelu misses this tolerance
        tp = ns(p)
        exact = F.gelu(torch.from_numpy(x) @ tp.w_in) @ tp.w_out
        with pytest.raises(AssertionError):
            close(exact, want)


def test_embed_and_tied_unembed_give_f32_logits():
    table = jnp.asarray(normal((50, 16), 5)).astype(jnp.bfloat16)
    ids = np.random.default_rng(6).integers(0, 50, (2, 4))
    x = r_layers.embed({"table": table}, jnp.asarray(ids))
    want = r_layers.unembed({"table": table}, x)
    t_table = torch.from_numpy(np.array(table).view(np.uint16)).view(torch.bfloat16)
    tx = t_layers.embed(SimpleNamespace(table=t_table), torch.from_numpy(ids))
    assert torch.equal(tx.view(torch.int16),
                       torch.from_numpy(np.asarray(x).view(np.int16)))
    got = t_layers.unembed(SimpleNamespace(table=t_table), tx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, atol=1e-6, rtol=1e-6)


# --- attention -----------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_attn(window):
    B, S, H, KV, hd = 2, 32, 4, 2, 8
    q, k, v = normal((B, S, H, hd), 7), normal((B, S, KV, hd), 8), normal((B, S, KV, hd), 9)
    want = r_attn._chunked_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=8,
                                window=window)
    got = t_attn._chunked_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               chunk=8, window=window)
    close(got, want)
    with pytest.raises(ValueError, match="multiple of the attention chunk"):
        t_attn._chunked_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             chunk=12, window=window)


ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=10000.0)


def test_attention_and_attention_with_kv():
    p = r_attn.init_attention(KEY, 32, 4, 2, 8, jnp.float32)
    x = normal((2, 16, 32), 10)
    pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
    for window in (None, 4):
        out, (k, v) = r_attn.attention_with_kv(p, jnp.asarray(x), jnp.asarray(pos), window=window,
                                               chunk=8, **ATTN)
        got, (tk, tv) = t_attn.attention_with_kv(ns(p), torch.from_numpy(x), torch.from_numpy(pos),
                                                 window=window, chunk=8, **ATTN)
        close(got, out)
        close(tk, k)
        close(tv, v)
        close(t_attn.attention(ns(p), torch.from_numpy(x), torch.from_numpy(pos), window=window,
                               chunk=8, **ATTN),
              r_attn.attention(p, jnp.asarray(x), jnp.asarray(pos), window=window, chunk=8, **ATTN))


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention(window):
    p = r_attn.init_attention(KEY, 32, 4, 2, 8, jnp.float32)
    B, S_max = 3, 12
    kc, vc = normal((B, S_max, 2, 8), 11), normal((B, S_max, 2, 8), 12)
    x = normal((B, 1, 32), 13)
    pos = np.array([0, 7, 11])
    out, (k2, v2) = r_attn.decode_attention(p, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kc),
                                            jnp.asarray(vc), window=window, **ATTN)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, (tk2, tv2) = t_attn.decode_attention(ns(p), torch.from_numpy(x), torch.from_numpy(pos),
                                              tkc, tvc, window=window, **ATTN)
    assert tk2 is tkc and tv2 is tvc                 # written in place
    close(got, out)
    close(tk2, k2)
    close(tv2, v2)


def test_decode_attention_ring():
    p = r_attn.init_attention(KEY, 32, 4, 2, 8, jnp.float32)
    B, W = 2, 6
    kc, vc = normal((B, W, 2, 8), 15), normal((B, W, 2, 8), 16)
    x = normal((B, 1, 32), 17)
    pos = np.array([9, 3])
    slot_pos = np.array([[6, 7, 8, 3, 4, 5], [0, 1, 2, -1, -1, -1]], dtype=np.int32)
    out, (k2, v2, sp2) = r_attn.decode_attention_ring(
        p, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(slot_pos), **ATTN)
    t_sp = torch.from_numpy(slot_pos.copy())
    got, (tk2, tv2, tsp2) = t_attn.decode_attention_ring(
        ns(p), torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), t_sp, **ATTN)
    assert tsp2 is t_sp
    close(got, out)
    close(tk2, k2)
    close(tv2, v2)
    assert np.array_equal(tsp2.numpy(), np.asarray(sp2))


# --- MoE -----------------------------------------------------------------------


def test_ordered_top_k_follows_lax_top_k_on_ties():
    x = np.array([[1, 3, 3, 2, 3]], dtype=np.float32)
    _, idx = t_moe.ordered_top_k(torch.from_numpy(x), 3)
    assert idx.tolist() == [[1, 2, 4]] == np.asarray(jax.lax.top_k(jnp.asarray(x), 3)[1]).tolist()
    # many ties among 64 experts: probabilities quantised to a few values
    probs = np.random.default_rng(18).integers(0, 4, (8, 32, 64)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 6)
    got_v, got_i = t_moe.ordered_top_k(torch.from_numpy(probs), 6)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def tied_moe_params(E=8, D=16, F_=8, shared=0):
    """A reference MoE whose router has duplicated columns: every token's
    router logits tie exactly between experts (1, 3) and (2, 5, 6)."""
    p = dict(r_moe.init_moe(KEY, D, E, shared, F_, "swiglu", jnp.float32))
    r = np.array(p["router"]) * 50
    r[:, 3] = r[:, 1]
    r[:, 5] = r[:, 2]
    r[:, 6] = r[:, 2]
    p["router"] = jnp.asarray(r)
    return p


def reference_positions(idx, E):
    """The reference's token-major capacity positions (``moe.py:83-86``)."""
    G, g, k = idx.shape
    oh = jax.nn.one_hot(idx, E, dtype=jnp.float32).reshape(G, g * k, E)
    pos = jnp.cumsum(oh, axis=1) - 1.0
    return jnp.sum(pos * oh, axis=-1).reshape(G, g, k)


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_with_exact_router_ties(shared):
    p = tied_moe_params(shared=shared)
    x = normal((2, 16, 16), 19)
    kw = dict(num_experts=8, top_k=2, mlp_type="swiglu", group=16)
    out, aux = r_moe.moe(p, jnp.asarray(x), **kw)
    got, got_aux = t_moe.moe(ns(p), torch.from_numpy(x), **kw)
    close(got, out)
    close(got_aux, aux)
    probs = torch.softmax(torch.from_numpy(x).reshape(2, 16, 16) @ ns(p).router, -1)
    _, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    _, got_i = t_moe.ordered_top_k(probs, 2)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    ties = (probs.gather(-1, got_i[..., :1]) == probs.gather(-1, got_i[..., 1:])).sum()
    assert int(ties) > 0                              # the top two tie somewhere


def test_moe_drops_over_capacity_tokens_as_the_reference():
    p = tied_moe_params()
    x = normal((2, 16, 16), 20)
    kw = dict(num_experts=8, top_k=2, mlp_type="swiglu", capacity_factor=0.5, group=32)
    cap = max(int(32 * 2 * 0.5 / 8), 1)
    out, aux = r_moe.moe(p, jnp.asarray(x), **kw)
    got, got_aux = t_moe.moe(ns(p), torch.from_numpy(x), **kw)
    close(got, out)
    close(got_aux, aux)
    probs = torch.softmax(torch.from_numpy(x).reshape(1, 32, 16) @ ns(p).router, -1)
    _, idx = t_moe.ordered_top_k(probs, 2)
    _, pos_tok = t_moe.capacity_positions(idx, 8)
    assert np.array_equal(pos_tok.numpy(), np.asarray(reference_positions(jnp.asarray(idx.numpy()), 8)))
    dropped = (pos_tok >= cap).all(-1).reshape(2, 16)
    assert int((pos_tok >= cap).sum()) > 0 and int(dropped.sum()) > 0
    # a token whose every choice is over capacity contributes nothing
    assert torch.all(got[dropped] == 0) and np.all(np.asarray(out)[dropped.numpy()] == 0)
    assert torch.all(t_moe.one_hot(torch.tensor([cap, cap + 3.0]), cap) == 0)


# --- SSM -----------------------------------------------------------------------


def test_chunked_linear_scan_with_the_divisor_fallback():
    B, S, F_, ds = 2, 21, 3, 4          # chunk 8 falls back to 7
    ld = -np.abs(normal((B, S, F_, ds), 21))
    u = normal((B, S, F_, ds), 22)
    h0 = normal((B, F_, ds), 23)
    want_seq, want_fin = r_ssm.chunked_linear_scan(jnp.asarray(ld), jnp.asarray(u), jnp.asarray(h0), 8)
    got_seq, got_fin = t_ssm.chunked_linear_scan(torch.from_numpy(ld), torch.from_numpy(u),
                                                 torch.from_numpy(h0), 8)
    close(got_seq, want_seq)
    close(got_fin, want_fin)


def test_causal_conv1d():
    x = normal((2, 9, 6), 24)
    w = normal((4, 6), 25)
    b = normal((6,), 26)
    want = r_ssm._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    close(t_ssm._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)), want)


def tree_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


def test_mamba1_full_prefill_and_decode():
    D, ds, conv, expand = 16, 4, 4, 2
    p = r_ssm.init_mamba1(KEY, D, ds, conv, expand, jnp.float32)
    p = dict(p, dt_bias=jnp.asarray(normal(p["dt_bias"].shape, 27, 0.5)),
             conv_b=jnp.asarray(normal(p["conv_b"].shape, 28, 0.1)))
    x = normal((2, 12, D), 29)
    kw = dict(d_state=ds, expand=expand)
    close(t_ssm.mamba1(ns(p), torch.from_numpy(x), chunk=5, **kw),
          r_ssm.mamba1(p, jnp.asarray(x), chunk=5, **kw))
    out, st = r_ssm.mamba1_with_state(p, jnp.asarray(x), d_conv=conv, chunk=4, **kw)
    t_out, t_st = t_ssm.mamba1_with_state(ns(p), torch.from_numpy(x), d_conv=conv, chunk=4, **kw)
    close(t_out, out)
    tree_close(t_st, st)
    x1 = normal((2, 1, D), 30)
    dec, st2 = r_ssm.mamba1_decode(p, jnp.asarray(x1), st, **kw)
    t_dec, t_st2 = t_ssm.mamba1_decode(ns(p), torch.from_numpy(x1), t_st, **kw)
    close(t_dec, dec)
    tree_close(t_st2, st2)
    zero = t_ssm.init_mamba1_state(2, D, ds, conv, expand)
    tree_close(zero, r_ssm.init_mamba1_state(2, D, ds, conv, expand))


def mamba2_params(seed):
    p = r_ssm.init_mamba2(KEY, 32, 16, 4, 2, 16, jnp.float32)
    return dict(p, A_log=jnp.asarray(normal(p["A_log"].shape, seed, 0.5)),
                dt_bias=jnp.asarray(normal(p["dt_bias"].shape, seed + 1, 0.5)))


def test_mamba2_full_prefill_and_decode():
    p = mamba2_params(31)
    x = normal((2, 24, 32), 33)
    kw = dict(d_state=16, expand=2, head_dim=16)
    close(t_ssm.mamba2(ns(p), torch.from_numpy(x), chunk=8, **kw),
          r_ssm.mamba2(p, jnp.asarray(x), chunk=8, **kw))
    out, st = r_ssm.mamba2_with_state(p, jnp.asarray(x), d_conv=4, chunk=8, **kw)
    t_out, t_st = t_ssm.mamba2_with_state(ns(p), torch.from_numpy(x), d_conv=4, chunk=8, **kw)
    close(t_out, out)
    tree_close(t_st, st)
    x1 = normal((2, 1, 32), 34)
    dec, st2 = r_ssm.mamba2_decode(p, jnp.asarray(x1), st, **kw)
    t_dec, t_st2 = t_ssm.mamba2_decode(ns(p), torch.from_numpy(x1), t_st, **kw)
    close(t_dec, dec)
    tree_close(t_st2, st2)
    tree_close(t_ssm.init_mamba2_state(2, 32, 16, 4, 2, 16),
               r_ssm.init_mamba2_state(2, 32, 16, 4, 2, 16))


def test_mamba2_ssd_and_its_prefill():
    p = mamba2_params(35)
    x = normal((2, 48, 32), 37)
    kw = dict(d_state=16, expand=2, head_dim=16)
    close(t_ssm.mamba2_ssd(ns(p), torch.from_numpy(x), chunk=8, **kw),
          r_ssm.mamba2_ssd(p, jnp.asarray(x), chunk=8, **kw))
    out, st = r_ssm.mamba2_ssd_with_state(p, jnp.asarray(x), d_conv=4, chunk=10, **kw)
    t_out, t_st = t_ssm.mamba2_ssd_with_state(ns(p), torch.from_numpy(x), d_conv=4, chunk=10, **kw)
    close(t_out, out)
    tree_close(t_st, st)
