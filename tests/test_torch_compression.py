"""The port's gradient quantizer (``repro_torch.distributed.compression``)
against the JAX package's: ``quantize_leaf`` bitwise equal on seeded
inputs (halfway cases, a zero leaf, bf16), and the twins of
``tests/test_compression.py``'s two gradient cases. ``compressed_psum`` on
gloo ranks is held in ``test_torch_train_dist.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import dequantize_leaf as ref_dequantize
from repro.distributed.compression import init_residual as ref_init_residual
from repro.distributed.compression import quantize_leaf as ref_quantize
from repro_torch.distributed.compression import dequantize_leaf, init_residual, quantize_leaf


def _cases():
    rng = np.random.default_rng(0)
    halfway = (np.arange(-254, 255) / 2.0).astype(np.float32)      # q = x exactly at .5
    return {
        "normal": rng.normal(size=(64, 32)).astype(np.float32),
        "tiny": (rng.normal(size=(7, 5)) * 1e-30).astype(np.float32),
        "halfway": halfway,
        "zeros": np.zeros((16,), np.float32),
        "wide": (rng.standard_cauchy(size=(128,)) * 10).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_quantize_leaf_is_bitwise_the_references(name):
    g = _cases()[name]
    wq, ws = ref_quantize(jnp.asarray(g))
    q, s = quantize_leaf(torch.as_tensor(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert s.numpy().view(np.int32) == np.asarray(ws).view(np.int32)
    np.testing.assert_array_equal(dequantize_leaf(q, s).numpy(), np.asarray(ref_dequantize(wq, ws)))


def test_quantize_leaf_of_bf16_is_the_references():
    g = np.random.default_rng(1).normal(size=(32, 8)).astype(np.float32)
    wq, ws = ref_quantize(jnp.asarray(g, jnp.bfloat16))
    q, s = quantize_leaf(torch.as_tensor(g).to(torch.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert float(s) == float(ws)


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(64, 32)).astype(np.float32))
    q, scale = quantize_leaf(g)
    recon = dequantize_leaf(q, scale)
    # max error bounded by half a quantization bucket
    assert float(torch.max(torch.abs(recon - g))) <= float(scale) * 0.5 + 1e-7
    assert q.dtype == torch.int8


def test_quantize_zero_grad():
    q, scale = quantize_leaf(torch.zeros((16,)))
    assert float(torch.max(torch.abs(dequantize_leaf(q, scale)))) == 0.0


def test_init_residual_is_f32_zeros_like_the_references():
    grads = {"a": torch.zeros((3, 4), dtype=torch.bfloat16), "b": torch.ones(5)}
    got = init_residual(grads)
    want = ref_init_residual({"a": jnp.zeros((3, 4), jnp.bfloat16), "b": jnp.ones(5)})
    for k in grads:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
