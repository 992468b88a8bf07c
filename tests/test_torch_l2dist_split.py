"""The arithmetic of the split-TF32 distance-matrix kernel (B5, B6), on the CPU.

``kernels/csrc/l2dist.cu`` computes the products on the tensor cores in TF32
(8 significant bits fewer than f32) and recovers f32 accuracy by splitting
each f32 value into ``hi = tf32(x)`` and ``lo = x - hi``: three passes for f32
x f32 (``lo·hi + hi·lo + hi·hi``), two for f32 queries against int8 rows
(every int8 value is exact in TF32; the row's scale is applied to the sum),
one for f16 x f16 (exact in TF32). The kernel cannot run here, so this file
emulates its arithmetic in numpy: the split by bit masking (round to
nearest with ties away, or truncating), the tensor core reading the top 19
bits of ``lo``, the kernel's order of k and of the passes within a 32-deep
tile, the norms in the kernel's order of fused multiply-adds, and the
epilogue ``(‖q‖² − 2·(s·acc)) + ‖c‖²`` in f32. The tensor core's own
accumulation is a model, not the hardware's exact rounding: each 8-deep
step's products are exact, and their sum with the tile's partial is
truncated to f32, as the tensor core truncates; each 32-deep tile's partial
starts from zero and is added to the running sum with round to nearest, as
the kernel does on the CUDA cores (``chip_smoke.py`` holds the card's own
rounding against the plain version). It holds the emulation within the
distance-matrix tolerance ``1e-5·(‖q‖² + ‖c‖²) + 1e-6`` of the JAX
reference, of the port's plain version and of the exact result, and shows
that one TF32 pass on f32 data is not, and that one truncating accumulator
over all of D, without the per-tile partials, loses the design's margin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dataset
from repro.kernels import ref as jref
from repro.kernels.int8dist import quantize_int8
from repro_torch.kernels import ref

BQ, BC = 48, 96
DEPTH = 32          # the kernel's depth tile
MARGIN = 0.3        # the share of the tolerance above which the design adds precision
MASK = np.uint32(0xFFFFE000)   # the 19 bits of a TF32 value


def tf32(x, mode):
    """f32 -> the nearest TF32 value ("rn": ties away from zero, as
    ``cvt.rna.tf32.f32``) or the truncated one ("trunc"), as f32."""
    b = np.asarray(x, np.float32).view(np.uint32)
    if mode == "rn":
        b = b + np.uint32(0x1000)
    return (b & MASK).view(np.float32)


def split(x, mode):
    """x = hi + lo exactly; lo as the tensor core reads it (top 19 bits)."""
    hi = tf32(x, mode)
    lo = (x - hi).astype(np.float32)
    return hi, tf32(lo, "trunc")


def kernel_order(d):
    """The kernel's k order: in each 32-deep tile, lane t of a quad holds
    k = 8t..8t+7 and k-step s takes k = 8t + 2s and 8t + 2s + 1."""
    tile = [8 * t + 2 * s + j for s in range(4) for t in range(4) for j in range(2)]
    return np.concatenate([np.asarray(tile) + k0 for k0 in range(0, d, DEPTH)])


def round_to_zero(x):
    """f64 -> f32, truncated toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def fma(a, b, acc):
    """f32 a·b + acc with one rounding (f64 holds the product exactly)."""
    return (a.astype(np.float64) * b.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def q_norms(x):
    """The kernel's ‖q‖²: lane t of a quad sums k = 8t..8t+7 of every depth
    tile by fused multiply-add, then the quad adds (n0 + n1) + (n2 + n3)."""
    n = [np.zeros(x.shape[0], np.float32) for _ in range(4)]
    for k0 in range(0, x.shape[1], DEPTH):
        for t in range(4):
            for k in range(k0 + 8 * t, k0 + 8 * t + 8):
                n[t] = fma(x[:, k], x[:, k], n[t])
    return (n[0] + n[1]) + (n[2] + n[3])


def c_norms(x, s):
    """The kernel's ‖c‖²: thread h of a pair sums k = 8t + 4h + e of every
    depth tile (t, e = 0..3) of the values times the row's scale (int8
    rows), then the pair adds its two sums."""
    n = [np.zeros(x.shape[0], np.float32) for _ in range(2)]
    for k0 in range(0, x.shape[1], DEPTH):
        for h in range(2):
            for t in range(4):
                for e in range(4):
                    v = x[:, k0 + 8 * t + 4 * h + e]
                    v = v if s is None else (v * s).astype(np.float32)
                    n[h] = fma(v, v, n[h])
    return n[0] + n[1]


def emulate(q, c, *, passes, mode, scale=None, depth=DEPTH):
    """The kernel's ``[Bq, Bc]`` output for f32-valued q, c (c holds the int8
    values when ``scale`` is given): ``passes`` in (3, 2, 1). ``depth`` is how
    many of D the tensor core sums from zero before the partial is added to
    the running sum (the kernel's 32; D for one accumulator)."""
    d = q.shape[1]
    qn, cn = q_norms(q), c_norms(c, scale)
    order = kernel_order(d)
    q, c = q[:, order], c[:, order]
    if passes == 3:
        (qh, ql), (ch, cl) = split(q, mode), split(c, mode)
        terms = [(ql, ch), (qh, cl), (qh, ch)]       # the two small products first
    elif passes == 2:
        qh, ql = split(q, mode)
        terms = [(ql, c), (qh, c)]
    else:
        terms = [(tf32(q, mode), tf32(c, mode))]
    acc = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for k0 in range(0, d, depth):
        part = np.zeros_like(acc)                    # the tile's first product overwrites
        for k in range(k0, min(k0 + depth, d), 8):   # one 8-deep step
            for a, b in terms:
                prod = a[:, k:k + 8].astype(np.float64) @ b[:, k:k + 8].astype(np.float64).T
                part = round_to_zero(part.astype(np.float64) + prod)
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    if scale is not None:
        acc = (scale[None, :] * acc).astype(np.float32)
    return ((qn[:, None] - np.float32(2) * acc).astype(np.float32) + cn[None, :]).astype(np.float32)


def tolerance_share(got, want, q, c):
    """max |got − want| / (1e-5·(‖q‖² + ‖c‖²) + 1e-6): <= 1 is within tolerance."""
    q, c = np.asarray(q, np.float64), np.asarray(c, np.float64)
    tol = 1e-5 * ((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]) + 1e-6
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) / tol))


def rows(d):
    vecs, _, _ = make_dataset(BQ + BC, d, seed=0)
    rng = np.random.default_rng(d)
    q = (vecs[:BQ] + 0.1 * rng.normal(size=(BQ, d))).astype(np.float32)
    return q, vecs[BQ:]


def exact(q, c):
    q, c = np.asarray(q, np.float64), np.asarray(c, np.float64)
    return ((q[:, None] - c[None]) ** 2).sum(-1)


@pytest.mark.parametrize("mode", ["rn", "trunc"])
@pytest.mark.parametrize("kind", ["f32", "f16", "int8"])
@pytest.mark.parametrize("d", [128, 768])
def test_split_tf32_meets_the_tolerance(d, kind, mode):
    """3, 2 or 1 passes are within the tolerance of the JAX reference, the
    port's plain version and the exact result."""
    q, c = rows(d)
    if kind == "int8":
        cq, cs = (np.array(a) for a in quantize_int8(jnp.asarray(c)))
        got = emulate(q, cq.astype(np.float32), passes=2, mode=mode, scale=cs)
        deq = cq.astype(np.float32) * cs[:, None]
        wants = [jref.int8_l2dist_ref(jnp.asarray(q), jnp.asarray(cq), jnp.asarray(cs)),
                 ref.int8_l2dist_ref(torch.from_numpy(q), torch.from_numpy(cq),
                                     torch.from_numpy(cs)).numpy(),
                 exact(q, deq)]
        c = deq
    else:
        if kind == "f16":
            q, c = q.astype(np.float16), c.astype(np.float16)
        got = emulate(q.astype(np.float32), c.astype(np.float32),
                      passes=3 if kind == "f32" else 1, mode=mode)
        wants = [jref.l2dist_ref(jnp.asarray(q), jnp.asarray(c)),
                 ref.l2dist_ref(torch.from_numpy(q), torch.from_numpy(c)).numpy(),
                 exact(q, c)]
    assert got.dtype == np.float32 and got.shape == (BQ, BC)
    for want in wants:
        share = tolerance_share(got, np.asarray(want), q, c)
        assert share <= 1.0, share


@pytest.mark.parametrize("mode", ["rn", "trunc"])
@pytest.mark.parametrize("d", [128, 768])
def test_one_tf32_pass_misses_the_tolerance(d, mode):
    """Why three passes: one TF32 pass on f32 data is outside the tolerance."""
    q, c = rows(d)
    got = emulate(q, c, passes=1, mode=mode)
    assert tolerance_share(got, exact(q, c), q, c) > 1.0


@pytest.mark.parametrize("mode", ["rn", "trunc"])
def test_one_truncating_accumulator_loses_the_margin(mode):
    """Why each 32-deep tile is summed from zero: one truncating accumulator
    over all of D = 768 errs several times more than the kernel's per-tile
    partials, beyond the share of the tolerance at which the design adds
    precision, while the per-tile form stays well within it."""
    q, c = rows(768)
    want = exact(q, c)
    tiled = tolerance_share(emulate(q, c, passes=3, mode=mode), want, q, c)
    single = tolerance_share(emulate(q, c, passes=3, mode=mode, depth=768), want, q, c)
    assert tiled < MARGIN < single, (tiled, single)
    assert single > 5 * tiled, (tiled, single)


@pytest.mark.parametrize("mode", ["rn", "trunc"])
def test_int8_and_f16_values_are_exact_in_tf32(mode):
    """The premise of the 2- and 1-pass cases: TF32 rounding leaves every
    int8 value and every finite f16 value unchanged."""
    i8 = np.arange(-128, 128, dtype=np.int16).astype(np.float32)
    np.testing.assert_array_equal(tf32(i8, mode), i8)
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    h = h[np.isfinite(h)].astype(np.float32)
    assert h.size == (1 << 16) - 2048
    np.testing.assert_array_equal(tf32(h, mode), h)
