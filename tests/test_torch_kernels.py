"""The port's plain kernel versions against the JAX package's kernels, on the CPU.

The same numpy inputs go through the Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them), the jnp oracles, and the port's plain
PyTorch versions, on the parameter matrices of ``tests/test_kernels.py``.
Scorer distances: equal +inf positions, finite values within ``rtol=1e-5,
atol=1e-5·max(1, |d|)`` (f32 sums in another order). Distance matrices
(``l2dist``, ``int8_l2dist``): within ``1e-5·(‖q‖² + ‖c‖²) + 1e-6`` — the
expanded form cancels, so its error follows the norms, not d.
``beam_merge``: bitwise. The CUDA kernels themselves run only on the card,
where ``chip_smoke.py`` holds each against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.beam_merge import beam_merge_pallas, dedup_mask as jdedup, mono_key_u32
from repro.search import device_graph as jdg
from repro_torch.kernels import ops, ref
from repro_torch.search import device_graph as tdg

RNG = np.random.default_rng(0)


def t(a):
    """numpy -> torch, uint32 carried as int32 bit patterns."""
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def assert_dist_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    tol = 1e-5 * np.maximum(1.0, np.abs(want[fin]))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)
    assert np.all(np.abs(got[fin] - want[fin]) <= tol + 1e-5 * np.abs(want[fin]))


def assert_matrix_close(got, want, q, c):
    """``|got − want| <= 1e-5·(‖q‖² + ‖c‖²) + 1e-6``, entry by entry."""
    q = np.asarray(q, np.float64)
    c = np.asarray(c, np.float64)
    tol = 1e-5 * ((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]) + 1e-6
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol), float((err - tol).max())


def test_warp_dot_sums_in_the_lane_order():
    """The scorers' f64 order, spelled out element by element: lane l adds
    elements 32·w·k + w·l + j in turn, then the lanes pair as a butterfly."""
    rng = np.random.default_rng(5)
    for d, width in ((7, 4), (200, 4), (300, 16), (1030, 16)):
        x = rng.normal(size=(3, d)).astype(np.float32)
        y = rng.normal(size=(3, d)).astype(np.float32)
        for i in range(3):
            lanes = [0.0] * 32
            for e in range(d):
                lane = (e // width) % 32
                lanes[lane] = lanes[lane] + float(x[i, e]) * float(y[i, e])
            o = 16
            while o:
                lanes = [lanes[l] + lanes[l + o] for l in range(o)]
                o //= 2
            got = ref.warp_dot(t(x[i]), t(y[i]), width)
            assert got.item() == np.float32(lanes[0]), (d, width)


@pytest.mark.parametrize("b,e,d", [(1, 1, 4), (3, 17, 8), (8, 128, 32), (5, 200, 64), (4, 9, 131)])
def test_filter_dist_matches_jax(b, e, d):
    """B4, the dense scorer, on ``tests/test_kernels.py``'s matrix (plus an
    odd D), against the Pallas kernel and the jnp oracle."""
    rng = np.random.default_rng(b * 100 + e)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cand = rng.normal(size=(b, e, d)).astype(np.float32)
    labels = rng.integers(0, 12, size=(b, e, 4)).astype(np.int32)
    state = rng.integers(0, 12, size=(b, 2)).astype(np.int32)
    ids = rng.integers(-1, 40, size=(b, e)).astype(np.int32)
    args = (q, cand, labels, state, ids)
    got = ops.filter_dist(*map(t, args)).numpy()
    assert_dist_close(got, jops.filter_dist(*map(jnp.asarray, args)))
    assert_dist_close(got, jops.filter_dist(*map(jnp.asarray, args), use_ref=True))


def test_filter_dist_label_semantics_and_invalid_rows():
    """a in [l, r] and c in [b, e], closed on both ends; an all-invalid row
    and id -1 give +inf; a valid row's distance is ``‖c − q‖²``."""
    q = np.zeros((2, 4), np.float32)
    cand = np.ones((2, 3, 4), np.float32)
    labels = np.asarray([[[0, 5, 0, 5], [2, 2, 0, 5], [0, 5, 3, 5]]] * 2, np.int32)
    state = np.asarray([[2, 2], [2, 2]], np.int32)
    ids = np.asarray([[0, 1, 2], [-1, -1, -1]], np.int32)
    out = ops.filter_dist(*map(t, (q, cand, labels, state, ids))).numpy()
    np.testing.assert_array_equal(out[0], [4.0, 4.0, np.inf])
    assert np.isinf(out[1]).all()


@pytest.mark.parametrize("bq,bc,d", [
    (1, 1, 4), (7, 33, 16), (128, 128, 64), (37, 215, 70), (130, 50, 200),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_l2dist_matches_jax(bq, bc, d, dtype):
    """B5 on ``tests/test_kernels.py``'s matrix, f32 and f16 inputs."""
    rng = np.random.default_rng(bq + bc + d)
    q = rng.normal(size=(bq, d)).astype(dtype)
    c = rng.normal(size=(bc, d)).astype(dtype)
    got = ops.l2dist(t(q), t(c)).numpy()
    assert got.dtype == np.float32 and got.shape == (bq, bc)
    for want in (jops.l2dist(jnp.asarray(q), jnp.asarray(c)),
                 jref.l2dist_ref(jnp.asarray(q), jnp.asarray(c))):
        assert_matrix_close(got, np.asarray(want), q, c)
    exact = ((q.astype(np.float64)[:, None] - c.astype(np.float64)[None]) ** 2).sum(-1)
    assert_matrix_close(got, exact, q, c)


@pytest.mark.parametrize("bq,bc,d", [(4, 9, 8), (65, 200, 48)])
def test_int8_l2dist_matches_jax(bq, bc, d):
    """B6 on ``tests/test_kernels.py``'s matrix: the same quantized rows and
    scales through both packages."""
    rng = np.random.default_rng(bq * bc)
    q = rng.normal(size=(bq, d)).astype(np.float32)
    c = rng.normal(size=(bc, d)).astype(np.float32)
    cq, cs = jops.quantize_int8(jnp.asarray(c))
    cq, cs = np.asarray(cq), np.asarray(cs)
    got = ops.int8_l2dist(t(q), t(cq), t(cs)).numpy()
    deq = cq.astype(np.float32) * cs[:, None]
    for want in (jops.int8_l2dist(jnp.asarray(q), jnp.asarray(cq), jnp.asarray(cs)),
                 jref.int8_l2dist_ref(jnp.asarray(q), jnp.asarray(cq), jnp.asarray(cs))):
        assert_matrix_close(got, np.asarray(want), q, deq)


def _gather_case(n, b, c, d, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.sum(table * table, axis=1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    labels = rng.integers(0, 12, size=(b, c, 4)).astype(np.int32)
    state = rng.integers(0, 12, size=(b, 2)).astype(np.int32)
    vis = rng.integers(0, 2 ** 32, size=(b, (n + 31) // 32), dtype=np.uint64).astype(np.uint32)
    return table, norms, q, ids, labels, state, vis


def _packed_case(n, b, m, e, d, seed=0, rank_hi=12):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.sum(table * table, axis=1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cur = rng.integers(0, n, size=(b, m)).astype(np.int32)
    cand = rng.integers(-1, n, size=(b, m * e)).astype(np.int32)
    lo = rng.integers(0, rank_hi, size=(n, e, 2)).astype(np.uint32)
    hi = rng.integers(0, rank_hi, size=(n, e, 2)).astype(np.uint32)
    plabels = lo | (hi << 16)
    state = rng.integers(0, rank_hi, size=(b, 2)).astype(np.int32)
    vis = rng.integers(0, 2 ** 32, size=(b, (n + 31) // 32), dtype=np.uint64).astype(np.uint32)
    return table, plabels, norms, q, cur, cand, state, vis


@pytest.mark.parametrize("n,b,c,d", [
    (33, 1, 5, 4),        # B=1, n not a multiple of 32 (bitmap tail word)
    (100, 3, 24, 7),      # odd D
    (200, 4, 130, 16),    # C not a multiple of the tile
    (513, 2, 260, 32),    # multi-tile with n % 32 != 0
])
def test_filter_dist_gather_matches_jax(n, b, c, d):
    case = _gather_case(n, b, c, d)
    got = ops.filter_dist_gather(*map(t, case)).numpy()
    assert_dist_close(got, jops.filter_dist_gather(*map(jnp.asarray, case)))
    assert_dist_close(got, jops.filter_dist_gather(*map(jnp.asarray, case), use_ref=True))


def test_filter_dist_gather_all_invalid_tile():
    table, norms, q, ids, labels, state, vis = _gather_case(64, 2, 16, 8, seed=7)
    ids = np.full_like(ids, -1)
    out = ops.filter_dist_gather(*map(t, (table, norms, q, ids, labels, state, vis)))
    assert torch.isinf(out).all()


def test_filter_dist_gather_visited_bitmap_semantics():
    """Bit i>>5 : i&31 set => candidate i suppressed, bit 31 and the tail
    word of an n that is not a multiple of 32 included."""
    n, d = 45, 8
    table = RNG.normal(size=(n, d)).astype(np.float32)
    norms = np.sum(table * table, axis=1)
    q = np.zeros((1, d), np.float32)
    ids = np.asarray([[3, 31, 32, 44]], np.int32)
    labels = np.zeros((1, 4, 4), np.int32)
    labels[..., 1] = labels[..., 3] = 10
    state = np.asarray([[5, 5]], np.int32)
    vis = np.zeros((1, 2), np.uint32)
    vis[0, 0] = (np.uint32(1) << 31) | np.uint32(1 << 3)
    vis[0, 1] = np.uint32(1 << (44 - 32))
    args = (table, norms, q, ids, labels, state, vis)
    out = ops.filter_dist_gather(*map(t, args)).numpy()
    assert np.isinf(out[0, [0, 1, 3]]).all() and np.isfinite(out[0, 2])
    assert_dist_close(out, jops.filter_dist_gather(*map(jnp.asarray, args)))


def test_quantize_int8_and_int8_scales_match_jax():
    n, b, c, d = 90, 3, 33, 16
    table, _, q, ids, labels, state, vis = _gather_case(n, b, c, d, seed=9)
    tq, sc = ops.quantize_int8(torch.from_numpy(table))
    jq, jsc = jops.quantize_int8(jnp.asarray(table))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy().view(np.int32), np.asarray(jsc).view(np.int32))
    deq = tq.float() * sc[:, None]
    norms = torch.sum(deq * deq, dim=1)
    got = ops.filter_dist_gather(tq, norms, *map(t, (q, ids, labels, state, vis)), scales=sc)
    want = jops.filter_dist_gather(
        jq, jnp.asarray(norms.numpy()), *map(jnp.asarray, (q, ids, labels, state, vis)),
        scales=jsc)
    assert_dist_close(got.numpy(), want)


@pytest.mark.parametrize("n,b,m,e,d", [
    (33, 1, 1, 5, 4),       # B=1, bitmap tail word
    (100, 3, 2, 12, 7),     # odd D, multi-expand label rows
    (200, 4, 1, 130, 16),   # M*E not a multiple of the tile
    (257, 2, 4, 65, 32),    # wide multi-expand straddling tiles
])
def test_filter_dist_gather_packed_matches_jax(n, b, m, e, d):
    case = _packed_case(n, b, m, e, d)
    got = ops.filter_dist_gather_packed(*map(t, case)).numpy()
    assert_dist_close(got, jops.filter_dist_gather_packed(*map(jnp.asarray, case)))
    assert_dist_close(got, jops.filter_dist_gather_packed(*map(jnp.asarray, case), use_ref=True))


def test_packed_scorer_int8_matches_jax():
    table, plabels, _, q, cur, cand, state, vis = _packed_case(120, 3, 2, 20, 16, seed=2)
    jq, jsc = jops.quantize_int8(jnp.asarray(table))
    deq = np.asarray(jq, np.float32) * np.asarray(jsc)[:, None]
    norms = np.sum(deq * deq, axis=1)
    rest = (plabels, norms, q, cur, cand, state, vis)
    got = ops.filter_dist_gather_packed(
        t(np.asarray(jq)), *map(t, rest), scales=t(np.asarray(jsc)))
    want = jops.filter_dist_gather_packed(jq, *map(jnp.asarray, rest), scales=jsc)
    assert_dist_close(got.numpy(), want)


def test_packed_label_semantics_boundaries():
    """Closed bounds survive the 16-bit packing: a == r is active, b > c is
    not — as the int32 label test."""
    n, d = 8, 4
    lab4 = np.array([[[0, 5, 0, 5], [2, 2, 0, 5], [0, 5, 3, 5]]], np.int32)
    plabels = np.ascontiguousarray(np.broadcast_to(tdg.pack_labels(lab4[0])[None], (n, 3, 2)))
    args = (np.zeros((n, d), np.float32), plabels, np.zeros(n, np.float32),
            np.zeros((1, d), np.float32), np.zeros((1, 1), np.int32),
            np.asarray([[0, 1, 2]], np.int32), np.asarray([[2, 2]], np.int32),
            np.zeros((1, 1), np.uint32))
    out = ops.filter_dist_gather_packed(*map(t, args)).numpy()
    assert np.isfinite(out[0, :2]).all() and np.isinf(out[0, 2])
    assert_dist_close(out, jops.filter_dist_gather_packed(*map(jnp.asarray, args)))


def test_pack_and_unpack_labels_are_bit_equal_to_jax():
    lab = RNG.integers(0, 1 << 16, size=(50, 7, 4)).astype(np.int32)
    lab[0, 0] = [0, 0xFFFF, 0xFFFF, 0]
    packed = tdg.pack_labels(lab)
    np.testing.assert_array_equal(packed, jdg.pack_labels(lab))
    assert packed.dtype == np.uint32
    np.testing.assert_array_equal(tdg.unpack_labels(packed), jdg.unpack_labels(packed))
    np.testing.assert_array_equal(tdg.unpack_labels(packed), lab)
    np.testing.assert_array_equal(
        ref.unpack_labels(t(packed)).numpy(), np.asarray(jref.unpack_labels_jnp(jnp.asarray(packed))))
    with pytest.raises(ValueError):
        tdg.pack_labels(np.full((1, 4), 1 << 16, np.int32))


def _merge_case(b, l, c, n, seed=0, tie_heavy=False, all_inf=False):
    rng = np.random.default_rng(seed)
    beam_d = np.sort(rng.normal(size=(b, l)).astype(np.float32) ** 2, axis=1)
    ninf = int(rng.integers(0, max(l // 2, 1)))
    if ninf:
        beam_d[:, l - ninf:] = np.inf
    beam_ids = rng.integers(-1, n, size=(b, l)).astype(np.int32)
    beam_ids[~np.isfinite(beam_d)] = -1
    beam_exp = rng.random((b, l)) < 0.5
    if tie_heavy:
        cand_d = rng.integers(0, 4, size=(b, c)).astype(np.float32)
        cand_ids = rng.integers(0, min(8, n), size=(b, c)).astype(np.int32)
        beam_d = np.sort(rng.integers(0, 4, size=(b, l)).astype(np.float32), axis=1)
    else:
        cand_d = rng.normal(size=(b, c)).astype(np.float32) ** 2
        cand_ids = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    cand_d[rng.random((b, c)) < 0.3] = np.inf
    if all_inf:
        cand_d[:] = np.inf
        cand_ids[:] = -1
    return beam_d, beam_ids, beam_exp, cand_d, cand_ids


@pytest.mark.parametrize("b,l,c,n,tie,all_inf", [
    (3, 64, 88, 4000, False, False),   # bench shape
    (2, 48, 17, 100, False, False),    # L and C not powers of two
    (1, 7, 3, 10, True, False),        # tiny, tie-heavy
    (2, 32, 40, 40, True, False),      # heavy duplicate ids + tied dists
    (2, 16, 8, 50, False, True),       # all-inf candidate set
    (2, 96, 352, 65000, False, False), # wide-beam / multi-expand scale
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_merge_bitwise_equal_to_jax(b, l, c, n, tie, all_inf, seed):
    """The plain merge is bitwise equal to the stable lax.sort oracle and to
    the Pallas bitonic network (interpret), ties and duplicates included."""
    case = _merge_case(b, l, c, n, seed, tie, all_inf)
    got = ops.beam_merge(*map(t, case), n=n)
    for want in (jref.beam_merge_ref(*map(jnp.asarray, case), n=n),
                 beam_merge_pallas(*map(jnp.asarray, case), n=n, interpret=True)):
        for g, w, name in zip(got, want, ("ids", "d", "exp", "keep")):
            g, w = g.numpy(), np.asarray(w)
            if name == "d":
                g, w = g.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_beam_merge_dedup_keeps_first_and_marks_bits():
    ids, d, exp, keep = ops.beam_merge(
        torch.tensor([[1.0, float("inf")]]), torch.tensor([[7, -1]], dtype=torch.int32),
        torch.tensor([[True, False]]), torch.tensor([[0.5, 0.5, 2.0, float("inf")]]),
        torch.tensor([[3, 3, 3, 3]], dtype=torch.int32), n=10)
    assert keep.tolist() == [[True, False, False, False]]
    assert ids.tolist() == [[3, 7]] and d.tolist() == [[0.5, 1.0]]
    assert exp.tolist() == [[False, True]]


def test_topk_merge_folds_like_beam_merge():
    case = _merge_case(3, 10, 20, 500, seed=4)
    ids, d = ops.topk_merge(t(case[0]), t(case[1]), t(case[3]), t(case[4]), n=500)
    want = jops.topk_merge(*map(jnp.asarray, (case[0], case[1], case[3], case[4])),
                           n=500, use_ref=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(d.numpy().view(np.int32), np.asarray(want[1]).view(np.int32))


def test_mono_key_and_dedup_mask_match_jax():
    d = np.array([[-np.inf, -2.5, -0.0, 0.0, 1e-30, 3.0, np.inf, -1e-30]], np.float32)
    np.testing.assert_array_equal(
        ref.mono_key(t(d)).numpy(), np.asarray(mono_key_u32(jnp.asarray(d))).astype(np.int64))
    cd, ci = _merge_case(4, 8, 40, 12, seed=3, tie_heavy=True)[3:]
    np.testing.assert_array_equal(
        ref.dedup_mask(t(cd), t(ci), 12).numpy(), np.asarray(jdedup(jnp.asarray(cd), jnp.asarray(ci), 12)))


def test_ops_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: it
    launches a kernel or raises."""
    case = [x.to("meta") for x in map(t, _merge_case(1, 4, 4, 10))]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.beam_merge(*case, n=10)
    mixed = list(map(t, _gather_case(33, 1, 5, 4)))
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(RuntimeError, match="several devices"):
        ops.filter_dist_gather(*mixed)
    q = torch.zeros((2, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.l2dist(q, q)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.int8_l2dist(q, q.to(torch.int8), torch.ones(2, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.filter_dist(q, q[:, None], torch.zeros((2, 1, 4), dtype=torch.int32, device="meta"),
                        torch.zeros((2, 2), dtype=torch.int32, device="meta"),
                        torch.zeros((2, 1), dtype=torch.int32, device="meta"))
