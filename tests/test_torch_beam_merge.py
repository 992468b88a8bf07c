"""The selection of the beam-merge kernel (B2), emulated on the CPU.

``kernels/csrc/beam_merge.cu`` runs one warp per row. The kernel cannot run
here, so this file replays its steps in numpy, lane by lane, with the
constants read from the source:

1. the beam: one ballot a 32-entry step tests that its keys ascend, and the
   largest (key, index) pair is the threshold a candidate must be below;
2. the candidates, ``kPerLane`` a lane and ``32·kPerLane`` a step: the live
   ones (not +inf) listed in index order by per-``k`` ballots and their
   popcounts; then rounds of 32 over the list: the lowest lane of each
   finite id in a round (``__match_any_sync``) is its first there, kept
   unless an earlier round put the id in the hash of ``hash_slots(F)``
   slots for the row's F finite candidates (linear probing; the inserts of distinct ids, applied in a
   shuffled order, as the lanes' atomics land in any order) or it is the
   sentinel id ``n`` after a non-finite candidate; kept and ``-inf``
   candidates below the threshold survive, in index order;
3. the selection: batches of ``P = next_pow2(max(L, 32))`` pairs sorted by
   the kernel's bitonic network (only the prefix that holds the live
   pairs) and folded into the running best P (least of a[i] and
   b[P-1-i], then a bitonic merge);
4. the beam's pairs, sorted by the same network if step 1 found them out of
   order, folded with the best P: the first L are the output. A beam wider
   than ``32·kMaxN`` takes steps 3-4 in chunks of P output slots, each the
   best P pairs above the last chunk's largest.

The emulation is held bitwise against the JAX package's stable-sort oracle
``jref.beam_merge_ref`` on ``test_torch_kernels.py``'s merge matrix and on the
cases the design has to get right (unsorted beams, fewer and more survivors
than L, an all-finite beam, the sentinel id, ``-0.0`` against ``+0.0``, C not
a multiple of 4, a dense wide merge); its visited bits against the JAX packed
branch's scatter-add. ``ops.beam_merge(..., visited=)`` on the CPU is held the
same way. ``chip_smoke.py`` holds the kernel itself against the plain version
on the card.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.beam_merge import beam_merge_pallas
from repro_torch.kernels import ops, ref
from test_torch_kernels import _merge_case, t

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "beam_merge.cu").read_text()


def constant(name: str) -> int:
    """An integer ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


PER_LANE = constant("kPerLane")
STEP = 32 * PER_LANE
WIDEST = 32 * constant("kMaxN")      # the widest P; a wider beam goes in chunks
EMPTY, INT_MAX = -2 ** 31, 2 ** 31 - 1
NONE = 2 ** 64 - 1
NAMES = ("ids", "d", "exp", "keep")


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def merge_width(L: int) -> int:
    return min(next_pow2(max(L, 32)), WIDEST)


def hash_slots(F: int) -> int:
    return next_pow2(F + F // 4 + 1)


def test_host_layout_is_the_sources():
    """The emulation's widths are the kernel's: the same expressions."""
    assert "next_pow2(L < 32 ? 32 : L)" in SOURCE
    assert "next_pow2(F + F / 4 + 1)" in SOURCE
    assert "hash_slots(__reduce_add_sync(kFull, finite))" in SOURCE   # sized per row
    assert "2654435761u" in SOURCE


def key(d) -> int:
    """``mono_key``: -0.0 as +0.0, then the order-isomorphic uint32."""
    bits = int(np.float32(np.float32(d) + np.float32(0.0)).view(np.uint32))
    return (~bits & 0xFFFFFFFF) if bits >> 31 else bits | 0x80000000


def pair(d, e: int) -> int:
    return key(d) << 32 | e


def bitonic_step(a: list, k: int, j: int) -> None:
    """One compare-exchange stage of the kernel's ``bitonic_step``: pairs
    (i, i + j) with bit j of i clear; ascending where bit k of i is clear
    (k = 0: all ascending). Lanes touch disjoint pairs."""
    for i in range(len(a)):
        if i & j:
            continue
        x, y = a[i], a[i + j]
        up = k == 0 or (i & k) == 0
        a[i], a[i + j] = (min(x, y), max(x, y)) if up else (max(x, y), min(x, y))


def bitonic_sort(a: list, width: int) -> None:
    """The kernel's ``warp_sort`` of the first ``width`` pairs."""
    head = a[:width]
    k = 2
    while k <= width:
        j = k >> 1
        while j > 0:
            bitonic_step(head, k, j)
            j >>= 1
        k <<= 1
    a[:width] = head


def sort_live(a: list, live: int) -> None:
    """``warp_sort_live``: only the narrowest prefix of 32·2^m pairs that
    holds the ``live`` ones is sorted; the rest is all ``NONE``."""
    width = 32
    while width < min(live, len(a)):
        width <<= 1
    bitonic_sort(a, min(width, len(a)))


def fold(a: list, b: list) -> list:
    """``warp_fold``: the least of a[i] and b[P-1-i] (a bitonic sequence),
    then the bitonic merge stages j = P/2 .. 1, ascending."""
    P = len(a)
    out = [min(a[i], b[P - 1 - i]) for i in range(P)]
    j = P >> 1
    while j > 0:
        bitonic_step(out, 0, j)
        j >>= 1
    return out


def hash_insert(table: list, H: int, ident: int) -> bool:
    """``hash_insert``: True when the id was not in the table yet."""
    if ident == EMPTY:
        new, table[H] = table[H] == 0, 1
        return new
    s = ((ident & 0xFFFFFFFF) * 2654435761 & 0xFFFFFFFF) >> (32 - (H.bit_length() - 1))
    while True:
        if table[s] == EMPTY:
            table[s] = ident
            return True
        if table[s] == ident:
            return False
        s = (s + 1) & (H - 1)


def compact(flags: dict, lanes: int = 32, per_lane: int = PER_LANE) -> list:
    """Ordered compaction by one ballot per k: lane l's slot is the count of
    set flags of lower lanes (every k), then its own in k order. ``flags``
    maps (lane, k) to an item; returns the items in slot order."""
    ballots = [{lane for lane in range(lanes) if (lane, k) in flags} for k in range(per_lane)]
    out = [None] * len(flags)
    for lane in range(lanes):
        at = sum(len([x for x in m if x < lane]) for m in ballots)
        for k in range(per_lane):
            if (lane, k) in flags:
                out[at] = flags[(lane, k)]
                at += 1
    return out


def emulate_row(beam_d, beam_ids, beam_exp, cand_d, cand_ids, n, visited=None, seed=0):
    """One row through the kernel's steps. Returns the outputs and what the
    row went through (sorted beam, live and surviving candidates, batches)."""
    rng = np.random.default_rng(seed)
    L, C = len(beam_d), len(cand_d)
    P, H = merge_width(L), hash_slots(int(np.isfinite(cand_d).sum()))   # sized per row

    # 1. the beam, 32 entries a ballot (past P only its largest pair)
    sorted_, last, thr = True, 0, 0
    for i0 in range(0, L, 32):
        ks = [key(beam_d[i]) if i < L else 0xFFFFFFFF for i in range(i0, i0 + 32)]
        prev = [last] + ks[:-1]
        sorted_ = all(p <= k for p, k in zip(prev, ks)) and sorted_
        last = ks[-1]
        thr = max([thr] + [pair(beam_d[i], i) for i in range(i0, min(i0 + 32, L))])

    # 2a. the live candidates (not +inf), listed in index order
    first_nf, lst = INT_MAX, []
    for c0 in range(0, C, STEP):
        live = {}
        for lane in range(32):
            for k in range(PER_LANE):
                j = c0 + PER_LANE * lane + k
                if j < C and not np.isfinite(cand_d[j]):
                    first_nf = min(first_nf, j)
                if j < C and cand_d[j] != np.inf:
                    live[(lane, k)] = j
        lst += compact(live)
    live_count = len(lst)

    # 2b. dedup rounds of 32: the lowest lane of each id in a round is its
    # first there, new unless an earlier round inserted it
    table = [EMPTY] * H + [0]
    keep = np.zeros(C, bool)
    survivors = []
    for r0 in range(0, len(lst), 32):
        rnd = lst[r0:r0 + 32]
        fin = [bool(np.isfinite(cand_d[j])) for j in rnd]
        leader = [f and all(not (fin[x] and cand_ids[rnd[x]] == cand_ids[j]) for x in range(lane))
                  for lane, (j, f) in enumerate(zip(rnd, fin))]
        new = {}
        for lane in rng.permutation(len(rnd)):       # the inserts, in any order
            if leader[lane]:
                new[lane] = hash_insert(table, H, int(cand_ids[rnd[lane]]))
        for lane, j in enumerate(rnd):
            kept = leader[lane] and new[lane] and not (cand_ids[j] == n and first_nf < j)
            keep[j] = kept
            if kept and visited is not None:
                v = min(max(int(cand_ids[j]), 0), n - 1)
                visited[v >> 5] |= np.uint32(1 << (v & 31))
            if (kept or not fin[lane]) and pair(cand_d[j], L + j) < thr:
                survivors.append(j)

    if L > P:
        merged, batches = wide_select(beam_d, cand_d, survivors, P)   # no sortedness used
    else:
        merged, batches = select(beam_d, cand_d, survivors, P, sorted_)
    out_ids = np.empty(L, np.int32)
    out_d = np.empty(L, np.float32)
    out_exp = np.empty(L, bool)
    for s in range(L):
        e = merged[s] & 0xFFFFFFFF
        if e < L:
            out_ids[s], out_d[s], out_exp[s] = beam_ids[e], beam_d[e], beam_exp[e]
        else:
            dj = cand_d[e - L]
            out_ids[s], out_d[s], out_exp[s] = cand_ids[e - L], dj, not np.isfinite(dj)
    info = {"sorted": sorted_, "live": live_count, "listed": len(survivors), "batches": batches,
            "finite": int(np.isfinite(cand_d).sum())}
    return (out_ids, out_d, out_exp, keep), info


def select(beam_d, cand_d, survivors, P, sorted_):
    """Steps 3-4 for L <= P: the survivors' best P, then the fold with the
    beam's pairs. Returns the merged pairs and the survivor batches."""
    L = len(beam_d)
    # 3. the best P survivors, batch by batch
    best, batches = None, 0
    for s0 in range(0, len(survivors), P):
        part = [pair(cand_d[j], L + j) for j in survivors[s0:s0 + P]]
        part += [NONE] * (P - len(part))
        sort_live(part, len(survivors) - s0)
        batches += 1
        best = part if best is None else fold(best, part)
    if best is None:
        best = [NONE] * P

    # 4. the beam's pairs, sorted if they were not, folded with the survivors
    bm = [pair(beam_d[i], i) for i in range(L)] + [NONE] * (P - L)
    if not sorted_:
        bitonic_sort(bm, P)
    return fold(best, bm), batches


def wide_select(beam_d, cand_d, survivors, P):
    """Steps 3-4 for L > P: the output P slots a chunk; each chunk the best
    P of the pairs above the last chunk's largest, from batches of P of the
    beam's pairs and then the survivors, each batch sorted at full width and
    folded. Returns the merged pairs and the batches sorted."""
    L = len(beam_d)
    pool = [pair(beam_d[i], i) for i in range(L)] + [pair(cand_d[j], L + j) for j in survivors]
    merged, lo, batches = [], 0, 0
    for s0 in range(0, L, P):
        best = None
        for t0 in range(0, len(pool), P):
            part = [p if s0 == 0 or p > lo else NONE for p in pool[t0:t0 + P]]
            part += [NONE] * (P - len(part))
            bitonic_sort(part, P)
            batches += 1
            best = part if best is None else fold(best, part)
        merged += best[:min(P, L - s0)]
        lo = best[P - 1]
    return merged, batches


def emulate(case, n, visited=None):
    rows = [emulate_row(*(a[b] for a in case), n, None if visited is None else visited[b], seed=b)
            for b in range(case[0].shape[0])]
    outs = tuple(np.stack([r[0][i] for r in rows]) for i in range(4))
    return outs, [r[1] for r in rows]


def assert_bitwise(got, want, what=""):
    for g, w, name in zip(got, want, NAMES):
        g, w = np.asarray(g), np.asarray(w)
        if name == "d":
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def jax_oracle(case, n):
    return jref.beam_merge_ref(*map(jnp.asarray, case), n=n)


def shuffled(case, seed):
    """The same case with each row's beam in a random order."""
    rng = np.random.default_rng(seed)
    beam_d, beam_ids, beam_exp = (a.copy() for a in case[:3])
    for b in range(beam_d.shape[0]):
        p = rng.permutation(beam_d.shape[1])
        beam_d[b], beam_ids[b], beam_exp[b] = beam_d[b, p], beam_ids[b, p], beam_exp[b, p]
    return (beam_d, beam_ids, beam_exp) + tuple(case[3:])


MATRIX = [
    (3, 64, 88, 4000, False, False),   # bench shape
    (2, 48, 17, 100, False, False),    # L and C not powers of two
    (1, 7, 3, 10, True, False),        # tiny, tie-heavy
    (2, 32, 40, 40, True, False),      # heavy duplicate ids + tied dists
    (2, 16, 8, 50, False, True),       # all-inf candidate set
    (2, 96, 352, 65000, False, False), # wide-beam / multi-expand scale
]


@pytest.mark.parametrize("b,l,c,n,tie,all_inf", MATRIX)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulation_matches_the_jax_oracle(b, l, c, n, tie, all_inf, seed):
    """``test_torch_kernels.py``'s merge matrix: the kernel's steps give the
    stable-sort oracle's outputs bit for bit, and the Pallas kernel's."""
    case = _merge_case(b, l, c, n, seed, tie, all_inf)
    got, info = emulate(case, n)
    assert all(i["sorted"] for i in info)
    assert_bitwise(got, jax_oracle(case, n), "oracle")
    assert_bitwise(got, beam_merge_pallas(*map(jnp.asarray, case), n=n, interpret=True), "pallas")


@pytest.mark.parametrize("b,l,c,n,tie,all_inf", MATRIX)
def test_unsorted_beam(b, l, c, n, tie, all_inf):
    """A beam in any order takes the sorting route and still gives the
    oracle's outputs (the Pallas kernel assumes a sorted beam, so it is not
    asked); the port's plain version agrees too."""
    case = shuffled(_merge_case(b, l, c, n, 7, tie, all_inf), 8)
    want = jax_oracle(case, n)
    got, info = emulate(case, n)
    if l > 1 and not tie:
        assert not any(i["sorted"] for i in info)
    assert_bitwise(got, want, "emulation")
    assert_bitwise([x.numpy() for x in ops.beam_merge(*map(t, case), n=n)], want, "ops")


def dense_case(b, l, c, n, finite, seed):
    """Distinct-ish random distances, ``finite`` of the candidates finite,
    a sorted beam whose upper half is +inf."""
    rng = np.random.default_rng(seed)
    beam_d = np.sort(rng.random((b, l)).astype(np.float32) * 400, axis=1)
    beam_d[:, l // 2:] = np.inf
    beam_ids = rng.integers(0, n, size=(b, l)).astype(np.int32)
    beam_ids[np.isinf(beam_d)] = -1
    beam_exp = rng.random((b, l)) < 0.5
    cand_d = rng.random((b, c)).astype(np.float32) * 400
    cand_d[rng.random((b, c)) >= finite] = np.inf
    cand_ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    return beam_d, beam_ids, beam_exp, cand_d, cand_ids


@pytest.mark.parametrize("l,c,finite,many", [
    (16, 200, 0.9, True),     # F_c > L: several batches
    (32, 300, 0.7, True),
    (64, 40, 0.5, False),     # F_c < L: one batch
    (48, 720, 0.02, False),   # the search's sparse candidates
    (128, 1440, 0.7, True),   # the dense wide merge
])
def test_survivors_more_or_fewer_than_L(l, c, finite, many):
    case = dense_case(2, l, c, 5000, finite, seed=l + c)
    got, info = emulate(case, 5000)
    assert_bitwise(got, jax_oracle(case, 5000))
    assert all((i["batches"] > 1) == many for i in info), info
    assert all(i["listed"] <= i["finite"] for i in info)


@pytest.mark.parametrize("l,c,finite,order", [
    (WIDEST + 1, 40, 0.5, "sorted"),     # one slot past the registers
    (2 * 300, 1440, 0.7, "sorted"),      # the wide search of a beam-300 batch
    (2 * WIDEST + 76, 300, 0.9, "shuffled"),   # three chunks, a beam in any order
    (WIDEST + 8, 700, 0.0, "ties"),      # few distinct distances and ids
])
def test_a_beam_wider_than_the_registers(l, c, finite, order):
    """L > 32·kMaxN: the output is built P slots a chunk from the beam's
    pairs and the survivors, and is still the oracle's bit for bit."""
    if order == "ties":
        case = _merge_case(2, l, c, 2000, seed=l, tie_heavy=True)
    else:
        case = dense_case(2, l, c, 5000, finite, seed=l + c)
    if order == "shuffled":
        case = shuffled(case, l)
    n = 2000 if order == "ties" else 5000
    got, info = emulate(case, n)
    assert_bitwise(got, jax_oracle(case, n))
    chunks = -(-l // WIDEST)
    assert all(i["batches"] == chunks * -(-(l + i["listed"]) // WIDEST) for i in info), info


def test_full_finite_beam_prunes_against_its_last_entry():
    """An all-finite ascending beam: only candidates below its last entry
    are listed, and a tie with that entry is not (the beam wins the tie)."""
    l, c = 32, 256
    beam_d, beam_ids, beam_exp, cand_d, cand_ids = dense_case(3, l, c, 1000, 0.8, seed=11)
    beam_d = np.sort(np.random.default_rng(12).random((3, l)).astype(np.float32) * 200, axis=1)
    beam_ids = np.arange(3 * l, dtype=np.int32).reshape(3, l)
    cand_d[:, 0] = beam_d[:, -1]                 # an exact tie with the L-th entry
    cand_ids[:, 0] = 999
    case = (beam_d, beam_ids, beam_exp, cand_d, cand_ids)
    got, info = emulate(case, 1000)
    want = jax_oracle(case, 1000)
    assert_bitwise(got, want)
    kept = np.asarray(want[3])
    for b, i in enumerate(info):
        assert i["listed"] == int(np.sum(kept[b] & (cand_d[b] < beam_d[b, -1])))
    assert not np.any(got[0] == 999)


def test_sentinel_id_after_an_infinite_candidate():
    """``dedup_mask`` keys a non-finite candidate as ``n``: a finite
    candidate with id ``n`` is a duplicate after one, and kept before."""
    n = 50
    beam_d = np.array([[1.0, 2.0, np.inf, np.inf]], np.float32)
    beam_ids = np.array([[3, 4, -1, -1]], np.int32)
    beam_exp = np.array([[True, False, False, False]])
    cand_d = np.array([[0.5, np.inf, 0.25, 0.75, -np.inf, 0.1]], np.float32)
    cand_ids = np.array([[n, 7, n, 9, 11, n]], np.int32)
    only_sentinel = (np.array([[np.inf, 0.5, 0.25]], np.float32), np.array([[7, n, 9]], np.int32))
    for case in ((beam_d, beam_ids, beam_exp, cand_d, cand_ids),
                 (beam_d, beam_ids, beam_exp, cand_d[:, 2:], cand_ids[:, 2:]),
                 (beam_d, beam_ids, beam_exp) + only_sentinel):
        got, _ = emulate(case, n)
        want = jax_oracle(case, n)
        assert_bitwise(got, want)
        assert_bitwise([x.numpy() for x in ops.beam_merge(*map(t, case), n=n)], want)
    # the id n after an infinite candidate, with no earlier finite n: dropped
    assert got[3].tolist() == [[False, False, True]]
    got, _ = emulate((beam_d, beam_ids, beam_exp, cand_d, cand_ids), n)
    assert got[3].tolist() == [[True, False, False, True, False, False]]
    # the -inf candidate ranks first, not kept: expanded flag set
    assert got[1][0, 0] == -np.inf and got[2][0, 0]


def test_negative_zero_ties_positive_zero():
    """-0.0 and +0.0 share a key: ties go by concat index, beam first, and
    each output keeps its own sign bit."""
    beam_d = np.array([[-0.0, 0.0, 1.0, np.inf]], np.float32)
    beam_ids = np.array([[1, 2, 3, -1]], np.int32)
    beam_exp = np.zeros((1, 4), bool)
    cand_d = np.array([[0.0, -0.0, 0.0, -0.0, 1.0]], np.float32)
    cand_ids = np.array([[10, 11, 12, 13, 14]], np.int32)
    case = (beam_d, beam_ids, beam_exp, cand_d, cand_ids)
    got, info = emulate(case, 100)
    assert info[0]["sorted"]
    assert_bitwise(got, jax_oracle(case, 100))
    assert got[0].tolist() == [[1, 2, 10, 11]]
    assert np.signbit(got[1][0]).tolist() == [True, False, False, True]


@pytest.mark.parametrize("c", [1, 3, 5, 127, 129, 130, 255, 257])
def test_candidates_not_a_multiple_of_the_load(c):
    """C off the 16-byte load and off the 128-candidate step: the ragged
    lane and step are masked."""
    case = _merge_case(2, 24, c, 300, seed=c, tie_heavy=c % 2 == 1)
    got, _ = emulate(case, 300)
    assert_bitwise(got, jax_oracle(case, 300))


def test_duplicates_across_steps_keep_the_first():
    """The same id in several 128-candidate steps and lanes: only its first
    finite occurrence is kept, whatever order the inserts land in."""
    c = 3 * STEP + 7
    cand_ids = (np.arange(c) % 37).astype(np.int32)[None]
    cand_d = np.random.default_rng(3).random((1, c)).astype(np.float32)
    cand_d[0, :20] = np.inf                      # ids 0..19 first seen later
    beam = (np.full((1, 8), np.inf, np.float32), np.full((1, 8), -1, np.int32), np.zeros((1, 8), bool))
    case = beam + (cand_d, cand_ids)
    for seed in range(3):
        got = emulate_row(*(a[0] for a in case), 37, seed=seed)[0]
        assert_bitwise([x[None] for x in got], jax_oracle(case, 37))
    assert int(got[3].sum()) == 37


def jax_packed_bits(visited, nb, keep, n):
    """The JAX packed branch's bitmap update (``search/batched.py:236-243``)."""
    B, ME = nb.shape
    ids_safe = jnp.clip(nb, 0, n - 1)
    rows = jnp.broadcast_to(jnp.arange(B)[:, None], (B, ME))
    bits = jnp.where(keep, jnp.uint32(1) << (ids_safe & 31).astype(jnp.uint32), jnp.uint32(0))
    return visited.at[rows, ids_safe >> 5].add(bits)


@pytest.mark.parametrize("b,l,c,n,tie,all_inf", MATRIX)
def test_visited_bits_match_the_jax_packed_branch(b, l, c, n, tie, all_inf):
    """``ops.beam_merge(..., visited=v)`` on the CPU: the same outputs, and
    ``v`` bitwise the JAX packed branch's bitmap after its update."""
    case = _merge_case(b, l, c, n, 5, tie, all_inf)
    rng = np.random.default_rng(c)
    vis = rng.integers(0, 2 ** 32, size=(b, (n + 31) // 32), dtype=np.uint64).astype(np.uint32)
    v = t(vis.copy())
    got = ops.beam_merge(*map(t, case), n=n, visited=v)
    want = jax_oracle(case, n)
    assert_bitwise([x.numpy() for x in got], want)
    bits = jax_packed_bits(jnp.asarray(vis), jnp.asarray(case[4]), want[3], n)
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(bits))


@pytest.mark.parametrize("b,l,c,n,tie,all_inf", MATRIX)
def test_emulated_or_equals_the_add_on_unvisited_ids(b, l, c, n, tie, all_inf):
    """The kernel sets a kept id's bit with an or; where the kept ids are
    valid and unvisited, as the scorer leaves them, that is the reference's
    add, bit for bit."""
    case = list(_merge_case(b, l, c, n, 6, tie, all_inf))
    case[4] = np.clip(case[4], 0, n - 1)
    W = (n + 31) // 32
    vis = np.random.default_rng(l).integers(0, 2 ** 32, size=(b, W), dtype=np.uint64).astype(np.uint32)
    want = jax_oracle(tuple(case), n)
    kept = np.asarray(want[3])
    for row in range(b):                          # clear the kept ids' bits
        for v in case[4][row][kept[row]]:
            vis[row, v >> 5] &= ~np.uint32(1 << (v & 31))
    emulated = vis.copy()
    got, _ = emulate(tuple(case), n, visited=emulated)
    assert_bitwise(got, want)
    np.testing.assert_array_equal(
        emulated, np.asarray(jax_packed_bits(jnp.asarray(vis), jnp.asarray(case[4]), want[3], n)))
    v = t(vis.copy())
    ref.set_bits(v, t(case[4]), torch.from_numpy(kept), n)
    np.testing.assert_array_equal(v.numpy().view(np.uint32), emulated)


def test_merge_without_visited_leaves_no_bitmap():
    """The int32, broad and unfused branches and ``topk_merge`` pass no
    bitmap: the plain version then only merges."""
    case = _merge_case(2, 16, 30, 64, seed=9)
    a = ops.beam_merge(*map(t, case), n=64)
    b = ops.beam_merge(*map(t, case), n=64, visited=None)
    assert_bitwise([x.numpy() for x in a], [x.numpy() for x in b])


def test_the_hash_always_has_a_free_slot():
    """At most 0.8 full for any finite count, so the probe of step 2b ends."""
    for c in list(range(0, 3000, 7)) + [720, 1440, 4096]:
        assert hash_slots(c) >= 1.25 * c


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # main() runs only as a script
    return mod


def test_an_earlier_merge_build_gets_no_bitmap():
    """``chip_smoke --form`` calls a build without ``beam_merge_abi`` with
    the bitmap and its width left out, and refuses to hand it a bitmap."""
    cs = load_chip_smoke()

    class Lib:
        def beam_merge(self, *a):
            return a

    lib = cs._WithoutVisited(Lib())
    head = tuple(range(9))
    tail = ("ids", "d", "exp", "keep", "stream")
    assert lib.beam_merge(*head, None, 7, *tail) == head + tail
    with pytest.raises(AssertionError, match="bitmap"):
        lib.beam_merge(*head, 12345, 7, *tail)


def test_b2_form_sets_the_bits_after_an_earlier_build(monkeypatch):
    """Inside ``b2_form`` of an earlier build, ``ops.beam_merge(visited=)``
    merges without the bitmap and sets the bits with ``ref.set_bits``, as
    the fused call does; ``ops.beam_merge`` is restored after."""
    from repro_torch.kernels import _build

    cs = load_chip_smoke()
    monkeypatch.setitem(_build._libs, "beam_merge", object())
    case = _merge_case(3, 16, 40, 200, seed=2)
    vis = np.random.default_rng(0).integers(0, 2 ** 32, size=(3, 7), dtype=np.uint64).astype(np.uint32)
    fused, earlier = t(vis.copy()), t(vis.copy())
    want = ops.beam_merge(*map(t, case), n=200, visited=fused)
    merge = ops.beam_merge
    with cs.b2_form(cs._WithoutVisited(object())):
        assert ops.beam_merge is not merge
        got = ops.beam_merge(*map(t, case), n=200, visited=earlier)
    assert ops.beam_merge is merge
    assert_bitwise([x.numpy() for x in got], [x.numpy() for x in want])
    np.testing.assert_array_equal(earlier.numpy(), fused.numpy())


@pytest.mark.parametrize("words", [0, 5])
def test_merge_bound_against_a_hand_count(words):
    """B2's bound counts what this input needs: every beam distance and
    candidate distance, the 32-byte sectors of ids and flags of the beam
    entries that reach the output and of the ids of the live candidates,
    every output once, 8 bytes a visited word; compares over the beam and
    the live candidates."""
    cs = load_chip_smoke()
    B, L, C, n = 2, 4, 20, 100
    inf = float("inf")
    beam_d = torch.tensor([[1.0, 2.0, 3.0, inf], [0.5, 0.6, 0.7, 0.8]])
    beam_ids = torch.tensor([[1, 2, 3, -1], [4, 5, 6, 7]], dtype=torch.int32)
    beam_exp = torch.zeros((B, L), dtype=torch.bool)
    cand_d = torch.full((B, C), inf)
    cand_ids = torch.arange(B * C, dtype=torch.int32).view(B, C)
    cand_d[0, 0], cand_d[0, 9] = 0.1, 0.2          # row 0: two live, ids in sectors 0, 1
    cand_d[1, 3], cand_d[1, 5] = 0.3, -inf         # row 1: elements 23, 25: sectors 2, 3
    cand_d[1, 19] = 0.9                            # element 39: sector 4
    args = (beam_d, beam_ids, beam_exp, cand_d, cand_ids)
    assert all(x.data_ptr() % 32 == 0 for x in (cand_ids, beam_ids, beam_exp))
    keep = ref.beam_merge_ref(*args, n=n)[3]
    # row 0 keeps 0.1, 0.2: beam 1.0, 2.0 reach the output; row 1: -inf,
    # 0.3 and beam 0.5, 0.6. Beam ids are elements 0, 1, 4, 5: one sector,
    # and the flags one sector
    got = cs.merge_bound(args, keep, words)
    nbytes = (B * L * 4 + B * C * 4 + 32 * 5 + 32 + 32) + B * (9 * L + C) + 8 * words
    ops_ = (B * L + 5) * 5                         # ceil(log2(24)) = 5
    want = max(nbytes / cs.HBM_BYTES_PER_S, ops_ / cs.CMP_OPS_PER_S) * 1e3
    assert got["bound_bytes"] == nbytes
    assert got["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert got["id_sectors"] == 5 and got["beam_sectors"] == 2
