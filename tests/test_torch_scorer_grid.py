"""Host-side logic of the gather scorers (B1, B3) and of their bounds in
``chip_smoke.py``; all on the CPU, no ``nvcc``.

* ``ops.scorer_tile`` picks the candidates per block. The kernel
  (``csrc/filter_dist.cu``, ``filter_dist_kernel``) maps block x of
  ``B · ceil(C / tile)`` to query ``x // tiles`` and candidates
  ``[j0, min(j0 + tile, C))``, thread t of 256 testing ``j0 + t + 256·i`` for
  i < 3 (both read from the source): every (query, candidate) must be tested
  exactly once, and the grid must hold several blocks per SM at the
  constructor's small batches.
* ``chip_smoke.scorer_bound``'s re-read floor (``pair_bytes``) against a count
  by hand.
* What ``chip_smoke.py --form`` rests on: ``_build.swapped`` puts the
  committed build back, and an earlier build's gather entry points are called
  without the tile.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "filter_dist.cu").read_text()


def constant(name: str) -> int:
    """An integer ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, PER_THREAD = constant("kWarps") * 32, constant("kPerThread")


def coverage(C: int, tile: int) -> np.ndarray:
    """How often the kernel's blocks of one query test each candidate."""
    seen = np.zeros(C, dtype=np.int64)
    for j0 in range(0, C, tile):
        j1 = min(j0 + tile, C)
        for i in range(PER_THREAD):
            j = j0 + np.arange(THREADS) + i * THREADS
            np.add.at(seen, j[j < j1], 1)
    return seen


@pytest.mark.parametrize("C", [1, 31, 33, 256, 512, 720, 767, 768, 769, 1000, 1440, 2049])
@pytest.mark.parametrize("B", [1, 16, 256, 4096])
@pytest.mark.parametrize("sms", [1, 132])
def test_scorer_tile_covers_every_candidate_once(B, C, sms):
    tile = ops.scorer_tile(B, C, sms)
    assert 32 <= tile <= ops.SCORER_MAX_TILE == THREADS * PER_THREAD
    assert tile % 32 == 0
    assert np.all(coverage(C, tile) == 1)


@pytest.mark.parametrize("B, C, blocks", [
    (4096, 720, 4096),      # B1, M = 1: one block a query
    (4096, 1440, 8192),     # B1, M = 2
    (4096, 256, 4096),      # B3, the brute scan
    (256, 512, 1024),       # B3, the wave constructor's broad search
    (1, 720, 12),           # one query: blocks of 64 candidates
])
def test_scorer_tile_fills_the_card(B, C, blocks):
    tile = ops.scorer_tile(B, C, 132)
    assert B * -(-C // tile) == blocks


def test_max_tile_is_the_kernels():
    assert re.search(r"constexpr int kMaxTile = kWarps \* 32 \* kPerThread;", SOURCE)
    assert ops.SCORER_MAX_TILE == THREADS * PER_THREAD
    assert re.search(r'extern "C" int filter_dist_max_tile\(\) \{ return kMaxTile; \}', SOURCE)


def test_scorer_tile_without_work():
    assert ops.scorer_tile(0, 720, 132) == ops.scorer_tile(16, 0, 132) == 32


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # main() runs only as a script
    return mod


@pytest.mark.parametrize("scaled", [False, True])
def test_pair_bytes_against_a_hand_count(scaled):
    cs = load_chip_smoke()
    inf = float("inf")
    # 2 queries x 4 slots; query 0 scores rows 5, 5 (the same row twice)
    # and 7; query 1 scores row 5; the rest are +inf (padding or failed)
    cand = torch.tensor([[5, 5, 7, -1], [5, 9, -1, 3]], dtype=torch.int32)
    out = torch.tensor([[1.0, 1.0, 2.0, inf], [3.0, inf, inf, inf]])
    D, elt = 6, 4
    got = cs.scorer_bound(out, out, cand, torch.arange(8).view(2, 4), D=D, elt=elt,
                          scaled=scaled, label_bytes=16, per_query=D * 4 + 8)
    row = D * elt + 4 + (4 if scaled else 0)        # row, norm, scale
    want = 4 * row + 2 * 4 * (4 + 4)                # 4 scored slots; every id and output
    assert got["pair_bytes"] == want
    assert got["pair_floor_ms"] == pytest.approx(want / cs.HBM_BYTES_PER_S * 1e3)
    # the bound reads each distinct scored row once: rows 5 and 7
    assert got["rows_read"] == 2 and got["scored"] == 3 and got["words_read"] == 2
    assert got["bound_bytes"] == (2 * 4 * 8 + 6 * 16 + got["words_read"] * 4
                                  + 2 * row + 2 * (D * 4 + 8))


def test_swapped_restores_the_library(monkeypatch):
    from repro_torch.kernels import _build

    built, other = object(), object()
    monkeypatch.setitem(_build._libs, "filter_dist", built)
    with pytest.raises(KeyError):
        with _build.swapped("filter_dist", other):
            assert _build.library("filter_dist") is other
            raise KeyError("inside")
    assert _build.library("filter_dist") is built


def test_without_tile_drops_the_tile_argument():
    cs = load_chip_smoke()

    class Lib:
        def filter_dist_gather(self, *a):
            return a

        def filter_dist_dense(self, *a):
            return a

    lib = cs._WithoutTile(Lib())
    assert lib.filter_dist_gather(1, 2, "vec", "tile", "out", "stream") == (1, 2, "vec", "out", "stream")
    assert lib.filter_dist_dense(1, 2, 3) == (1, 2, 3)
