"""Kernel wrappers of the port.

Same names and signatures as the JAX package's ``kernels/ops.py`` (minus
``use_ref``). Each op dispatches on where its tensors lie:

* all on the CPU -> the plain PyTorch version in ``ref``;
* all on one CUDA device -> the hand-written kernel in ``csrc/``, launched on
  the current stream, or ``RuntimeError`` (a failed build, a refused launch,
  a tensor of the wrong type, shape or layout). There is no fallback.

``LAUNCHES`` counts kernel launches per kernel, incremented only where a
kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

quantize_int8 = ref.quantize_int8

LAUNCHES = {
    "filter_dist_gather_packed": 0, "beam_merge": 0, "filter_dist_gather": 0,
    "filter_dist": 0, "l2dist": 0, "int8_l2dist": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU; raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise RuntimeError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    return True


def _check(t, name, dtype, shape):
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise RuntimeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise RuntimeError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise RuntimeError(f"{name}: must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


# The gather scorers' grid: a block of 8 warps tests up to 768 candidates of
# one query, 3 a thread. Equal to csrc/filter_dist.cu's kMaxTile, which the
# library reports as filter_dist_max_tile() (chip_smoke.py checks the two).
SCORER_MAX_TILE = 768
BLOCKS_PER_SM = 8                  # blocks the tile aims for on every SM


def scorer_tile(B: int, C: int, sms: int) -> int:
    """Candidates per block for ``B`` queries of ``C`` candidates on a card
    of ``sms`` SMs: a multiple of 32, at most ``SCORER_MAX_TILE``, small
    enough that the ``B · ceil(C / tile)`` blocks give every SM about
    ``BLOCKS_PER_SM`` of them (down to 64 candidates a block), and as large
    as that allows, so each query's fixed costs are paid by few blocks."""
    if B <= 0 or C <= 0:
        return 32
    cdiv = lambda x, y: -(-x // y)           # noqa: E731
    per_query = max(cdiv(C, SCORER_MAX_TILE),
                    min(cdiv(BLOCKS_PER_SM * sms, B), cdiv(C, 64)))
    return min(SCORER_MAX_TILE, cdiv(cdiv(C, per_query), 32) * 32)


_SMS: dict = {}


def _sm_count(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _table_args(table, norms, scales, q):
    """Checks shared by both scorers; returns (n, D, is_int8, vec)."""
    n, D = table.shape
    B = q.shape[0]
    _check(table, "table", (torch.float32, torch.int8), (n, D))
    _check(norms, "norms", torch.float32, (n,))
    if scales is not None:
        _check(scales, "scales", torch.float32, (n,))
    _check(q, "q", torch.float32, (B, D))
    is_int8 = table.dtype == torch.int8
    width = 16 if is_int8 else 4     # elements per 16-byte load
    vec = int(D % width == 0 and table.data_ptr() % 16 == 0)
    return n, D, int(is_int8), vec


def filter_dist(
    q: torch.Tensor,          # [B, D] f32
    cand: torch.Tensor,       # [B, E, D] f32 pre-gathered candidate rows
    labels: torch.Tensor,     # [B, E, 4] int32
    state: torch.Tensor,      # [B, 2] int32
    cand_ids: torch.Tensor,   # [B, E] int32 (-1 = padding)
) -> torch.Tensor:
    """Label test + squared distance ``[B, E]`` over a dense candidate
    tensor, ``‖c‖²`` recomputed from each row (+inf = inactive); bitwise
    equal to ``ref.filter_dist_ref``."""
    if not _on_cuda(q, cand, labels, state, cand_ids):
        return ref.filter_dist_ref(q, cand, labels, state, cand_ids)
    B, E, D = cand.shape
    _check(q, "q", torch.float32, (B, D))
    _check(cand, "cand", torch.float32, (B, E, D))
    _check(labels, "labels", torch.int32, (B, E, 4))
    _check(state, "state", torch.int32, (B, 2))
    _check(cand_ids, "cand_ids", torch.int32, (B, E))
    vec = int(D % 4 == 0 and cand.data_ptr() % 16 == 0)
    out = torch.empty((B, E), dtype=torch.float32, device=q.device)
    rc = _build.library("filter_dist").filter_dist_dense(
        _ptr(q), _ptr(cand), B, E, D, _ptr(labels), _ptr(state),
        _ptr(cand_ids), vec, _ptr(out), _stream(q),
    )
    _raise_on(rc, "filter_dist")
    LAUNCHES["filter_dist"] += 1
    return out


def filter_dist_gather(
    table: torch.Tensor,      # [n, D] full vector table (f32 or int8)
    norms: torch.Tensor,      # [n] f32 cached ‖c‖² of the (dequantized) rows
    q: torch.Tensor,          # [B, D]
    cand_ids: torch.Tensor,   # [B, C] int32 candidate row ids (-1 = padding)
    labels: torch.Tensor,     # [B, C, 4] int32
    state: torch.Tensor,      # [B, 2] int32
    visited: torch.Tensor,    # [B, ceil(n/32)] int32 bit-packed visited set
    *,
    scales: torch.Tensor | None = None,   # [n] f32 int8 dequant scales
) -> torch.Tensor:
    """Gather-fused label + visited test + squared distance ``[B, C]``."""
    if not _on_cuda(table, norms, q, cand_ids, labels, state, visited, scales):
        return ref.filter_dist_gather_ref(
            table, norms, q, cand_ids, labels, state, visited, scales)
    n, D, is_int8, vec = _table_args(table, norms, scales, q)
    B, C = cand_ids.shape
    W = (n + 31) // 32
    _check(cand_ids, "cand_ids", torch.int32, (B, C))
    _check(labels, "labels", torch.int32, (B, C, 4))
    _check(state, "state", torch.int32, (B, 2))
    _check(visited, "visited", torch.int32, (B, W))
    out = torch.empty((B, C), dtype=torch.float32, device=q.device)
    rc = _build.library("filter_dist").filter_dist_gather(
        _ptr(table), is_int8, n, D, _ptr(norms), _ptr(scales), _ptr(q),
        _ptr(cand_ids), B, C, _ptr(labels), _ptr(state), _ptr(visited), W,
        vec, scorer_tile(B, C, _sm_count(q.device)), _ptr(out), _stream(q),
    )
    _raise_on(rc, "filter_dist_gather")
    LAUNCHES["filter_dist_gather"] += 1
    return out


def filter_dist_gather_packed(
    table: torch.Tensor,      # [n, D] full vector table (f32 or int8)
    plabels: torch.Tensor,    # [n, E, 2] int32 bit-packed label rectangles
    norms: torch.Tensor,      # [n] f32 cached ‖c‖² of the (dequantized) rows
    q: torch.Tensor,          # [B, D]
    cur_ids: torch.Tensor,    # [B, M] int32 expanded beam nodes
    cand_ids: torch.Tensor,   # [B, M*E] int32 candidate row ids (-1 = padding)
    state: torch.Tensor,      # [B, 2] int32
    visited: torch.Tensor,    # [B, ceil(n/32)] int32 bit-packed visited set
    *,
    scales: torch.Tensor | None = None,   # [n] f32 int8 dequant scales
) -> torch.Tensor:
    """Packed-label scorer ``[B, M·E]``: the label of candidate j is the word
    pair ``plabels[cur_ids[b, j // E], j % E]``, read inside the kernel."""
    if not _on_cuda(table, plabels, norms, q, cur_ids, cand_ids, state,
                    visited, scales):
        return ref.filter_dist_gather_packed_ref(
            table, plabels, norms, q, cur_ids, cand_ids, state, visited, scales)
    n, D, is_int8, vec = _table_args(table, norms, scales, q)
    B, M = cur_ids.shape
    E = plabels.shape[1]
    W = (n + 31) // 32
    _check(plabels, "plabels", torch.int32, (n, E, 2))
    _check(cur_ids, "cur_ids", torch.int32, (B, M))
    _check(cand_ids, "cand_ids", torch.int32, (B, M * E))
    _check(state, "state", torch.int32, (B, 2))
    _check(visited, "visited", torch.int32, (B, W))
    out = torch.empty((B, M * E), dtype=torch.float32, device=q.device)
    rc = _build.library("filter_dist").filter_dist_gather_packed(
        _ptr(table), is_int8, n, D, _ptr(norms), _ptr(scales), _ptr(q),
        _ptr(cur_ids), M, _ptr(cand_ids), B, M * E, _ptr(plabels), E,
        _ptr(state), _ptr(visited), W, vec, scorer_tile(B, M * E, _sm_count(q.device)),
        _ptr(out), _stream(q),
    )
    _raise_on(rc, "filter_dist_gather_packed")
    LAUNCHES["filter_dist_gather_packed"] += 1
    return out


def beam_merge(
    beam_d: torch.Tensor,     # [B, L] f32 ascending beam distances
    beam_ids: torch.Tensor,   # [B, L] int32 (-1 padding)
    beam_exp: torch.Tensor,   # [B, L] bool expanded flags
    cand_d: torch.Tensor,     # [B, C] f32 (+inf = dead candidate)
    cand_ids: torch.Tensor,   # [B, C] int32
    *,
    n: int,
    visited: torch.Tensor | None = None,   # [B, ceil(n/32)] int32 bitmap
):
    """Deduplicating top-L beam merge — ``(new_ids, new_d, new_exp, keep)``,
    bitwise equal to the stable-sort oracle ``ref.beam_merge_ref`` for any
    beam. With ``visited``, the kept candidates' bits
    are set in it in place, in the same launch (``ref.set_bits``: kept ids
    are distinct and were unvisited, so the kernel's or is the reference's
    add)."""
    if not _on_cuda(beam_d, beam_ids, beam_exp, cand_d, cand_ids, visited):
        return ref.beam_merge_ref(beam_d, beam_ids, beam_exp, cand_d, cand_ids,
                                  n=n, visited=visited)
    B, L = beam_d.shape
    C = cand_d.shape[1]
    W = (n + 31) // 32
    _check(beam_d, "beam_d", torch.float32, (B, L))
    _check(beam_ids, "beam_ids", torch.int32, (B, L))
    _check(beam_exp, "beam_exp", torch.bool, (B, L))
    _check(cand_d, "cand_d", torch.float32, (B, C))
    _check(cand_ids, "cand_ids", torch.int32, (B, C))
    if visited is not None:
        _check(visited, "visited", torch.int32, (B, W))
    dev = beam_d.device
    new_ids = torch.empty((B, L), dtype=torch.int32, device=dev)
    new_d = torch.empty((B, L), dtype=torch.float32, device=dev)
    new_exp = torch.empty((B, L), dtype=torch.bool, device=dev)
    keep = torch.empty((B, C), dtype=torch.bool, device=dev)
    rc = _build.library("beam_merge").beam_merge(
        _ptr(beam_d), _ptr(beam_ids), _ptr(beam_exp), _ptr(cand_d),
        _ptr(cand_ids), B, L, C, int(n), _ptr(visited), W, _ptr(new_ids),
        _ptr(new_d), _ptr(new_exp), _ptr(keep), _stream(beam_d),
    )
    _raise_on(rc, "beam_merge")
    LAUNCHES["beam_merge"] += 1
    return new_ids, new_d, new_exp, keep


_L2_TYPES = {torch.float32: 0, torch.float16: 1, torch.int8: 2}


def _l2dist(q, c, scales, name):
    Bq, D = q.shape
    Bc = c.shape[0]
    _check(q, "q", (torch.float32, torch.float16), (Bq, D))
    _check(c, "c", (torch.float32, torch.float16, torch.int8), (Bc, D))
    if scales is not None:
        _check(scales, "c_scale", torch.float32, (Bc,))
    out = torch.empty((Bq, Bc), dtype=torch.float32, device=q.device)
    rc = _build.library("l2dist").l2dist(
        _ptr(q), _L2_TYPES[q.dtype], _ptr(c), _L2_TYPES[c.dtype], _ptr(scales),
        Bq, Bc, D, _ptr(out), _stream(q),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def l2dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distance matrix ``[Bq, Bc]`` f32 of q ``[Bq, D]`` and
    c ``[Bc, D]`` (f32 or f16; computed in f32)."""
    if not _on_cuda(q, c):
        return ref.l2dist_ref(q, c)
    if q.dtype != c.dtype:      # one input type per launch
        q, c = q.float(), c.float()
    return _l2dist(q, c, None, "l2dist")


def int8_l2dist(
    q: torch.Tensor, c_q: torch.Tensor, c_scale: torch.Tensor
) -> torch.Tensor:
    """Squared-L2 ``[Bq, Bc]`` of f32 queries against int8 rows with one f32
    scale per row. The plain version dequantizes each row before the product;
    the CUDA kernel applies the scale once to the summed product, which is
    equal in exact arithmetic and within the distance-matrix tolerance
    (a departure logged in ROADMAP §C)."""
    if not _on_cuda(q, c_q, c_scale):
        return ref.int8_l2dist_ref(q, c_q, c_scale)
    if c_q.dtype != torch.int8:
        raise RuntimeError(f"c_q: dtype {c_q.dtype}, expected torch.int8")
    return _l2dist(q.float(), c_q, c_scale, "int8_l2dist")


def topk_merge(
    acc_d: torch.Tensor,      # [B, L] f32 ascending (+inf padding)
    acc_ids: torch.Tensor,    # [B, L] int32 (-1 padding)
    cand_d: torch.Tensor,     # [B, C] f32 (+inf = dead candidate)
    cand_ids: torch.Tensor,   # [B, C] int32
    *,
    n: int,
):
    """Fold a candidate block into a running ascending top-L — ``(ids, d)``:
    :func:`beam_merge` with no expanded flags. ``n`` is any bound strictly
    above every live id (the dedup sentinel)."""
    exp = torch.zeros(acc_ids.shape, dtype=torch.bool, device=acc_ids.device)
    new_ids, new_d, _, _ = beam_merge(acc_d, acc_ids, exp, cand_d, cand_ids, n=n)
    return new_ids, new_d


__all__ = [
    "LAUNCHES",
    "beam_merge",
    "filter_dist",
    "filter_dist_gather",
    "filter_dist_gather_packed",
    "int8_l2dist",
    "l2dist",
    "quantize_int8",
    "reset_launches",
    "topk_merge",
]
