"""Plain PyTorch versions of the port's kernels.

Twins of the JAX package's jnp oracles (``kernels/ref.py``,
``kernels/beam_merge.py``, ``kernels/int8dist.py``). They are what the
kernel wrappers in ``ops`` run on CPU tensors, and what ``chip_smoke.py``
holds each CUDA kernel against on the card.

Bit patterns that the reference keeps as uint32 (packed labels, the visited
bitmap) are int32 here: torch has no ``>>`` or ``index_add_`` for uint32.
An int32 shifts right arithmetically, so a bit is read as ``(w >> s) & 1``
and a 16-bit field as ``w & 0xFFFF`` / ``(w >> 16) & 0xFFFF``.
"""
from __future__ import annotations

import torch

INF = float("inf")
LANES = 32       # a warp


def warp_dot(x: torch.Tensor, y: torch.Tensor, width: int = 4) -> torch.Tensor:
    """``sum_d x[..., d] * y[..., d]`` over the last axis, summed in f64 in
    the order of the scorers' warps (``csrc/filter_dist.cu``, ``row_dot``)
    and rounded once to f32, so kernel and plain version agree to the bit.

    Lane ``l`` of 32 adds, one after another, the products of elements
    ``32·width·k + width·l + j`` for k = 0, 1, ... and j < ``width`` (the
    elements of one 16-byte load: 4 for f32 rows, 16 for int8 rows); then
    the lane sums are added as a butterfly (lane l with lane l + 16, then
    l + 8, ...). Every f32 or int8 product is exact in f64. x and y
    broadcast against each other (any real dtype); the temporaries are
    ``[..., 32]`` f64, a strided slice of the inputs at a time."""
    D = x.shape[-1]
    step = LANES * width
    lead = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    acc = torch.zeros(lead + (LANES,), dtype=torch.float64, device=x.device)
    for k0 in range(0, D, step):
        for j in range(width):
            cols = slice(k0 + j, min(k0 + step, D), width)   # lane l: k0 + width·l + j
            xs, ys = x[..., cols], y[..., cols]
            m = xs.shape[-1]
            if m:
                acc[..., :m] += xs.double() * ys.double()
    o = LANES // 2
    while o:
        acc = acc[..., :o] + acc[..., o:2 * o]
        o //= 2
    return acc[..., 0].float()


def filter_dist_ref(
    q: torch.Tensor,          # [B, D] query vectors
    cand: torch.Tensor,       # [B, E, D] pre-gathered candidate vectors
    labels: torch.Tensor,     # [B, E, 4] int32 label rectangles (l, r, b, e)
    state: torch.Tensor,      # [B, 2] int32 canonical rank state (a, c)
    cand_ids: torch.Tensor,   # [B, E] int32 (-1 = padding)
) -> torch.Tensor:
    """Label test + squared distance over a dense candidate tensor, ``[B, E]``
    f32: ``‖c‖² − 2·q·c + ‖q‖²`` with ``‖c‖²`` recomputed from the row, where
    the tuple is active for (a, c) and the id is >= 0; +inf otherwise.

    ``‖c‖²``, ``q·c`` and ``‖q‖²`` are each summed by :func:`warp_dot` (f64,
    the kernel's order, rounded once), then the f32 operations run one by
    one, as the kernel does them."""
    q = q.float()
    cand = cand.float()
    cs = warp_dot(cand, cand)
    cross = warp_dot(cand, q[:, None, :])
    qs = warp_dot(q, q)[:, None]
    dist = cs - 2.0 * cross + qs
    a = state[:, 0:1]
    cc = state[:, 1:2]
    ok = (
        (labels[..., 0] <= a)
        & (a <= labels[..., 1])
        & (labels[..., 2] <= cc)
        & (cc <= labels[..., 3])
        & (cand_ids >= 0)
    )
    return torch.where(ok, dist, torch.full_like(dist, INF))


def l2dist_ref(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix: q ``[Bq, D]``, c ``[Bc, D]`` (f32 or f16,
    computed in f32) -> ``[Bq, Bc]`` f32, ``‖q‖² − 2·q·cᵀ + ‖c‖²``."""
    q = q.float()
    c = c.float()
    qs = torch.sum(q * q, dim=-1, keepdim=True)
    cs = torch.sum(c * c, dim=-1)[None, :]
    return qs - 2.0 * (q @ c.T) + cs


def int8_l2dist_ref(
    q: torch.Tensor,        # [Bq, D] f32 queries
    c_q: torch.Tensor,      # [Bc, D] int8 quantized candidates
    c_scale: torch.Tensor,  # [Bc] f32 per-vector dequant scales
) -> torch.Tensor:
    """Squared L2 against int8 rows, each dequantized first (c ~ c_q·scale);
    the math is f32, as in the reference (no int8 product)."""
    return l2dist_ref(q, c_q.float() * c_scale[:, None])


def filter_dist_gather_ref(
    table: torch.Tensor,      # [n, D] full vector table (f32 or int8)
    norms: torch.Tensor,      # [n] f32 cached ‖c‖² (of the dequantized rows)
    q: torch.Tensor,          # [B, D] query vectors
    cand_ids: torch.Tensor,   # [B, C] int32 candidate row ids (-1 = padding)
    labels: torch.Tensor,     # [B, C, 4] int32 label rectangles (l, r, b, e)
    state: torch.Tensor,      # [B, 2] int32 canonical rank state (a, c)
    visited: torch.Tensor,    # [B, ceil(n/32)] int32 bit-packed visited set
    scales: torch.Tensor | None = None,   # [n] f32 int8 dequant scales
) -> torch.Tensor:
    """Gathers the candidate rows (the ``[B, C, D]`` intermediate the kernel
    avoids) and returns ``[B, C]`` f32: ``‖c‖² − 2·scale·(q·c) + ‖q‖²`` where
    the tuple is active for (a, c), the id is >= 0 and the candidate's
    visited bit is clear; +inf otherwise."""
    n = table.shape[0]
    q = q.float()
    safe = cand_ids.long().clamp(0, n - 1)
    cand = table[safe]                                # [B, C, D]
    # q.c and |q|^2 summed in f64 in the kernel's order, rounded once
    width = 16 if table.dtype == torch.int8 else 4
    cross = warp_dot(cand, q[:, None, :], width)
    if scales is not None:
        cross = cross * scales[safe]
    qs = warp_dot(q, q)[:, None]
    dist = norms[safe] - 2.0 * cross + qs
    a = state[:, 0:1]
    cc = state[:, 1:2]
    word = torch.gather(visited, 1, safe >> 5)
    seen = ((word >> (safe & 31)) & 1) == 1
    ok = (
        (labels[..., 0] <= a)
        & (a <= labels[..., 1])
        & (labels[..., 2] <= cc)
        & (cc <= labels[..., 3])
        & (cand_ids >= 0)
        & ~seen
    )
    return torch.where(ok, dist, torch.full_like(dist, INF))


def unpack_labels(plabels: torch.Tensor) -> torch.Tensor:
    """Packed int32 word pairs ``[..., 2]`` -> int32 rectangles ``[..., 4]``
    (l, r, b, e): word 0 = ``l | r << 16``, word 1 = ``b | e << 16``."""
    w0 = plabels[..., 0]
    w1 = plabels[..., 1]
    return torch.stack(
        [w0 & 0xFFFF, (w0 >> 16) & 0xFFFF, w1 & 0xFFFF, (w1 >> 16) & 0xFFFF],
        dim=-1,
    ).to(torch.int32)


def filter_dist_gather_packed_ref(
    table: torch.Tensor,      # [n, D] full vector table (f32 or int8)
    plabels: torch.Tensor,    # [n, E, 2] int32 bit-packed label rectangles
    norms: torch.Tensor,      # [n] f32 cached ‖c‖²
    q: torch.Tensor,          # [B, D] query vectors
    cur_ids: torch.Tensor,    # [B, M] int32 expanded beam nodes (label rows)
    cand_ids: torch.Tensor,   # [B, M*E] int32 candidate row ids (-1 = padding)
    state: torch.Tensor,      # [B, 2] int32 canonical rank state (a, c)
    visited: torch.Tensor,    # [B, ceil(n/32)] int32 bit-packed visited set
    scales: torch.Tensor | None = None,   # [n] f32 int8 dequant scales
) -> torch.Tensor:
    """Gathers the packed label rows of the ``M`` expanded nodes, unpacks
    them, and scores through :func:`filter_dist_gather_ref`."""
    n = table.shape[0]
    B, M = cur_ids.shape
    E = plabels.shape[1]
    rows = plabels[cur_ids.long().clamp(0, n - 1)]    # [B, M, E, 2]
    labels = unpack_labels(rows.reshape(B, M * E, 2))
    return filter_dist_gather_ref(
        table, norms, q, cand_ids, labels, state, visited, scales
    )


def mono_key(d: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic key of f32 values as int64 in ``[0, 2**32)``: a < b
    (IEEE, no NaN) iff key(a) < key(b). ``-0.0`` is normalized to ``+0.0``
    first, so float equality and key equality coincide."""
    bits = (d.float() + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    neg = bits >= 0x80000000
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def dedup_mask(
    cand_d: torch.Tensor, cand_ids: torch.Tensor, n: int
) -> torch.Tensor:
    """[B, C] bool: True where an *earlier* finite candidate in the row
    carries the same id (keep-first duplicate suppression)."""
    C = cand_d.shape[1]
    fin = torch.isfinite(cand_d)
    id_key = torch.where(fin, cand_ids, torch.full_like(cand_ids, n))
    earlier = torch.ones(C, C, dtype=torch.bool, device=cand_d.device).triu(1)
    same = id_key[:, :, None] == id_key[:, None, :]      # [B, j, i]
    return torch.any(same & earlier[None], dim=1) & fin


def beam_merge_ref(
    beam_d: torch.Tensor,     # [B, L] f32 ascending beam distances
    beam_ids: torch.Tensor,   # [B, L] int32 (-1 padding)
    beam_exp: torch.Tensor,   # [B, L] bool expanded flags
    cand_d: torch.Tensor,     # [B, C] f32 (+inf = dead candidate)
    cand_ids: torch.Tensor,   # [B, C] int32
    *,
    n: int,
    visited: torch.Tensor | None = None,   # [B, ceil(n/32)] int32 bitmap
):
    """Stable-sort top-L merge: suppress every candidate whose id appeared
    on an earlier finite candidate, then stable-sort ``[beam, candidates]``
    by distance and keep the best L — ties resolve by concat position.
    Returns ``(new_ids, new_d, new_exp, keep)``; with ``visited``, then sets
    the kept candidates' bits in it in place (:func:`set_bits`)."""
    L = beam_d.shape[1]
    dup = dedup_mask(cand_d, cand_ids, n)
    d_dd = torch.where(dup, torch.full_like(cand_d, INF), cand_d)
    keep = torch.isfinite(d_dd)
    all_d = torch.cat([beam_d, d_dd], dim=1)
    all_ids = torch.cat([beam_ids, cand_ids], dim=1)
    all_exp = torch.cat([beam_exp, ~keep], dim=1)
    # sort on d + 0.0 (-0.0 -> +0.0, as the reference's comparator does),
    # carry the original values
    order = torch.sort(all_d + 0.0, dim=1, stable=True).indices[:, :L]
    if visited is not None:
        set_bits(visited, cand_ids, keep, n)
    return (
        torch.gather(all_ids, 1, order),
        torch.gather(all_d, 1, order),
        torch.gather(all_exp, 1, order),
        keep,
    )


def set_bits(visited, ids, keep, n):
    """Set the bits of the kept ids (clipped to ``[0, n)``) in the int32
    visited bitmap ``[B, ceil(n/32)]``, in place, by a scatter-add, as the
    reference's bitmap update (``search/batched.py:236-243``). Kept ids are
    deduped and unvisited, so each bit lands at most once and the add is an
    or, in any order; ``1 << 31`` wraps to the right int32 bit pattern."""
    ids_safe = ids.clamp(0, n - 1).long()
    bits = torch.where(keep, 1 << (ids_safe & 31), 0).to(torch.int32)
    visited.scatter_add_(1, ids_safe >> 5, bits)


def quantize_int8(v: torch.Tensor):
    """Per-vector symmetric int8 quantization: v ~ q * scale."""
    amax = torch.clamp(torch.amax(torch.abs(v), dim=-1), min=1e-12)
    scale = (amax / 127.0).float()
    q = torch.clamp(torch.round(v / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale
