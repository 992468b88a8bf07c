"""State-space blocks, the JAX package's ``models/ssm.py``: Mamba1
(falcon-mamba) and Mamba2 / SSD (zamba2).

Prefill runs a *chunked* scan: an outer Python loop over chunks carries the
SSM state, and within a chunk a log-depth inclusive scan (Hillis-Steele)
applies the reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``.
That bounds the materialised [B, chunk, F, d_state] tensors to one chunk, as
the reference's ``lax.associative_scan`` does; the two scans associate the
products differently, so they agree to float rounding (the tolerance the
reference holds its own SSD path to). ``mamba2_ssd`` is the chunked quadratic
form. Decode is the exact one-token recurrence on the carried state. The
depthwise causal conv and the scan run in f32.

Under tensor parallelism (``tp``, a ``distributed.comm.ModelGroup``; ``None``
in one process) each rank of the model group runs its share of a block:
Mamba1's ``d_inner`` channels ``[r di/m, (r+1) di/m)`` and Mamba2's heads
``[r nh/m, (r+1) nh/m)`` with their channels. The input projection is read
whole and the rank takes its columns of each concatenated part
(``own_columns``: Mamba1's x and z, Mamba2's z, x and dt; Mamba2's B and C
are computed on every rank); the conv, the scan, the skip term and the gate
run on the rank's channels; ``out_proj`` is row-parallel and its partial
products are summed (``reduce_from_model``). Mamba1's ``x_proj`` is
row-parallel too, and every rank reads the whole sum (dt's low-rank part, B
and C) with its own channels, so that sum is taken both ways
(``sum_over_model``). Mamba2 has no norm after the gate, as in the
reference, so nothing else crosses ranks. A split block's decode state
holds ``h`` of the rank's channels or heads (``RANK_STATE``), and Mamba1's
``conv`` of its channels. Mamba2's ``conv`` is whole (its spec splits the
concatenated [x, B, C] channels, not the rank's): the step reads the rank's
columns of it and rebuilds the new row whole from the ranks' new x channels
(one ``all_gather``, tag ``tp.conv``, a layer a step; the prefill's tail
likewise).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import comm
from repro_torch.distributed.comm import copy_to_model, part, reduce_from_model, sum_over_model
from repro_torch.models.layers import param


class Mamba1(nn.Module):
    def __init__(self, d_model: int, d_state: int, d_conv: int, expand: int, dtype, device=None):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = max(d_model // 16, 1)
        f32 = torch.float32
        self.in_proj = param((d_model, 2 * d_inner), dtype, device)
        self.conv_w = param((d_conv, d_inner), dtype, device)
        self.conv_b = param((d_inner,), dtype, device)
        self.x_proj = param((d_inner, dt_rank + 2 * d_state), dtype, device)
        self.dt_proj = param((dt_rank, d_inner), dtype, device)
        self.dt_bias = param((d_inner,), f32, device)
        self.A_log = param((d_inner, d_state), f32, device)
        self.D = param((d_inner,), f32, device)
        self.out_proj = param((d_inner, d_model), dtype, device)


class Mamba2(nn.Module):
    def __init__(self, d_model: int, d_state: int, d_conv: int, expand: int, head_dim: int,
                 dtype, device=None):
        super().__init__()
        d_inner = expand * d_model
        nheads = d_inner // head_dim
        f32 = torch.float32
        self.in_proj = param((d_model, 2 * d_inner + 2 * d_state + nheads), dtype, device)
        self.conv_w = param((d_conv, d_inner + 2 * d_state), dtype, device)
        self.conv_b = param((d_inner + 2 * d_state,), dtype, device)
        self.dt_bias = param((nheads,), f32, device)
        self.A_log = param((nheads,), f32, device)
        self.D = param((nheads,), f32, device)
        self.out_proj = param((d_inner, d_model), dtype, device)


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the pairs (a_t, b_t) under the
    combine of ``chunked_linear_scan``: (prod of a, h with h_{-1} = 0)."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def chunked_linear_scan(
    log_decay: torch.Tensor,  # [B, S, F, ds] (log of per-step decay, <= 0)
    u: torch.Tensor,          # [B, S, F, ds] per-step input
    h0: torch.Tensor,         # [B, F, ds]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_decay_t) * h_{t-1} + u_t, returning all h plus final."""
    S = u.shape[1]
    chunk = min(chunk, S)
    while S % chunk:  # fall back to the largest divisor of S <= chunk
        chunk -= 1
    h = h0
    parts = []
    for c0 in range(0, S, chunk):
        a_cum, h_within = _inclusive_scan(torch.exp(log_decay[:, c0:c0 + chunk]),
                                          u[:, c0:c0 + chunk])
        h_all = h_within + a_cum * h[:, None]          # fold in carry
        h = h_all[:, -1]
        parts.append(h_all)
    return torch.cat(parts, dim=1), h


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq, in f32. x: [B, S, C]; w: [K, C]; b: [C]."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))             # K-1 zeros before the sequence
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for j in range(1, K):
        out = out + xp[:, j:j + S] * wf[j]
    return (out + b.float()).to(x.dtype)


def _conv_step(state_conv: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv: (conv output f32 [B, C], the
    window's last K-1 inputs as the new state)."""
    window = torch.cat([state_conv, x_new[:, None].float()], dim=1)   # [B, K, C]
    return torch.einsum("bkc,kc->bc", window, w.float()) + b.float(), window[:, 1:]


def own_columns(w: torch.Tensor, parts, tp) -> torch.Tensor:
    """The columns of ``w``'s last dim that this rank reads: ``parts`` lists
    the concatenated segments as ``(width, split)``; a split segment gives
    the rank's share, a shared one all of it. ``w`` itself without a group."""
    if tp is None:
        return w
    cols, start = [], 0
    for width, split in parts:
        c0, k = part(tp, width) if split else (0, width)
        cols.append(w.narrow(-1, start + c0, k))
        start += width
    return torch.cat(cols, dim=-1)


# the decode state leaves a split block holds as the rank's channels or heads
RANK_STATE = {"mamba1": ("conv", "h"), "mamba2": ("h",)}


def _own(t: torch.Tensor, tp) -> torch.Tensor:
    """This rank's rows of a per-channel or per-head leaf (all without a group)."""
    return t if tp is None else t.narrow(0, *part(tp, t.shape[0]))


# --- Mamba1 (falcon-mamba) -------------------------------------------------------


def _mamba1_in(p, x, tp):
    """(x_in, z): the input projection's x and z channels this rank owns."""
    w = p.in_proj
    d_inner = w.shape[1] // 2
    w = own_columns(w, ((d_inner, True), (d_inner, True)), tp)
    return (copy_to_model(x, tp) @ w).chunk(2, dim=-1)


def _mamba1_core(p, x_c, dt_rank, d_state, tp):
    """Shared projections: returns (dt [B,.,di], Bc [B,.,ds], Cc [B,.,ds]),
    dt of this rank's channels."""
    dbc = sum_over_model(x_c @ p.x_proj, tp)
    dt, Bc, Cc = torch.split(dbc, [dt_rank, d_state, dbc.shape[-1] - dt_rank - d_state], dim=-1)
    dt = F.softplus(dt.float() @ p.dt_proj.float() + _own(p.dt_bias, tp))
    return dt, Bc.float(), Cc.float()


def mamba1_with_state(
    p, x: torch.Tensor, *, d_state: int, expand: int, d_conv: int, chunk: int = 128, tp=None,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill: full-sequence Mamba1 that also returns the decode state (of
    this rank's channels)."""
    B, S, D = x.shape
    d_inner = part(tp, expand * D)[1]
    dt_rank = max(D // 16, 1)
    x_in, z = _mamba1_in(p, x, tp)
    x_c = F.silu(_causal_conv1d(x_in, p.conv_w, p.conv_b))
    dt, Bc, Cc = _mamba1_core(p, x_c, dt_rank, d_state, tp)
    A = -torch.exp(_own(p.A_log, tp))                     # [di, ds]
    log_decay = dt[..., None] * A                         # [B,S,di,ds]
    u = (dt * x_c.float())[..., None] * Bc[:, :, None, :]
    h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
    h_seq, h_final = chunked_linear_scan(log_decay, u, h0, chunk)
    y = torch.einsum("bsfd,bsd->bsf", h_seq, Cc) + _own(p.D, tp) * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    conv_tail = x_in[:, S - (d_conv - 1):, :].float()
    return reduce_from_model(y @ p.out_proj, tp), {"conv": conv_tail, "h": h_final}


def mamba1(p, x: torch.Tensor, *, d_state: int, expand: int, chunk: int = 128, tp=None
           ) -> torch.Tensor:
    """Full-sequence Mamba1 block. x: [B, S, D] -> [B, S, D]."""
    return mamba1_with_state(p, x, d_state=d_state, expand=expand, d_conv=p.conv_w.shape[0],
                             chunk=chunk, tp=tp)[0]


def init_mamba1_state(batch: int, d_model: int, d_state: int, d_conv: int, expand: int,
                      device=None):
    d_inner = expand * d_model
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
    }


def mamba1_decode(p, x: torch.Tensor, state: Dict, *, d_state: int, expand: int, tp=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence. x: [B, 1, D]; ``state`` of this rank's channels."""
    D = x.shape[-1]
    dt_rank = max(D // 16, 1)
    x_in, z = _mamba1_in(p, x[:, 0], tp)                 # [B, di]
    x_c, new_conv = _conv_step(state["conv"], x_in, p.conv_w, p.conv_b)
    x_c = F.silu(x_c).to(x.dtype)
    dt, Bc, Cc = _mamba1_core(p, x_c, dt_rank, d_state, tp)
    A = -torch.exp(_own(p.A_log, tp))
    decay = torch.exp(dt[..., None] * A)                  # [B, di, ds]
    u = (dt * x_c.float())[..., None] * Bc[:, None, :]
    h = decay * state["h"] + u
    y = torch.einsum("bfd,bd->bf", h, Cc) + _own(p.D, tp) * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    return reduce_from_model(y @ p.out_proj, tp)[:, None], {"conv": new_conv, "h": h}


# --- Mamba2 / SSD (zamba2) --------------------------------------------------------


def _mamba2_conv_parts(d_inner, d_state):
    """The conv's channels [x, B, C] as ``own_columns`` segments."""
    return (d_inner, True), (2 * d_state, False)


def _mamba2_in(p, x, d_inner, d_state, tp=None):
    """(z, raw xBC before the conv, dt) of the input projection: this rank's
    z and x channels, all of B and C, and dt of its heads."""
    w = p.in_proj
    nh = w.shape[1] - 2 * d_inner - 2 * d_state
    w = own_columns(w, ((d_inner, True),) + _mamba2_conv_parts(d_inner, d_state)
                    + ((nh, True),), tp)
    di, nh = part(tp, d_inner)[1], part(tp, nh)[1]
    z, xbc, dt = torch.split(copy_to_model(x, tp) @ w, [di, di + 2 * d_state, nh], dim=-1)
    return z, xbc, dt


def _mamba2_conv(p, d_inner, d_state, tp):
    """(conv_w, conv_b) of this rank's conv channels."""
    parts = _mamba2_conv_parts(d_inner, d_state)
    return own_columns(p.conv_w, parts, tp), own_columns(p.conv_b, parts, tp)


def _mamba2_seq(p, x, *, d_state, expand, head_dim, scan, tp=None):
    """Full-sequence Mamba2 with ``scan(xh, dt, A, Bc, Cc) -> (y, h_final)``
    on this rank's heads; returns (out, raw xBC of the rank's conv channels,
    h_final)."""
    B, S, D = x.shape
    d_inner = expand * D
    z, xbc_raw, dt = _mamba2_in(p, x, d_inner, d_state, tp)
    di, nh = z.shape[-1], dt.shape[-1]
    xbc = F.silu(_causal_conv1d(xbc_raw, *_mamba2_conv(p, d_inner, d_state, tp)))
    xs, Bc, Cc = torch.split(xbc, [di, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + _own(p.dt_bias, tp))                # [B,S,nh]
    A = -torch.exp(_own(p.A_log, tp))                                # [nh]
    xh = xs.reshape(B, S, nh, head_dim).float()
    y, h_final = scan(xh, dt, A, Bc.float(), Cc.float())
    y = y + _own(p.D, tp)[:, None] * xh
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(z)
    return reduce_from_model(y @ p.out_proj, tp), xbc_raw, h_final


def _linear_scan_heads(chunk):
    def scan(xh, dt, A, Bc, Cc):
        B, S, nh, hd = xh.shape
        ds = Bc.shape[-1]
        log_decay = (dt * A)[..., None, None]                        # [B,S,nh,1,1]
        u = (dt[..., None] * xh)[..., None] * Bc[:, :, None, None, :]
        F_ = nh * hd
        h_seq, h_final = chunked_linear_scan(
            log_decay.expand(u.shape).reshape(B, S, F_, ds),
            u.reshape(B, S, F_, ds),
            torch.zeros((B, F_, ds), dtype=torch.float32, device=xh.device),
            chunk,
        )
        y = torch.einsum("bsnfd,bsd->bsnf", h_seq.reshape(B, S, nh, hd, ds), Cc)
        return y, h_final.reshape(B, nh, hd, ds)
    return scan


def mamba2_with_state(
    p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int, d_conv: int,
    chunk: int = 128, tp=None,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill: full-sequence Mamba2 that also returns the decode state
    (``h`` of this rank's heads, ``conv`` whole)."""
    out, xbc_raw, h_final = _mamba2_seq(p, x, d_state=d_state, expand=expand,
                                        head_dim=head_dim, scan=_linear_scan_heads(chunk), tp=tp)
    S = x.shape[1]
    tail = _conv_whole(xbc_raw[:, S - (d_conv - 1):, :].float(), x.shape[-1] * expand, tp)
    return out, {"conv": tail, "h": h_final}


def mamba2(p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int,
           chunk: int = 128, tp=None) -> torch.Tensor:
    """Full-sequence Mamba2 (scalar-decay-per-head SSD). x: [B, S, D]."""
    return _mamba2_seq(p, x, d_state=d_state, expand=expand, head_dim=head_dim,
                       scan=_linear_scan_heads(chunk), tp=tp)[0]


def init_mamba2_state(batch: int, d_model: int, d_state: int, d_conv: int, expand: int,
                      head_dim: int, device=None):
    d_inner = expand * d_model
    nh = d_inner // head_dim
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner + 2 * d_state), dtype=torch.float32,
                            device=device),
        "h": torch.zeros((batch, nh, head_dim, d_state), dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x: torch.Tensor, state: Dict, *, d_state: int, expand: int, head_dim: int,
                  tp=None) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence. x: [B, 1, D]; ``state``'s ``h`` of this rank's
    heads, its ``conv`` whole."""
    B, _, D = x.shape
    d_inner = expand * D
    z, xbc, dt = _mamba2_in(p, x[:, 0], d_inner, d_state, tp)
    di, nh = z.shape[-1], dt.shape[-1]
    conv = own_columns(state["conv"], _mamba2_conv_parts(d_inner, d_state), tp)
    xbc, new_conv = _conv_step(conv, xbc, *_mamba2_conv(p, d_inner, d_state, tp))
    if tp is not None:
        new_conv = torch.cat([state["conv"][:, 1:], _conv_whole(new_conv[:, -1:], d_inner, tp)],
                             dim=1)
    xbc = F.silu(xbc).to(x.dtype)
    xs, Bc, Cc = torch.split(xbc, [di, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + _own(p.dt_bias, tp))                # [B, nh]
    A = -torch.exp(_own(p.A_log, tp))
    decay = torch.exp(dt * A)[..., None, None]                       # [B,nh,1,1]
    xh = xs.reshape(B, nh, head_dim).float()
    u = (dt[..., None] * xh)[..., None] * Bc.float()[:, None, None, :]
    h = decay * state["h"] + u
    y = torch.einsum("bnfd,bd->bnf", h, Cc.float())
    y = y + _own(p.D, tp)[:, None] * xh
    y = y.reshape(B, di).to(x.dtype) * F.silu(z)
    return reduce_from_model(y @ p.out_proj, tp)[:, None], {"conv": new_conv, "h": h}


def _conv_whole(conv: torch.Tensor, d_inner: int, tp, tag: str = "tp.conv") -> torch.Tensor:
    """The whole Mamba2 conv rows ``[B, n, C]`` from this rank's (its x
    channels, then all of B and C): one ``all_gather`` of the x channels
    over the model group. ``conv`` itself without a group."""
    if tp is None:
        return conv
    k = part(tp, d_inner)[1]
    xs = comm.all_gather(conv[..., :k], tp.group, dim=conv.dim() - 1, tag=tag)
    return torch.cat([xs, conv[..., k:]], dim=-1)


# --- Mamba2 SSD (chunked quadratic) -------------------------------------------


def _ssd_scan(xh, dt, A, Bc, Cc, chunk):
    """Chunked SSD evaluation of the Mamba2 recurrence: an intra-chunk
    quadratic term (a [Q, Q] masked decay matrix, since the decay is scalar
    per head) plus an inter-chunk carry. Every exponent is <= 0.

    xh [B,S,nh,hd] f32; dt [B,S,nh] f32 (>=0); A [nh] (<0);
    Bc/Cc [B,S,ds] f32. Returns (y [B,S,nh,hd], h_final [B,nh,hd,ds]).
    Every term is per head but ``CB``: given a rank's heads it runs that
    rank's share, and each rank computes ``CB`` whole.
    """
    B, S, nh, hd = xh.shape
    ds = Bc.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    NC = S // Q
    xc = xh.reshape(B, NC, Q, nh, hd)
    dtc = dt.reshape(B, NC, Q, nh)
    Bcc = Bc.reshape(B, NC, Q, ds)
    Ccc = Cc.reshape(B, NC, Q, ds)
    cum = torch.cumsum(dtc * A, dim=2)                 # [B,NC,Q,nh]

    # intra-chunk: y[t] += C_t . sum_{tau<=t} exp(cum_t - cum_tau) dt_tau x_tau B_tau
    CB = torch.einsum("bcqd,bckd->bcqk", Ccc, Bcc)     # [B,NC,Q,Q]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,NC,Q,Q,nh]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # exp of the masked exponent, not a masked exp: above the diagonal seg > 0
    # can overflow to inf, and where(mask, inf, 0)'s gradient is 0 * inf = NaN
    L = torch.exp(torch.where(mask[None, None, :, :, None], seg, float("-inf")))
    M = CB[..., None] * L * dtc[:, :, None, :, :]      # [B,NC,Q,Q,nh]
    y_intra = torch.einsum("bcqkh,bckhi->bcqhi", M, xc)

    # per-chunk state contribution + decay, then a loop over chunks
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B,NC,Q,nh]
    hc = torch.einsum("bckh,bckhi,bckd->bchid", decay_to_end * dtc, xc, Bcc)
    chunk_decay = torch.exp(cum[:, :, -1, :])          # [B,NC,nh]
    h = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=xh.device)
    y_carry = []
    for c in range(NC):
        y_carry.append(torch.einsum("bqd,bqh,bhid->bqhi", Ccc[:, c], torch.exp(cum[:, c]), h))
        h = h * chunk_decay[:, c, :, None, None] + hc[:, c]
    y = y_intra + torch.stack(y_carry, dim=1)
    return y.reshape(B, S, nh, hd), h


def _ssd_scan_fn(chunk):
    return lambda xh, dt, A, Bc, Cc: _ssd_scan(xh, dt, A, Bc, Cc, chunk)


def mamba2_ssd_with_state(
    p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int, d_conv: int,
    chunk: int = 64, tp=None,
):
    """Prefill variant of ``mamba2_ssd`` returning the decode state."""
    out, xbc_raw, h_final = _mamba2_seq(p, x, d_state=d_state, expand=expand,
                                        head_dim=head_dim, scan=_ssd_scan_fn(chunk), tp=tp)
    S = x.shape[1]
    tail = _conv_whole(xbc_raw[:, S - (d_conv - 1):, :].float(), x.shape[-1] * expand, tp)
    return out, {"conv": tail, "h": h_final}


def mamba2_ssd(p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int,
               chunk: int = 64, tp=None) -> torch.Tensor:
    """Mamba2 block using the chunked-SSD path (equal to ``mamba2`` up to
    float reassociation)."""
    return _mamba2_seq(p, x, d_state=d_state, expand=expand, head_dim=head_dim,
                       scan=_ssd_scan_fn(chunk), tp=tp)[0]
