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

The blocks take no ``tp``: under tensor parallelism their leaves are
gathered whole (``distributed.fsdp.read_policy``) and every rank of the
model group runs them alike. A column slice of Mamba1's concatenated
``in_proj`` (``[x, z]``) or Mamba2's (``z, x, B, C, dt``) would not give a
rank matching channels, and Mamba2's gated norm runs over all of
``d_inner``; their split over ``model`` is not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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


# --- Mamba1 (falcon-mamba) -------------------------------------------------------


def _mamba1_core(p, x_c, dt_rank, d_state):
    """Shared projections: returns (dt [B,.,di], Bc [B,.,ds], Cc [B,.,ds])."""
    dbc = x_c @ p.x_proj
    dt, Bc, Cc = torch.split(dbc, [dt_rank, d_state, dbc.shape[-1] - dt_rank - d_state], dim=-1)
    dt = F.softplus(dt.float() @ p.dt_proj.float() + p.dt_bias)
    return dt, Bc.float(), Cc.float()


def mamba1_with_state(
    p, x: torch.Tensor, *, d_state: int, expand: int, d_conv: int, chunk: int = 128,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill: full-sequence Mamba1 that also returns the decode state."""
    B, S, D = x.shape
    d_inner = expand * D
    dt_rank = max(D // 16, 1)
    x_in, z = (x @ p.in_proj).chunk(2, dim=-1)
    x_c = F.silu(_causal_conv1d(x_in, p.conv_w, p.conv_b))
    dt, Bc, Cc = _mamba1_core(p, x_c, dt_rank, d_state)
    A = -torch.exp(p.A_log)                               # [di, ds]
    log_decay = dt[..., None] * A                         # [B,S,di,ds]
    u = (dt * x_c.float())[..., None] * Bc[:, :, None, :]
    h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
    h_seq, h_final = chunked_linear_scan(log_decay, u, h0, chunk)
    y = torch.einsum("bsfd,bsd->bsf", h_seq, Cc) + p.D * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    conv_tail = x_in[:, S - (d_conv - 1):, :].float()
    return y @ p.out_proj, {"conv": conv_tail, "h": h_final}


def mamba1(p, x: torch.Tensor, *, d_state: int, expand: int, chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba1 block. x: [B, S, D] -> [B, S, D]."""
    return mamba1_with_state(p, x, d_state=d_state, expand=expand, d_conv=p.conv_w.shape[0],
                             chunk=chunk)[0]


def init_mamba1_state(batch: int, d_model: int, d_state: int, d_conv: int, expand: int,
                      device=None):
    d_inner = expand * d_model
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
    }


def mamba1_decode(p, x: torch.Tensor, state: Dict, *, d_state: int, expand: int
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence. x: [B, 1, D]."""
    D = x.shape[-1]
    dt_rank = max(D // 16, 1)
    x_in, z = (x[:, 0] @ p.in_proj).chunk(2, dim=-1)     # [B, di]
    x_c, new_conv = _conv_step(state["conv"], x_in, p.conv_w, p.conv_b)
    x_c = F.silu(x_c).to(x.dtype)
    dt, Bc, Cc = _mamba1_core(p, x_c, dt_rank, d_state)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt[..., None] * A)                  # [B, di, ds]
    u = (dt * x_c.float())[..., None] * Bc[:, None, :]
    h = decay * state["h"] + u
    y = torch.einsum("bfd,bd->bf", h, Cc) + p.D * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    return (y @ p.out_proj)[:, None], {"conv": new_conv, "h": h}


# --- Mamba2 / SSD (zamba2) --------------------------------------------------------


def _mamba2_in(p, x, d_inner, d_state):
    """(z, raw xBC before the conv, dt) of the input projection."""
    nh = p.in_proj.shape[1] - 2 * d_inner - 2 * d_state
    z, xbc, dt = torch.split(x @ p.in_proj, [d_inner, d_inner + 2 * d_state, nh], dim=-1)
    return z, xbc, dt


def _mamba2_seq(p, x, *, d_state, expand, head_dim, scan):
    """Full-sequence Mamba2 with ``scan(xh, dt, A, Bc, Cc) -> (y, h_final)``;
    returns (out, raw xBC, h_final)."""
    B, S, D = x.shape
    d_inner = expand * D
    nh = d_inner // head_dim
    z, xbc_raw, dt = _mamba2_in(p, x, d_inner, d_state)
    xbc = F.silu(_causal_conv1d(xbc_raw, p.conv_w, p.conv_b))
    xs, Bc, Cc = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)                          # [B,S,nh]
    A = -torch.exp(p.A_log)                                          # [nh]
    xh = xs.reshape(B, S, nh, head_dim).float()
    y, h_final = scan(xh, dt, A, Bc.float(), Cc.float())
    y = y + p.D[:, None] * xh
    y = y.reshape(B, S, d_inner).to(x.dtype) * F.silu(z)
    return y @ p.out_proj, xbc_raw, h_final


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
    chunk: int = 128,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill: full-sequence Mamba2 that also returns the decode state."""
    out, xbc_raw, h_final = _mamba2_seq(p, x, d_state=d_state, expand=expand,
                                        head_dim=head_dim, scan=_linear_scan_heads(chunk))
    S = x.shape[1]
    return out, {"conv": xbc_raw[:, S - (d_conv - 1):, :].float(), "h": h_final}


def mamba2(p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int,
           chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba2 (scalar-decay-per-head SSD). x: [B, S, D]."""
    return _mamba2_seq(p, x, d_state=d_state, expand=expand, head_dim=head_dim,
                       scan=_linear_scan_heads(chunk))[0]


def init_mamba2_state(batch: int, d_model: int, d_state: int, d_conv: int, expand: int,
                      head_dim: int, device=None):
    d_inner = expand * d_model
    nh = d_inner // head_dim
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner + 2 * d_state), dtype=torch.float32,
                            device=device),
        "h": torch.zeros((batch, nh, head_dim, d_state), dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x: torch.Tensor, state: Dict, *, d_state: int, expand: int, head_dim: int
                  ) -> Tuple[torch.Tensor, Dict]:
    B, _, D = x.shape
    d_inner = expand * D
    nh = d_inner // head_dim
    z, xbc, dt = _mamba2_in(p, x[:, 0], d_inner, d_state)
    xbc, new_conv = _conv_step(state["conv"], xbc, p.conv_w, p.conv_b)
    xbc = F.silu(xbc).to(x.dtype)
    xs, Bc, Cc = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)                          # [B, nh]
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)[..., None, None]                       # [B,nh,1,1]
    xh = xs.reshape(B, nh, head_dim).float()
    u = (dt[..., None] * xh)[..., None] * Bc.float()[:, None, None, :]
    h = decay * state["h"] + u
    y = torch.einsum("bnfd,bd->bnf", h, Cc.float())
    y = y + p.D[:, None] * xh
    y = y.reshape(B, d_inner).to(x.dtype) * F.silu(z)
    return (y @ p.out_proj)[:, None], {"conv": new_conv, "h": h}


# --- Mamba2 SSD (chunked quadratic) -------------------------------------------


def _ssd_scan(xh, dt, A, Bc, Cc, chunk):
    """Chunked SSD evaluation of the Mamba2 recurrence: an intra-chunk
    quadratic term (a [Q, Q] masked decay matrix, since the decay is scalar
    per head) plus an inter-chunk carry. Every exponent is <= 0.

    xh [B,S,nh,hd] f32; dt [B,S,nh] f32 (>=0); A [nh] (<0);
    Bc/Cc [B,S,ds] f32. Returns (y [B,S,nh,hd], h_final [B,nh,hd,ds]).
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


def mamba2_ssd_with_state(
    p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int, d_conv: int,
    chunk: int = 64,
):
    """Prefill variant of ``mamba2_ssd`` returning the decode state."""
    out, xbc_raw, h_final = _mamba2_seq(
        p, x, d_state=d_state, expand=expand, head_dim=head_dim,
        scan=lambda xh, dt, A, Bc, Cc: _ssd_scan(xh, dt, A, Bc, Cc, chunk))
    S = x.shape[1]
    return out, {"conv": xbc_raw[:, S - (d_conv - 1):, :].float(), "h": h_final}


def mamba2_ssd(p, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int,
               chunk: int = 64) -> torch.Tensor:
    """Mamba2 block using the chunked-SSD path (equal to ``mamba2`` up to
    float reassociation)."""
    return mamba2_ssd_with_state(p, x, d_state=d_state, expand=expand, head_dim=head_dim,
                                 d_conv=p.conv_w.shape[0], chunk=chunk)[0]
