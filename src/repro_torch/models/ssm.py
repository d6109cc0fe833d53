"""Mamba1 (selective scan) and Mamba2 (SSD) blocks of the port
(counterpart of the JAX `models/ssm.py`).

Plain functions over a params dict with the JAX key names and the
`(in, out)` layout.

Mamba1's recurrence h_t = a_t h_{t-1} + u_t runs through
`linear_scan_chunked`, plain PyTorch on every device: JAX computes it
with `lax.associative_scan` inside chunks and `lax.scan` across them, with
no Pallas kernel.  Within a chunk it is a doubling (Hillis-Steele) scan,
log2(chunk) vectorised passes over every chunk at once; only the carry of
the state from chunk to chunk is sequential, over the chunks' last rows.

Mamba2's full-sequence scan goes through `repro_torch.kernels.ssd_scan`
(the CUDA kernels on the card, the plain `ssd_chunked` on the CPU), the
drop-in JAX names for its own plain scan; under training its gradient
comes from the scan's backward kernel on the card (dx, dB and dC flow back
into the views of the conv output).

One-token decode is elementwise in both, as in JAX.  `F.softplus`
returns x itself above 20 where JAX's `softplus` is `logaddexp(x, 0)`;
the two differ there by log1p(exp(-x)) < 3e-9, far inside every
tolerance the tests hold the port to.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.kernels import ssd_scan

from .layers import dense_init, dot, rms_norm


def causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (W, C); b: (C,).  Returns
    (B, S, C) contiguous: the bias add writes the conv's (B, C, S) output
    back in token-major order, so that the SSD scan reads x, B and C as
    views with a unit last stride.  Under grad the add allocates its own
    output (autograd takes no `out=`) and the copy makes it token-major."""
    W, C = w.shape
    lhs = F.pad(x.transpose(1, 2), (W - 1, 0))                   # (B, C, S+W-1)
    out = F.conv1d(lhs, w.t()[:, None, :], groups=C)
    if torch.is_grad_enabled() and out.requires_grad:
        return (out.transpose(1, 2) + b).contiguous()
    res = torch.empty(x.shape[:2] + (C,), dtype=torch.result_type(out, b),
                      device=out.device)
    return torch.add(out.transpose(1, 2), b, out=res)


def conv_step(buf, x_t, w, b):
    """Single-token conv against a rolling buffer.  buf: (B, W, C) holding
    the last W inputs (oldest first); x_t: (B, C).  Returns (y_t, new_buf)."""
    buf = torch.cat([buf[:, 1:], x_t[:, None]], dim=1)
    return torch.einsum("bwc,wc->bc", buf, w) + b, buf


def _conv_tail(raw, width):
    """Last `width` pre-conv inputs, left-padded with zeros (decode buffer)."""
    S = raw.shape[1]
    if S >= width:
        return raw[:, S - width:]
    return F.pad(raw, (0, 0, width - S, 0))


# ----------------------------------------------------------------------
# chunked linear recurrence h_t = a_t * h_{t-1} + u_t
# ----------------------------------------------------------------------

def linear_scan_chunked(a, u, h0, chunk: int):
    """a, u: (B, S, ...) elementwise recurrence tensors; h0: (B, ...).
    Returns (h_all (B, S, ...), h_final).

    Within each chunk an inclusive scan of the pairs (a, u) under
    (a1, u1) then (a2, u2) -> (a2 a1, a2 u1 + u2), as JAX's
    `_assoc_combine`: doubling passes d = 1, 2, 4, ... over all chunks at
    once.  Across chunks the state enters each chunk as JAX's `lax.scan`
    carries it: h_all = A_cum h_in + U_cum."""
    B, S = a.shape[:2]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    rest = a.shape[2:]
    A = a.reshape(B, nc, chunk, *rest)
    U = u.reshape(B, nc, chunk, *rest)
    d = 1
    while d < chunk:
        # rows t >= d combine with row t - d; rows t < d are done
        U = torch.cat([U[:, :, :d], torch.addcmul(U[:, :, d:], A[:, :, d:],
                                                  U[:, :, :-d])], dim=2)
        A = torch.cat([A[:, :, :d], A[:, :, d:] * A[:, :, :-d]], dim=2)
        d *= 2
    # the state entering each chunk: a sequential carry over the last rows
    A_last, U_last = A[:, :, -1], U[:, :, -1]
    h, h_in = h0, []
    for c in range(nc):
        h_in.append(h)
        h = A_last[:, c] * h + U_last[:, c]
    h_all = torch.addcmul(U, A, torch.stack(h_in, 1)[:, :, None])
    return h_all.reshape(B, S, *rest), h


# ----------------------------------------------------------------------
# Mamba1
# ----------------------------------------------------------------------

def init_mamba1(generator, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    din = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((din,), generator=generator, device=device)
                   * (hi - lo) + lo)
    A = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, d, 2 * din, dtype, device=device),
        "conv_w": (torch.randn((cfg.ssm_conv, din), generator=generator,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((din,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, din, dt_rank + 2 * n, dtype,
                             device=device),
        "dt_proj": dense_init(generator, dt_rank, din, dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "A_log": torch.log(A).expand(din, n).contiguous().to(dtype),
        "D": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, din, d, dtype, device=device),
    }


def _mamba1_ssm_inputs(p, x, cfg):
    """dt (param dtype), B_, C_ and A (f32, (din, n)) from the conv
    output x."""
    n = cfg.ssm_state
    r = p["dt_proj"].shape[0]
    dbc = dot(x, p["x_proj"])
    dt = F.softplus(dot(dbc[..., :r], p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return dt, dbc[..., r:r + n], dbc[..., r + n:], A


def mamba1_forward(p, u, cfg, chunk: int = 64):
    """Full-sequence Mamba1.  u: (B, S, d).  Returns (y, cache) with cache
    = {"state" (B, din, n) f32, "conv"} ready for decode.  dA and dBx are
    (B, S, din, n) f32; the scan's h_all lives only inside this call."""
    B, S, _ = u.shape
    xz = dot(u, p["in_proj"])
    x_raw, z = xz.chunk(2, dim=-1)
    x = F.silu(causal_conv(x_raw, p["conv_w"], p["conv_b"]))
    dt, B_, C_, A = _mamba1_ssm_inputs(p, x, cfg)
    dA = torch.exp(dt[..., None].float() * A)
    # the product in the params' dtype, then f32, as JAX computes it
    dBx = (dt[..., None] * B_[:, :, None, :] * x[..., None]).float()
    h0 = torch.zeros((B,) + dA.shape[2:], dtype=torch.float32,
                     device=u.device)
    if S % chunk != 0:
        chunk = S  # tiny smoke sequences
    h_all, h_fin = linear_scan_chunked(dA, dBx, h0, chunk)
    del dA, dBx
    y = torch.einsum("bsdn,bsn->bsd", h_all, C_.float())
    del h_all
    y = (y + p["D"] * x).to(u.dtype) * F.silu(z)
    cache = {"state": h_fin, "conv": _conv_tail(x_raw, cfg.ssm_conv)}
    return dot(y, p["out_proj"]), cache


def mamba1_decode(p, u_t, cfg, conv_buf, h):
    """One-token step.  u_t: (B, 1, d); conv_buf: (B, W, din); h: (B, din,
    n) f32.  Returns (y (B, 1, d), new conv_buf, new h)."""
    xz = dot(u_t[:, 0], p["in_proj"])
    x, z = xz.chunk(2, dim=-1)
    x, conv_buf = conv_step(conv_buf, x, p["conv_w"], p["conv_b"])
    x = F.silu(x)
    dt, B_, C_, A = _mamba1_ssm_inputs(p, x, cfg)
    dA = torch.exp(dt[..., None].float() * A)                  # (B, din, n)
    h = dA * h + (dt[..., None] * B_[:, None, :] * x[..., None]).float()
    y = torch.einsum("bdn,bn->bd", h, C_.float())
    y = (y + p["D"] * x).to(u_t.dtype) * F.silu(z)
    return dot(y, p["out_proj"])[:, None], conv_buf, h


# ----------------------------------------------------------------------
# Mamba2 (SSD)
# ----------------------------------------------------------------------


def init_mamba2(generator, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    din = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = din // cfg.ssm_head_dim

    def uniform(lo, hi):
        return torch.rand((nh,), generator=generator, device=device) \
            * (hi - lo) + lo

    dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
    return {
        # order: [z (din), x (din), B (n), C (n), dt (nh)]
        "in_proj": dense_init(generator, d, 2 * din + 2 * n + nh, dtype,
                              device=device),
        "conv_w": (torch.randn((cfg.ssm_conv, din + 2 * n), generator=generator,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((din + 2 * n,), dtype=dtype, device=device),
        "A_log": torch.log(uniform(1.0, 16.0)).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "norm_w": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, din, d, dtype, device=device),
    }


def _mamba2_inputs(p, u, cfg):
    din = p["norm_w"].shape[0]
    n = cfg.ssm_state
    nh = p["A_log"].shape[0]
    proj = dot(u, p["in_proj"])
    z = proj[..., :din]
    xBC = proj[..., din:2 * din + 2 * n]
    dt_raw = proj[..., 2 * din + 2 * n:]
    return z, xBC, dt_raw, din, n, nh


def mamba2_forward(p, u, cfg):
    """Full-sequence Mamba2.  u: (B, S, d).  Returns (y, cache) with cache =
    {"state", "conv"} ready for decode."""
    B, S, _ = u.shape
    z, xBC_raw, dt_raw, din, n, nh = _mamba2_inputs(p, u, cfg)
    xBC = F.silu(causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    x = xBC[..., :din].reshape(B, S, nh, din // nh)
    B_ = xBC[..., din:din + n]
    C_ = xBC[..., din + n:]
    dt = F.softplus(dt_raw + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    # x, B_, C_: views of xBC, read by the scan in place and in xBC's dtype
    y, h_fin = spmd.batch_local(ssd_scan, (x, dt, A, B_, C_), unbatched=(2,),
                                outputs=2)
    # D x in f32, as D (bf16 params) times the f32 cast of x gives it
    y = y + p["D"].float()[None, None, :, None] * x
    y = y.reshape(B, S, din).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    cache = {"state": h_fin, "conv": _conv_tail(xBC_raw, cfg.ssm_conv)}
    return dot(y, p["out_proj"]), cache


def mamba2_decode(p, u_t, cfg, conv_buf, h):
    """One-token step.  u_t: (B, 1, d); conv_buf: (B, W, din+2n); h: (B, nh,
    hd, n) f32.  Returns (y (B, 1, d), new conv_buf, new h)."""
    B = u_t.shape[0]
    z, xBC, dt_raw, din, n, nh = _mamba2_inputs(p, u_t[:, 0], cfg)
    xBC, conv_buf = conv_step(conv_buf, xBC, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC)
    x = xBC[..., :din].reshape(B, nh, din // nh).float()
    B_ = xBC[..., din:din + n].float()
    C_ = xBC[..., din + n:].float()
    dt = F.softplus(dt_raw + p["dt_bias"]).float()               # (B, nh)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)
    h = h * dA[..., None, None] + (dt[..., None, None] * x[..., None]
                                   * B_[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, C_)
    y = y + p["D"][None, :, None] * x
    y = y.reshape(B, din).to(u_t.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return dot(y, p["out_proj"])[:, None], conv_buf, h
