"""Plain PyTorch version of the forecast kernel and its basis weights.

The kernel computes `out = sum_i coeffs[i] * diffs[i]`, the basis-agnostic
inner loop of every Cache-Then-Forecast policy; `basis_coeffs` gives the
(order+1,) weights for Taylor (TaylorSeer Eq. 42), Newton, contracted
Hermite (HiCache Eq. 47), Adams-Bashforth and FoCa (Eq. 48).  A batch of offsets `u`
(one per serving slot) gives a (..., order+1) batch of weight vectors."""
from __future__ import annotations

import math

import torch


def hermite_poly(i: int, x):
    """Physicists' Hermite H_i(x), small fixed order — unrolled recurrence."""
    h_prev, h = torch.ones_like(x), 2.0 * x
    if i == 0:
        return h_prev
    for n in range(i - 1):
        h_prev, h = h, 2.0 * x * h - 2.0 * (n + 1) * h_prev
    return h


def basis_coeffs(order: int, u, basis: str = "taylor", sigma: float = 0.5,
                 n_valid=None, device=None):
    """u.shape + (order+1,) float32 basis weights at normalised offset u.

    Orders at or beyond `n_valid` (the number of computes seen) weigh 0.

    FoCa iterates a BDF2 predictor and a Heun corrector ceil(u) unit steps
    (at most 64) on the feature ODE.  Each step maps (f_k, f_k-1) to
    (2 f_k - f_k-1, f_k): the slope d[1] is carried unchanged, so the whole
    iteration is d[0] + min(ceil(u), 64) d[1] once two computes are seen
    (and plain reuse of d[0] before): weights (1, n, 0, ...), d[0]'s never
    masked."""
    u = torch.as_tensor(u, dtype=torch.float32, device=device)
    ones = torch.ones_like(u)
    cs = []
    for i in range(order + 1):
        if basis == "taylor":
            c = u**i / math.factorial(i)
        elif basis == "newton":
            c = ones
            for j in range(i):
                c = c * (u + j)
            c = c / math.factorial(i)
        elif basis == "hermite":
            c = (ones if i == 0 else
                 (sigma**i) * hermite_poly(i, sigma * u) / math.factorial(i))
        elif basis == "ab":
            c = {0: ones, 1: u, 2: 0.5 * u}.get(i, torch.zeros_like(u))
        elif basis == "foca":
            c = {0: ones, 1: torch.ceil(u).clamp(0.0, 64.0)}.get(
                i, torch.zeros_like(u))
        else:
            raise ValueError(f"unknown basis {basis}")
        if n_valid is not None and not (basis == "foca" and i == 0):
            c = c * (torch.as_tensor(n_valid, device=u.device) > i).float()
        cs.append(c)
    return torch.stack(cs, dim=-1).float()


def forecast_ref(diffs, coeffs):
    """diffs (m+1, ...) with coeffs (m+1,) -> (...); or diffs (B, m+1, ...)
    with coeffs (B, m+1) -> (B, ...).  f32 accumulation, diffs' dtype out."""
    m1 = coeffs.shape[-1]
    if coeffs.dim() == 1:
        flat = diffs.reshape(m1, -1).float()
        out = coeffs.float() @ flat
        return out.reshape(diffs.shape[1:]).to(diffs.dtype)
    B = coeffs.shape[0]
    flat = diffs.reshape(B, m1, -1).float()
    out = torch.einsum("bi,bin->bn", coeffs.float(), flat)
    return out.reshape((B,) + tuple(diffs.shape[2:])).to(diffs.dtype)
