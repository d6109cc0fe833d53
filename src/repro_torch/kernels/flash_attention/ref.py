"""Plain PyTorch versions of the flash-attention kernels (GQA + causal +
sliding window): the port of the JAX package's `attention_ref`, its row
log-sum-exp, and the backward that JAX gets by autodiff of
`blocked_attention`.  They compute in f32 (f64 for f64 inputs)."""
from __future__ import annotations

import math

import torch


def _compute_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _mask(Sq, Sk, causal, window, device):
    """(Sq, Sk) bool: the keys each query may see, q at the tail of k."""
    q_pos = torch.arange(Sq, device=device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def _scores(q, k, causal, window, scale):
    """Masked scores (B, KH, G, Sq, Sk) in the compute dtype (-1e30 where
    masked) and the mask."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    dt = _compute_dtype(q.dtype)
    qf = q.to(dt).reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(dt)) * scale
    ok = _mask(Sq, Sk, causal, window, q.device)
    return torch.where(ok, s, torch.full((), -1e30, device=q.device)), ok


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale=None):
    """q: (B, Sq, H, D); k: (B, Sk, KH, D); v: (B, Sk, KH, Dv); KH divides
    H; returns (B, Sq, H, Dv).

    q occupies the last Sq positions of the Sk-long key sequence.  A row
    whose keys are all masked gets a uniform softmax over all Sk keys (the
    -1e30 fill), exactly as the reference does."""
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, _ = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                      scale=None):
    """Each row's log-sum-exp of the masked scores, (B, H, Sq) in the
    compute dtype: what the forward kernel writes under grad (-1e30 for a
    row whose keys are all masked)."""
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, _ = _scores(q, k, causal, window, scale)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def bf16_pair(x):
    """x (f32) as the backward kernel carries an f32 operand into a bf16
    tensor-core product: hi = bf16(x), lo = bf16(x - hi), returned as
    hi + lo in x's dtype (about 16 bits of x's 24)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi + (x - hi).to(torch.bfloat16).to(x.dtype)


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      window: int = 0, scale=None):
    """(dq, dk, dv) of `attention_ref` for the output gradient `do`, from
    the forward's output `o` and row log-sum-exp `lse` (B, H, Sq): P is
    recomputed as exp(S - lse), dV = P^T dO, dS = P * (dO V^T -
    rowsum(dO * O)) * scale (0 where the key is masked), dQ = dS K, dK =
    dS^T Q, the GQA groups summed into their kv head.  A row whose keys are
    all masked takes the uniform P = 1 / Sk, so it adds dO / Sk to dv and
    nothing to dq or dk, as autograd through the -1e30 fill gives.  For
    bf16 inputs P and dS enter the products that use them as operands as
    the kernel carries them, a bf16 pair each (`bf16_pair`).  v, o and do
    may have a head dim Dv below q and k's D (deepseek-v2's MLA): dV and
    dO V^T run over Dv, as does Delta = rowsum(dO * O); dq and dk over D.
    Each gradient comes back in its input's dtype."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    Dv = v.shape[-1]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, ok = _scores(q, k, causal, window, scale)
    dt = s.dtype
    lse_g = lse.to(dt).reshape(B, KH, G, Sq, 1)
    p = torch.exp(s - lse_g)
    dead = ~ok.any(dim=-1)[:, None]                       # (Sq, 1)
    p = torch.where(dead, torch.full((), 1.0 / Sk, dtype=dt,
                                     device=q.device), p)
    operand = bf16_pair if q.dtype == torch.bfloat16 else (lambda t: t)
    do_g = do.to(dt).reshape(B, Sq, KH, G, Dv)
    o_g = o.to(dt).reshape(B, Sq, KH, G, Dv)
    dv = torch.einsum("bkgqs,bqkgd->bskd", operand(p), do_g)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do_g, v.to(dt))
    delta = torch.einsum("bqkgd,bqkgd->bkgq", do_g, o_g)[..., None]
    ds = operand(torch.where(ok, p * (dp - delta) * scale,
                             torch.zeros((), dtype=dt, device=q.device)))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(dt))
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.to(dt).reshape(B, Sq, KH, G, D))
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
