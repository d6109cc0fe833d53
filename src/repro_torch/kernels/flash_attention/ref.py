"""Plain PyTorch version of the flash-attention kernel (GQA + causal +
sliding window): the port of the JAX package's `attention_ref`."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D); KH divides H.

    q occupies the last Sq positions of the Sk-long key sequence.  A row
    whose keys are all masked gets a uniform softmax over all Sk keys (the
    -1e30 fill), exactly as the reference does."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    group = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KH, group, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(ok, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
