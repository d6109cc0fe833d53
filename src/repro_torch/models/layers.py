"""Foundational layers of the port (counterpart of the JAX `models/layers.py`).

Plain functions on tensors over a params dict with the JAX key names and
the `(in, out)` matrix layout.  `blocked_attention` is the plain chunked
reference the flash kernel is checked against; the DiT calls
`repro_torch.kernels.flash_attention` instead.

Mixed dtypes follow JAX's promotion: `dot(x, w)` of f32 activations and
bf16 weights runs in f32, as `x @ w` does in JAX (torch.matmul would
refuse the mix).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dot(x, w):
    """`x @ w` under JAX's type promotion (f32 @ bf16 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dense_init(generator, in_dim, out_dim, dtype=torch.float32, scale=None,
               device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator, device=device)
    return (w * scale).to(dtype)


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """f32 statistics, result in x's dtype; weight/bias None mean 1 and 0."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(B, Sq, Sk) additive f32 mask from absolute positions; negative k
    positions mark empty cache slots and are always masked."""
    ok = (k_pos[:, None, :] >= 0).expand(q_pos.shape[0], q_pos.shape[1],
                                         k_pos.shape[1])
    if causal:
        ok = ok & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        ok = ok & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def blocked_attention(q, k, v, *, causal=True, window=0, q_positions=None,
                      k_positions=None, chunk=512, scale=None):
    """Streaming-softmax attention, Q-chunked so only chunk x Sk scores exist.

    q: (B, Sq, H, D); k: (B, Sk, KH, D); v: (B, Sk, KH, Dv), KH | H.
    Returns (B, Sq, H, Dv) in q's dtype."""
    B, Sq, H, D = q.shape
    _, Sk, KH, Dv = v.shape
    group = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    if q_positions is None:
        q_positions = (torch.arange(Sq, device=dev) + (Sk - Sq))[None].expand(B, Sq)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=dev)[None].expand(B, Sk)
    qg = q.reshape(B, Sq, KH, group, D)

    def attend_chunk(q_c, qpos_c):
        s = torch.einsum("bckgd,bskd->bkgcs", q_c.to(k.dtype).float(),
                         k.float()) * scale
        s = s + _mask_bias(qpos_c, k_positions, causal, window)[:, None, None]
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgcs,bskd->bckgd", p.to(v.dtype).float(), v.float())
        return o.to(q.dtype)

    if Sq <= chunk or Sq % chunk != 0:
        out = attend_chunk(qg, q_positions)
    else:
        out = torch.cat([attend_chunk(qg[:, i:i + chunk],
                                      q_positions[:, i:i + chunk])
                         for i in range(0, Sq, chunk)], dim=1)
    return out.reshape(B, Sq, H, Dv)


def init_mlp(generator, d_model, d_ff, dtype=torch.float32, device=None):
    """The DiT's GELU MLP (the gated SwiGLU init comes with the LLM stack)."""
    return {"w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
            "w_down": dense_init(generator, d_ff, d_model, dtype,
                                 device=device)}


def mlp_forward(p, x):
    """SwiGLU when the params hold `w_gate`, else GELU.  JAX's gelu defaults
    to the tanh approximation, so the port uses it too."""
    if "w_gate" in p:
        h = F.silu(dot(x, p["w_gate"])) * dot(x, p["w_up"])
    else:
        h = F.gelu(dot(x, p["w_up"]), approximate="tanh")
    return dot(h, p["w_down"])
