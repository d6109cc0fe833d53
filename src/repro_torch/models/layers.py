"""Foundational layers of the port (counterpart of the JAX `models/layers.py`).

Plain functions on tensors over a params dict with the JAX key names and
the `(in, out)` matrix layout.  `blocked_attention` is the plain chunked
reference the flash kernel is checked against; the DiT and the LLM prefill
(`attention_forward`) call `repro_torch.kernels.flash_attention` instead,
the drop-in the JAX package names for it.  One-token decode
(`attention_decode`) keeps `blocked_attention`, as JAX computes it outside
any kernel.

Mixed dtypes follow JAX's promotion: `dot(x, w)` of f32 activations and
bf16 weights runs in f32, as `x @ w` does in JAX (torch.matmul would
refuse the mix).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.kernels import flash_attention


def dot(x, w):
    """`x @ w` under JAX's type promotion (f32 @ bf16 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dense_init(generator, in_dim, out_dim, dtype=torch.float32, scale=None,
               device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator, device=device)
    return (w * scale).to(dtype)


def normal_into(t, generator, scale, block=1 << 24):
    """Fill `t` with N(0, scale^2) drawn in f32 a block of at most `block`
    elements (whole rows of its last axis) at a time, so the f32 draw of
    one block is the only transient; returns `t`.  The meta device draws
    nothing."""
    if t.device.type == "meta":
        return t
    rows = t.view(-1, t.shape[-1])
    step = max(block // t.shape[-1], 1)
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=t.device) * scale)
    return t


def embed_init(generator, vocab, dim, dtype=torch.float32, device=None):
    w = torch.randn((vocab, dim), generator=generator, device=device)
    return (w * 0.02).to(dtype)


def rms_norm(x, weight, eps=1e-5):
    """f32 statistics, result in x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, D); positions: (..., S) integer."""
    inv = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    ang = positions[..., None].float() * inv                    # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


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


def _positioned(q, k, v, q_positions, k_positions, **kw):
    return blocked_attention(q, k, v, q_positions=q_positions,
                             k_positions=k_positions, **kw)


def decode_attention(q, k, v, q_positions=None, k_positions=None, **kw):
    """`blocked_attention` of a decode step against a cache; on DTensors
    on each rank's shards (`spmd.attention`)."""
    if q_positions is None:
        return spmd.attention(blocked_attention, q, k, v, **kw)
    return spmd.attention(_positioned, q, k, v, q_positions, k_positions,
                          **kw)


def init_attention(generator, cfg, dtype=torch.float32, device=None):
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, d, H * hd, dtype, device=device),
         "wk": dense_init(generator, d, KH * hd, dtype, device=device),
         "wv": dense_init(generator, d, KH * hd, dtype, device=device),
         "wo": dense_init(generator, H * hd, d, dtype, device=device)}
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KH * hd), ("bv", KH * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def attention_qkv(p, x, cfg):
    H, KH = cfg.num_heads, cfg.num_kv_heads
    q, k, v = dot(x, p["wq"]), dot(x, p["wk"]), dot(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (spmd.split_heads(q, H), spmd.split_heads(k, KH),
            spmd.split_heads(v, KH))


def attention_forward(p, x, cfg):
    """Full-sequence (prefill) causal self-attention at positions 0..S-1,
    windowed when cfg.sliding_window > 0, through the flash kernel.
    Returns (out, (k, v)), k roped."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(p, x, cfg)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = spmd.attention(flash_attention, q.contiguous(), k.contiguous(),
                       v.contiguous(), causal=True, window=cfg.sliding_window)
    return spmd.reduce_partial(dot(o.reshape(B, S, -1), p["wo"])), (k, v)


def attention_decode(p, x, cfg, cache_k, cache_v, cache_pos, pos):
    """One-token decode against a rolling KV cache, updated in place.

    x: (B, 1, d); cache_k/v: (B, W, KH, hd); cache_pos: (B, W) absolute
    positions (-1 = empty); pos: (B,) current absolute position.  The new
    K/V land in slot pos % W; returns the attention output (B, 1, d)."""
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = attention_qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    slot = pos % W
    bidx = torch.arange(B, device=x.device)
    spmd.put_rows(cache_k, bidx, slot, k[:, 0].to(cache_k.dtype))
    spmd.put_rows(cache_v, bidx, slot, v[:, 0].to(cache_v.dtype))
    spmd.put_rows(cache_pos, bidx, slot, pos.to(cache_pos.dtype))
    o = decode_attention(q, cache_k, cache_v, pos[:, None], cache_pos,
                         causal=True, window=cfg.sliding_window)
    return spmd.reduce_partial(dot(o.reshape(B, 1, -1), p["wo"]))


def init_mlp(generator, d_model, d_ff, dtype=torch.float32, gated=True,
             device=None):
    """SwiGLU MLP (`w_gate` too) when gated, else the DiT's GELU MLP."""
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
         "w_down": dense_init(generator, d_ff, d_model, dtype, device=device)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype,
                                 device=device)
    return p


def mlp_forward(p, x):
    """SwiGLU when the params hold `w_gate`, else GELU.  JAX's gelu defaults
    to the tanh approximation, so the port uses it too."""
    if "w_gate" in p:
        h = F.silu(dot(x, p["w_gate"])) * dot(x, p["w_up"])
    else:
        h = F.gelu(dot(x, p["w_up"]), approximate="tanh")
    return spmd.reduce_partial(dot(h, p["w_down"]))
