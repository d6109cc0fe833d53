"""Multi-head Latent Attention (deepseek-v2) of the port, the counterpart
of the JAX `models/mla.py`.

The KV cache holds only the compressed latent c_kv (rank r) and the
shared RoPE key (dr) per token.  Prefill expands k_nope and v from c_kv,
broadcasts k_rope over the heads and attends causally through the flash
kernel with q/k head dim dn + dr over v head dim dv (192 over 128 at
full width: the kernel's split instantiation; SMOKE's 48 over 32 takes
the padded route, see `kernels/flash_attention/ops.py`).

Decode is JAX's absorbed form, on the plain path as JAX computes it: W_UK
folds into the query and W_UV into the output, and attention runs over
the latents in chunks of the cache with an online softmax (JAX's
`CHUNK = 4096` rule).  JAX's rounding points are kept: `q_abs` is a
product in the model dtype, then f32; the two score products and the
context product take operands in the cache dtype and accumulate in f32
(JAX's `preferred_element_type`), which the port reproduces by rounding
the operands and multiplying in f32; the output product runs in f32,
then the model dtype, then `@ wo`.  The cache is updated in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch import spmd
from repro_torch.kernels import flash_attention

from .layers import apply_rope, dense_init, dot

CHUNK = 4096        # decode walks the cache in chunks of about this many


def init_mla(generator, cfg, dtype=torch.float32, device=None):
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def heads(width):
        w = torch.randn((H, r, width), generator=generator, device=device)
        return (w / math.sqrt(r)).to(dtype)

    p = {"wq": dense_init(generator, d, H * (dn + dr), dtype, device=device),
         "w_dkv": dense_init(generator, d, r, dtype, device=device),
         "w_kr": dense_init(generator, d, dr, dtype, device=device)}
    p["w_uk"] = heads(dn)
    p["w_uv"] = heads(dv)
    p["wo"] = dense_init(generator, H * dv, d, dtype, device=device)
    return p


def _project_q(p, x, cfg, positions):
    dn = cfg.qk_nope_head_dim
    q = spmd.split_heads(dot(x, p["wq"]), cfg.num_heads)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latents(p, x, cfg, positions):
    """(c_kv (B, S, r), k_rope (B, S, dr)) of x at `positions`."""
    c_kv = dot(x, p["w_dkv"])
    k_rope = apply_rope(dot(x, p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _einsum(eq, a, b):
    """torch.einsum under JAX's type promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def mla_forward(p, x, cfg):
    """Full-sequence MLA at positions 0..S-1 (train / prefill), causal and
    windowed when cfg.sliding_window > 0.  Returns (out, (c_kv, k_rope))."""
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)
    k_nope = _einsum("bsr,hrd->bshd", c_kv, p["w_uk"])       # (B, S, H, dn)
    v = _einsum("bsr,hrd->bshd", c_kv, p["w_uv"])            # (B, S, H, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)
                   .to(k_nope.dtype)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = spmd.attention(flash_attention, q.contiguous(), k.contiguous(),
                       v.contiguous(), causal=True, window=cfg.sliding_window,
                       scale=1.0 / math.sqrt(dn + dr))
    return spmd.reduce_partial(dot(o.reshape(B, S, -1), p["wo"])), \
        (c_kv, k_rope)


def mla_decode(p, x, cfg, cache_ckv, cache_kr, cache_pos, pos):
    """Absorbed one-token decode against the latent cache, updated in
    place.  x: (B, 1, d); cache_ckv: (B, W, r); cache_kr: (B, W, dr);
    cache_pos: (B, W) absolute positions (-1 = empty); pos: (B,).  Returns
    the attention output (B, 1, d)."""
    B, W = x.shape[0], cache_ckv.shape[1]
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    window = cfg.sliding_window
    q_nope, q_rope = _project_q(p, x, cfg, pos[:, None])      # (B, 1, H, .)
    c_kv, k_rope = _latents(p, x, cfg, pos[:, None])
    slot = pos % W
    bidx = torch.arange(B, device=x.device)
    spmd.put_rows(cache_ckv, bidx, slot, c_kv[:, 0].to(cache_ckv.dtype))
    spmd.put_rows(cache_kr, bidx, slot, k_rope[:, 0].to(cache_kr.dtype))
    spmd.put_rows(cache_pos, bidx, slot, pos.to(cache_pos.dtype))

    # absorbed query: works on the latents directly
    q_abs = _einsum("bohd,hrd->bohr", q_nope, p["w_uk"])[:, 0].float()
    q_r = q_rope[:, 0].float()                                # (B, H, dr)
    scale = 1.0 / math.sqrt(dn + dr)
    qa = q_abs.to(cache_ckv.dtype).float()                    # operands as the
    qr = q_r.to(cache_kr.dtype).float()                       # cache holds them

    nc = max(W // CHUNK, 1)
    Wc = W // nc
    if nc * Wc != W:
        raise ValueError(f"mla_decode: a cache of {W} does not split into "
                         f"{nc} chunks (JAX's rule: W // {CHUNK} equal ones)")
    m = torch.full((B, H), -1e30, device=x.device)            # running max
    l = torch.zeros((B, H), device=x.device)                  # running denom
    acc = torch.zeros((B, H, cache_ckv.shape[-1]), device=x.device)
    for c in range(nc):
        ckv = cache_ckv[:, c * Wc:(c + 1) * Wc].float()
        kr = cache_kr[:, c * Wc:(c + 1) * Wc].float()
        kpos = cache_pos[:, c * Wc:(c + 1) * Wc]
        s = torch.einsum("bhr,bwr->bhw", qa, ckv)
        s = (s + torch.einsum("bhd,bwd->bhw", qr, kr)) * scale
        ok = (kpos[:, None, :] <= pos[:, None, None]) & (kpos[:, None, :] >= 0)
        if window > 0:
            ok = ok & (pos[:, None, None] - kpos[:, None, :] < window)
        s = torch.where(ok, s, torch.full((), -1e30, device=x.device))
        m_new = torch.maximum(m, s.amax(-1))
        pcs = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + pcs.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhw,bwr->bhr", pcs.to(cache_ckv.dtype).float(), ckv)
        m = m_new
    ctx = acc / torch.clamp(l, min=1e-30)[..., None]          # (B, H, r)
    o = torch.einsum("bhr,hrd->bhd", ctx.to(p["w_uv"].dtype).float(),
                     p["w_uv"].float())
    return spmd.reduce_partial(dot(o.reshape(B, 1, -1).to(x.dtype), p["wo"]))


__all__ = ["CHUNK", "init_mla", "mla_forward", "mla_decode"]
