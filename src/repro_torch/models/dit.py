"""Diffusion Transformer (DiT) with AdaLN-zero conditioning (survey
Eq. 11-13) — the port of the JAX `models/dit.py` for class-conditioned
DiTs (image latents; audio mel latents use it unchanged).  Text
cross-attention is not ported yet (ROADMAP.md §A.4); the video backbone is
`models/video_dit.py`.

Params keep the JAX layout: `(in, out)` matrices and a leading layer axis
on every `blocks` leaf; `forward` loops over layers in Python.

Dtypes follow JAX's promotion.  With bf16 params and f32 latents the
token path (patch embedding, QKV, attention, MLP) runs in f32 over
bf16-stored weights, while the conditioning path stays bf16 because the
timestep embedding is cast to `t_mlp1`'s dtype.  The self-attention goes
through the flash kernel (`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.engine import layer_params
from repro_torch.kernels import flash_attention

from .encdec import sinusoidal_positions
from .layers import dense_init, dot, init_mlp, layer_norm, mlp_forward


def timestep_embedding(t, dim):
    """t: (B,) float -> (B, dim)."""
    return sinusoidal_positions(t, dim)


def _init_dit_block(gen, cfg, dtype, device):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    # The JAX init draws wq and wk from one key, and wv and wo from another
    # (dit.py:29-32), so wk == wq and wo holds wv's draws reshaped.  The
    # port keeps that structure so its random models match in distribution.
    raw_qk = torch.randn((d, H * hd), generator=gen, device=device)
    raw_vo = torch.randn((d, H * hd), generator=gen, device=device)
    wq = (raw_qk / d ** 0.5).to(dtype)
    return {
        "attn": {"wq": wq, "wk": wq.clone(),
                 "wv": (raw_vo / d ** 0.5).to(dtype),
                 "wo": (raw_vo.reshape(H * hd, d) / (H * hd) ** 0.5).to(dtype)},
        "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=False, device=device),
        "ada_w": torch.zeros((d, 6 * d), dtype=dtype, device=device),
        "ada_b": torch.zeros((6 * d,), dtype=dtype, device=device),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_dit(generator, cfg, dtype=None, device=None):
    dtype = dtype or getattr(torch, cfg.dtype)
    d, gen = cfg.d_model, generator
    blocks = _stack([_init_dit_block(gen, cfg, dtype, device)
                     for _ in range(cfg.num_layers)])
    class_embed = torch.randn((cfg.dit_num_classes + 1, d), generator=gen,
                              device=device) * 0.02
    return {
        "patch_in": dense_init(gen, cfg.dit_in_dim, d, dtype, device=device),
        "t_mlp1": dense_init(gen, d, d, dtype, device=device),
        "t_mlp2": dense_init(gen, d, d, dtype, device=device),
        "class_embed": class_embed.to(dtype),
        "blocks": blocks,
        "final_ada_w": torch.zeros((d, 2 * d), dtype=dtype, device=device),
        "final_ada_b": torch.zeros((2 * d,), dtype=dtype, device=device),
        "patch_out": torch.zeros((d, cfg.dit_in_dim), dtype=dtype,
                                 device=device),
    }


def condition(params, t, y, cfg, y_embed=None):
    """(B,) timestep + (B,) class -> (B, d) conditioning vector.  `y_embed`
    (B, d) replaces the class-embedding lookup."""
    te = timestep_embedding(t.float(), cfg.d_model)
    te = F.silu(dot(te.to(params["t_mlp1"].dtype), params["t_mlp1"]))
    te = dot(te, params["t_mlp2"])
    ce = params["class_embed"][y.long()] if y_embed is None else y_embed
    return te + ce.to(te.dtype)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _adaln(c, w, b, n):
    return (dot(F.silu(c), w) + b).chunk(n, dim=-1)


def dit_block(p, x, c, cfg):
    """One DiT block.  x: (B, T, d); c: (B, d) conditioning."""
    B, T, _ = x.shape
    s1, sc1, g1, s2, sc2, g2 = _adaln(c, p["ada_w"], p["ada_b"], 6)
    h = _modulate(layer_norm(x), s1, sc1)
    H, hd = cfg.num_heads, cfg.head_dim
    q = dot(h, p["attn"]["wq"]).reshape(B, T, H, hd)
    k = dot(h, p["attn"]["wk"]).reshape(B, T, H, hd)
    v = dot(h, p["attn"]["wv"]).reshape(B, T, H, hd)
    o = flash_attention(q, k, v, causal=False)
    x = x + g1[:, None, :] * dot(o.reshape(B, T, H * hd), p["attn"]["wo"])
    h = _modulate(layer_norm(x), s2, sc2)
    return x + g2[:, None, :] * mlp_forward(p["mlp"], h)


def modulated_signal(params, x, c, cfg):
    """TeaCache's input-side signal: the first block's AdaLN-modulated input."""
    s1, sc1 = _adaln(c, params["blocks"]["ada_w"][0],
                     params["blocks"]["ada_b"][0], 6)[:2]
    return _modulate(layer_norm(x), s1, sc1)


def embed_patches(params, latents, t, y, cfg, y_embed=None):
    x = dot(latents, params["patch_in"])
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None]
    x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    return x, condition(params, t, y, cfg, y_embed)


def final_layer(params, x, c, cfg):
    s, sc = _adaln(c, params["final_ada_w"], params["final_ada_b"], 2)
    return dot(_modulate(layer_norm(x), s, sc), params["patch_out"])


def forward(params, latents, t, y, cfg, *, y_embed=None):
    """latents: (B, T, in_dim); t: (B,); y: (B,) -> noise prediction."""
    x, c = embed_patches(params, latents, t, y, cfg, y_embed)
    for i in range(cfg.num_layers):
        x = dit_block(layer_params(params["blocks"], i), x, c, cfg)
    return final_layer(params, x, c, cfg)
