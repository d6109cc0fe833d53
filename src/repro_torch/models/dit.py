"""Diffusion Transformer (DiT) with AdaLN-zero conditioning (survey
Eq. 11-13) — the port of the JAX `models/dit.py`: class-conditioned DiTs
(image latents; audio mel latents use it unchanged) and, for a config with
`dit_text_len > 0`, an AdaLN-zero-gated cross-attention branch per block
over prompt embeddings (dit-t2i).  The video backbone is
`models/video_dit.py`.

Params keep the JAX layout: `(in, out)` matrices and a leading layer axis
on every `blocks` leaf; `forward` loops over layers in Python.

Dtypes follow JAX's promotion.  With bf16 params and f32 latents the
token path (patch embedding, QKV, attention, MLP) runs in f32 over
bf16-stored weights, while the conditioning path stays bf16 because the
timestep embedding is cast to `t_mlp1`'s dtype.  The self-attention goes
through the flash kernel (`repro_torch.kernels.flash_attention`).  The
cross-attention stays plain PyTorch (einsum, a -1e9 key mask, softmax,
einsum), as JAX computes it outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import spmd
from repro_torch.core.engine import layer_list
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
    block = {
        "attn": {"wq": wq, "wk": wq.clone(),
                 "wv": (raw_vo / d ** 0.5).to(dtype),
                 "wo": (raw_vo.reshape(H * hd, d) / (H * hd) ** 0.5).to(dtype)},
        "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=False, device=device),
        "ada_w": torch.zeros((d, 6 * d), dtype=dtype, device=device),
        "ada_b": torch.zeros((6 * d,), dtype=dtype, device=device),
    }
    if cfg.dit_text_len > 0:
        # the text cross-attention branch with its own AdaLN-zero triple.
        # JAX draws its wq and wk from one new key and reuses the self-
        # attention's keys for wv and wo (dit.py:39-42), so cross wv equals
        # attn wq and cross wo equals attn wo
        raw = torch.randn((d, H * hd), generator=gen, device=device)
        cq = (raw / d ** 0.5).to(dtype)
        block["cross"] = {"wq": cq, "wk": cq.clone(), "wv": wq.clone(),
                          "wo": block["attn"]["wo"].clone()}
        block["cross_ada_w"] = torch.zeros((d, 3 * d), dtype=dtype,
                                           device=device)
        block["cross_ada_b"] = torch.zeros((3 * d,), dtype=dtype,
                                           device=device)
    return block


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


# ----------------------------------------------------------------------
# text cross-attention (repro_torch.conditioning; survey's T2I/T2V scenario)
# ----------------------------------------------------------------------

def cross_attn_kv(p_cross, te):
    """One layer's text K/V projections.  te: (B, L, d) prompt embeddings
    -> (k, v) each (B, L, H*hd)."""
    return dot(te, p_cross["wk"]), dot(te, p_cross["wv"])


def text_kv(params, te, cfg):
    """All layers' text K/V at once: (B, L, d) -> (k, v) each
    (B, num_layers, L, H*hd), in the promoted dtype (f32 embeddings over
    bf16 weights give f32, as in JAX).  Computed once per prompt and
    reused by every denoise step."""
    del cfg
    wk = params["blocks"]["cross"]["wk"]          # (nl, d, H*hd)
    wv = params["blocks"]["cross"]["wv"]
    dt = torch.promote_types(te.dtype, wk.dtype)
    te = te.to(dt)
    return (torch.einsum("bld,ndh->bnlh", te, wk.to(dt)),
            torch.einsum("bld,ndh->bnlh", te, wv.to(dt)))


def cross_attention(q, k, v, tm):
    """q: (B, T, H, hd) latent queries over k, v: (B, L, H, hd) text keys
    with tm: (B, L) bool key mask -> (B, T, H, hd).  Masked logits are
    replaced by -1e9 (JAX's `jnp.where`, dit.py:125), never an additive
    bias: a fully masked row then takes a uniform softmax over zero values
    and returns exactly 0."""
    logits = torch.einsum("bthd,blhd->bhtl", q, k) / math.sqrt(q.shape[-1])
    logits = torch.where(tm[:, None, None, :], logits,
                         torch.full((), -1e9, dtype=logits.dtype,
                                    device=logits.device))
    return torch.einsum("bhtl,blhd->bthd", torch.softmax(logits, dim=-1), v)


def cross_attn_branch(p, x, c, tk, tv, tm, cfg):
    """Gated cross-attention residual: latent queries over text keys.

    tk/tv: (B, L, H*hd) this layer's text K/V; tm: (B, L) bool key mask.
    The branch has its own AdaLN-zero triple (cross_ada_w/b, on the
    conditioning path's dtype).  K/V tables are zeroed at masked positions,
    so a prompt-less row adds exactly 0."""
    B, T, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    s, sc, g = _adaln(c, p["cross_ada_w"], p["cross_ada_b"], 3)
    h = _modulate(layer_norm(x), s, sc)
    q = spmd.split_heads(dot(h, p["cross"]["wq"]), H)
    k = spmd.split_heads(tk, H).to(q.dtype)
    v = spmd.split_heads(tv, H).to(q.dtype)
    o = spmd.attention(cross_attention, q, k, v, tm)
    return g[:, None, :] * spmd.reduce_partial(
        dot(o.reshape(B, T, H * hd), p["cross"]["wo"]))


def cross_attn_embed_branch(p, x, c, te, tm, cfg):
    """cross_attn_branch with K/V projected inline from the prompt
    embeddings (the form the PAB branch stack uses)."""
    tk, tv = cross_attn_kv(p["cross"], te.to(x.dtype))
    return cross_attn_branch(p, x, c, tk, tv, tm, cfg)


def block_branches(cfg):
    """Module types this backbone's blocks expose as separately cacheable
    branches (PAB's vocabulary)."""
    return (("spatial_attn", "cross_attn", "mlp") if cfg.dit_text_len > 0
            else ("spatial_attn", "mlp"))


def dit_block(p, x, c, cfg, txt=None):
    """One DiT block.  x: (B, T, d); c: (B, d) conditioning; txt: optional
    (tk, tv, tm) per-layer text K/V + mask (see cross_attn_branch)."""
    B, T, _ = x.shape
    s1, sc1, g1, s2, sc2, g2 = _adaln(c, p["ada_w"], p["ada_b"], 6)
    h = _modulate(layer_norm(x), s1, sc1)
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (spmd.split_heads(dot(h, p["attn"][w]), H)
               for w in ("wq", "wk", "wv"))
    o = spmd.attention(flash_attention, q, k, v, causal=False)
    x = x + g1[:, None, :] * spmd.reduce_partial(
        dot(o.reshape(B, T, H * hd), p["attn"]["wo"]))
    if txt is not None:
        x = x + cross_attn_branch(p, x, c, *txt, cfg)
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


def resolve_txt(params, cfg, batch, *, txt_kv=None, txt_mask=None,
                txt_embed=None, dtype=torch.float32, device=None):
    """Normalize a text-conditioning operand set to (tk, tv, tm) with
    tk/tv (B, nl, L, H*hd) and tm (B, L) bool: zero tables and an
    all-False mask when no text is supplied, so a text-enabled backbone
    stays an exact no-op for prompt-less batches."""
    if txt_embed is not None and txt_kv is None:
        mask = (torch.ones((batch, cfg.dit_text_len), dtype=torch.bool,
                           device=txt_embed.device)
                if txt_mask is None else txt_mask)
        txt_kv = text_kv(params, torch.where(mask[..., None], txt_embed,
                                             0.0), cfg)
        txt_mask = mask
    if txt_kv is None:
        width = cfg.num_heads * cfg.head_dim
        zeros = torch.zeros((batch, cfg.num_layers, cfg.dit_text_len, width),
                            dtype=dtype, device=device)
        return zeros, zeros, torch.zeros((batch, cfg.dit_text_len),
                                         dtype=torch.bool, device=device)
    tk, tv = txt_kv
    tm = (torch.ones((tk.shape[0], tk.shape[2]), dtype=torch.bool,
                     device=tk.device) if txt_mask is None else txt_mask)
    return tk, tv, tm


def forward(params, latents, t, y, cfg, *, y_embed=None, txt_kv=None,
            txt_mask=None, txt_embed=None, remat=False):
    """latents: (B, T, in_dim); t: (B,); y: (B,) -> noise prediction.
    `remat=True` recomputes each block's activations in the backward
    (`torch.utils.checkpoint`, JAX's `jax.checkpoint`).

    Text conditioning (cfg.dit_text_len > 0): pass either `txt_kv` (the
    per-layer K/V pair from text_kv, the serving path) or `txt_embed`
    (B, L, d) prompt embeddings projected here, plus `txt_mask` (B, L).
    Omitting both runs the zero-table no-op branch."""
    x, c = embed_patches(params, latents, t, y, cfg, y_embed)
    tk = tv = tm = None
    if cfg.dit_text_len > 0:
        tk, tv, tm = resolve_txt(params, cfg, x.shape[0], txt_kv=txt_kv,
                                 txt_mask=txt_mask, txt_embed=txt_embed,
                                 dtype=x.dtype, device=x.device)
    for i, p in enumerate(layer_list(params["blocks"])):
        txt = None if tk is None else (tk[:, i], tv[:, i], tm)
        x = (checkpoint(dit_block, p, x, c, cfg, txt, use_reentrant=False)
             if remat else dit_block(p, x, c, cfg, txt=txt))
    return final_layer(params, x, c, cfg)
