"""Factorized spatio-temporal DiT (Latte / OpenSora style) — the port of the
JAX `models/video_dit.py`, the video backbone of the survey's multi-modal
caching claims; a config with `dit_text_len > 0` (dit-t2v) adds a
cross-attention branch over prompt embeddings after spatial attention.

A latent *clip* carries `F = cfg.dit_num_frames` frames of
`P = cfg.dit_patch_tokens` patches each, flattened to (B, F*P, in_dim) so
the cache and serving stack sees the image DiT's (batch, tokens, channels)
layout.  Each block factorizes attention along the two axes:

  spatial attention   — over the P patches of each frame (frames folded
                        into the batch axis: B*F sequences of P),
  temporal attention  — over the F frames at each patch position (patches
                        folded into the batch axis: B*P sequences of F),
  MLP                 — pointwise,

each branch AdaLN-zero gated (9 modulation vectors per block).  The three
branch functions are exposed separately because Pyramid Attention
Broadcast caches them at different intervals
(repro_torch.core.temporal.TemporalPABStack).

Both factorized attentions go through the flash kernel
(`repro_torch.kernels.flash_attention`), where JAX calls
`blocked_attention`: the same function on another route, as in
`models/dit.py`.  Params keep the JAX layout (a leading layer axis on every
`blocks` leaf) and dtypes follow JAX's promotion: bf16 params under f32
latents give an f32 token path.  The cross-attention is
`models.dit.cross_attn_branch` on the flat (B, F*P, d) layout: per-query
softmax over the shared text keys makes that identical to a frame-folded
form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.core.engine import layer_params
from repro_torch.kernels import flash_attention

from .dit import (_modulate, _stack, condition, cross_attn_branch,
                  cross_attn_embed_branch, resolve_txt)
from .encdec import sinusoidal_positions
from .layers import dense_init, dot, init_mlp, layer_norm, mlp_forward

#: the three PAB module types of a factorized block, in execution order
#: (text-enabled configs insert cross_attn after spatial_attn — see
#: block_branches)
BRANCHES = ("spatial_attn", "temporal_attn", "mlp")


def _init_attn(gen, d, H, hd, dtype, device):
    # JAX draws wq and wk from one key and wv and wo from another, so
    # wk == wq and wo holds wv's draws reshaped (as models/dit.py keeps it)
    raw_qk = torch.randn((d, H * hd), generator=gen, device=device)
    raw_vo = torch.randn((d, H * hd), generator=gen, device=device)
    wq = (raw_qk / d ** 0.5).to(dtype)
    return {"wq": wq, "wk": wq.clone(),
            "wv": (raw_vo / d ** 0.5).to(dtype),
            "wo": (raw_vo.reshape(H * hd, d) / (H * hd) ** 0.5).to(dtype)}


def _init_video_block(gen, cfg, dtype, device):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    block = {
        "spatial": _init_attn(gen, d, H, hd, dtype, device),
        "temporal": _init_attn(gen, d, H, hd, dtype, device),
        "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=False, device=device),
        # AdaLN-zero: 3 branches x (shift, scale, gate); gates init to zero
        "ada_w": torch.zeros((d, 9 * d), dtype=dtype, device=device),
        "ada_b": torch.zeros((9 * d,), dtype=dtype, device=device),
    }
    if cfg.dit_text_len > 0:
        # text cross-attention branch: its own AdaLN-zero triple, the image
        # DiT's param layout so dit.text_kv works on both
        block["cross"] = _init_attn(gen, d, H, hd, dtype, device)
        block["cross_ada_w"] = torch.zeros((d, 3 * d), dtype=dtype,
                                           device=device)
        block["cross_ada_b"] = torch.zeros((3 * d,), dtype=dtype,
                                           device=device)
    return block


def init_video_dit(generator, cfg, dtype=None, device=None):
    dtype = dtype or getattr(torch, cfg.dtype)
    d, gen = cfg.d_model, generator
    blocks = _stack([_init_video_block(gen, cfg, dtype, device)
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


def _branch_mod(p, c, name):
    """One branch's (shift, scale, gate): its third of the block's 9 AdaLN
    modulation vectors, projected alone, so that a block projects each
    third once and a step that reuses a branch's cached output does not
    project that branch's third."""
    i = BRANCHES.index(name)
    cols = slice(3 * i * c.shape[-1], 3 * (i + 1) * c.shape[-1])
    return (dot(F.silu(c), spmd.gathered(p["ada_w"], 1)[:, cols])
            + p["ada_b"][cols]).chunk(3, dim=-1)


def _attend(ap, h, fold, unfold, cfg):
    """One factorized attention: fold an axis into batch, project (q, k, v
    come out contiguous, as the kernel needs), attend, apply wo, unfold."""
    hf = fold(h)
    B, T, _ = hf.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (spmd.split_heads(dot(hf, ap[w]), H)
               for w in ("wq", "wk", "wv"))
    o = spmd.attention(flash_attention, q, k, v, causal=False)
    return unfold(spmd.reduce_partial(dot(o.reshape(B, T, H * hd),
                                          ap["wo"])))


def _norm_mod(x, shift, scale):
    return _modulate(layer_norm(x), shift, scale)


def spatial_branch(p, x, c, cfg):
    """Gated spatial-attention residual: attention over the P patches of
    each frame.  x: (B, F*P, d)."""
    B, T, d = x.shape
    Fr = cfg.dit_num_frames
    P = T // Fr
    s, sc, g = _branch_mod(p, c, "spatial_attn")
    o = _attend(p["spatial"], _norm_mod(x, s, sc),
                lambda a: a.reshape(B * Fr, P, d),
                lambda a: a.reshape(B, Fr * P, d), cfg)
    return g[:, None, :] * o


def temporal_branch(p, x, c, cfg):
    """Gated temporal-attention residual: attention over the F frames at
    each patch position."""
    B, T, d = x.shape
    Fr = cfg.dit_num_frames
    P = T // Fr
    s, sc, g = _branch_mod(p, c, "temporal_attn")
    o = _attend(
        p["temporal"], _norm_mod(x, s, sc),
        lambda a: a.reshape(B, Fr, P, d).transpose(1, 2).reshape(B * P, Fr, d),
        lambda a: a.reshape(B, P, Fr, d).transpose(1, 2).reshape(B, Fr * P, d),
        cfg)
    return g[:, None, :] * o


def mlp_branch(p, x, c, cfg):
    s, sc, g = _branch_mod(p, c, "mlp")
    return g[:, None, :] * mlp_forward(p["mlp"], _norm_mod(x, s, sc))


BRANCH_FNS = {"spatial_attn": spatial_branch, "temporal_attn": temporal_branch,
              "mlp": mlp_branch}


def block_branches(cfg):
    """Module types this backbone's blocks expose as separately cacheable
    branches, in execution order (the PAB vocabulary)."""
    return (("spatial_attn", "cross_attn", "temporal_attn", "mlp")
            if cfg.dit_text_len > 0 else BRANCHES)


def pab_branch_fns(cfg):
    """The factorized branches bound to `cfg`, keyed by PAB module type:
    fn(layer_params, x, c) -> the branch's gated residual output.

    Text-enabled configs add the cross_attn branch (broadcast over the
    longest range: text is step-invariant) and every branch takes the
    stack's args (c, te, tm); the cross branch projects its K/V inline
    from the prompt embeddings on the steps it refreshes."""
    if cfg.dit_text_len > 0:
        fns = {name: (lambda p, x, c, te, tm, fn=fn: fn(p, x, c, cfg))
               for name, fn in BRANCH_FNS.items()}
        fns["cross_attn"] = (lambda p, x, c, te, tm:
                             cross_attn_embed_branch(p, x, c, te, tm, cfg))
        return {name: fns[name] for name in block_branches(cfg)}
    return {name: (lambda p, x, c, fn=fn: fn(p, x, c, cfg))
            for name, fn in BRANCH_FNS.items()}


def video_block(p, x, c, cfg, txt=None):
    """One factorized block: the gated residual branches in order; txt
    ((tk, tv, tm) per-layer text K/V + mask) inserts the cross-attention
    branch after spatial attention."""
    for name in BRANCHES:
        x = x + BRANCH_FNS[name](p, x, c, cfg)
        if name == "spatial_attn" and txt is not None:
            x = x + cross_attn_branch(p, x, c, *txt, cfg)
    return x


def embed_patches(params, latents, t, y, cfg, y_embed=None):
    """(B, F*P, in_dim) -> tokens with factorized positions + conditioning."""
    x = dot(latents, params["patch_in"])
    Fr = cfg.dit_num_frames
    P = x.shape[1] // Fr
    d = cfg.d_model
    spat = sinusoidal_positions(torch.arange(P, device=x.device)[None], d)
    temp = sinusoidal_positions(torch.arange(Fr, device=x.device)[None], d)
    pos = spat.repeat(1, Fr, 1) + temp.repeat_interleave(P, dim=1)
    return x + pos.to(x.dtype), condition(params, t, y, cfg, y_embed)


def modulated_signal(params, x, c, cfg):
    """TeaCache's input-side signal for the video backbone: the first
    block's spatial-branch modulated input (dit.modulated_signal's
    analogue)."""
    s, sc, _ = _branch_mod(layer_params(params["blocks"], 0), c, "spatial_attn")
    return _norm_mod(x, s, sc)


def final_layer(params, x, c, cfg):
    s, sc = (dot(F.silu(c), params["final_ada_w"])
             + params["final_ada_b"]).chunk(2, dim=-1)
    return dot(_norm_mod(x, s, sc), params["patch_out"])


def forward(params, latents, t, y, cfg, *, y_embed=None, txt_kv=None,
            txt_mask=None, txt_embed=None):
    """latents: (B, F*P, in_dim); t: (B,); y: (B,) -> noise prediction.
    Text operands as in dit.forward (precomputed txt_kv or inline
    txt_embed, both optional)."""
    x, c = embed_patches(params, latents, t, y, cfg, y_embed)
    tk = tv = tm = None
    if cfg.dit_text_len > 0:
        tk, tv, tm = resolve_txt(params, cfg, x.shape[0], txt_kv=txt_kv,
                                 txt_mask=txt_mask, txt_embed=txt_embed,
                                 dtype=x.dtype, device=x.device)
    for i in range(cfg.num_layers):
        txt = None if tk is None else (tk[:, i], tv[:, i], tm)
        x = video_block(layer_params(params["blocks"], i), x, c, cfg, txt=txt)
    return final_layer(params, x, c, cfg)
