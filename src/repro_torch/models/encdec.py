"""Whisper-style encoder-decoder of the port (counterpart of the JAX
`models/encdec.py`), and the sinusoidal position / timestep embeddings the
DiT shares with it.

The mel + conv frontend is a stub, as in JAX: `frames` are precomputed
(B, encoder_seq, d_model) embeddings.  The decoder's cross-attention K/V
are computed ONCE from the encoder output (`cross_kv`) and reused by every
decode step: the survey's exact cache reuse under fixed conditioning.

Entry points, plain functions of (params, inputs, cfg):

  init_encdec(generator, cfg)                 -> params
  encode(params, frames, cfg)                 -> enc_out (B, S_enc, d)
  cross_kv(params, enc_out, cfg)              -> (xk, xv) (L, B, S_enc, H, hd)
  forward(params, frames, tokens, cfg)        -> logits (B, S_dec, vocab)
  init_dec_cache(cfg, batch, cache_len, enc_seq) -> cache
  decode_step(params, token, pos, cache, cfg) -> (logits (B, vocab), cache)

Pre-LN layer norms, GELU MLPs, multi-head attention (no GQA, no RoPE) and
sinusoidal positions on both sides, as JAX has them.  Full-sequence
attention (the encoder's, the decoder's causal self-attention and its
cross-attention over the encoder output) goes through the flash kernel;
one-token decode attends with `blocked_attention`, against the rolling
self-attention cache and the cached cross K/V, as JAX does.  Per-layer
params are stacked on a leading layer axis and walked in a Python loop
where JAX scans.  `decode_step` updates the cache in place (JAX returns a
new one), as `transformer.decode_step` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch import spmd
from repro_torch.core.engine import layer_list
from repro_torch.kernels import flash_attention

from .layers import (decode_attention, dense_init, dot, embed_init, init_mlp,
                     layer_norm, mlp_forward)
from .transformer import _stacked


def sinusoidal_positions(positions, d_model):
    """positions: (..., S) -> (..., S, d_model) float32."""
    half = d_model // 2
    idx = torch.arange(half, device=positions.device, dtype=torch.float32)
    freqs = torch.exp(-math.log(10000.0) * idx / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_ln(d, dtype, device):
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def _init_xattn(generator, cfg, dtype, device):
    d, w = cfg.d_model, cfg.num_heads * cfg.head_dim
    return {"wq": dense_init(generator, d, w, dtype, device=device),
            "wk": dense_init(generator, d, w, dtype, device=device),
            "wv": dense_init(generator, d, w, dtype, device=device),
            "wo": dense_init(generator, w, d, dtype, device=device)}


def _init_enc_block(generator, cfg, dtype, device):
    d = cfg.d_model
    return {"ln1": _init_ln(d, dtype, device),
            "attn": _init_xattn(generator, cfg, dtype, device),
            "ln2": _init_ln(d, dtype, device),
            "mlp": init_mlp(generator, d, cfg.d_ff, dtype, gated=False,
                            device=device)}


def _init_dec_block(generator, cfg, dtype, device):
    d = cfg.d_model
    return {"ln1": _init_ln(d, dtype, device),
            "self": _init_xattn(generator, cfg, dtype, device),
            "ln2": _init_ln(d, dtype, device),
            "cross": _init_xattn(generator, cfg, dtype, device),
            "ln3": _init_ln(d, dtype, device),
            "mlp": init_mlp(generator, d, cfg.d_ff, dtype, gated=False,
                            device=device)}


def init_encdec(generator, cfg, dtype=None, device=None):
    dtype = dtype or getattr(torch, cfg.dtype)
    d = cfg.d_model
    return {
        "enc_blocks": _stacked(cfg.num_encoder_layers, lambda: _init_enc_block(
            generator, cfg, dtype, device)),
        "enc_ln": _init_ln(d, dtype, device),
        "dec_blocks": _stacked(cfg.num_layers, lambda: _init_dec_block(
            generator, cfg, dtype, device)),
        "dec_ln": _init_ln(d, dtype, device),
        "embed": embed_init(generator, cfg.vocab_size, d, dtype, device),
        "lm_head": dense_init(generator, d, cfg.vocab_size, dtype,
                              device=device),
    }


def _ln(x, p):
    return layer_norm(x, p["w"], p["b"])


def _heads(x, w, cfg):
    return spmd.split_heads(dot(x, w), cfg.num_heads)


def _attn(p, xq, xkv, cfg, causal):
    """Multi-head attention of xq over xkv through the flash kernel."""
    B, Sq, _ = xq.shape
    q, k, v = _heads(xq, p["wq"], cfg), _heads(xkv, p["wk"], cfg), \
        _heads(xkv, p["wv"], cfg)
    o = spmd.attention(flash_attention, q, k, v, causal=causal)
    return spmd.reduce_partial(dot(o.reshape(B, Sq, -1), p["wo"]))


def _positions(S, like):
    return sinusoidal_positions(torch.arange(S, device=like.device)[None],
                                like.shape[-1]).to(like.dtype)


def encode(params, frames, cfg):
    """frames: (B, S_enc, d_model) stub frontend embeddings."""
    x = frames + _positions(frames.shape[1], frames)
    for p in layer_list(params["enc_blocks"]):
        h = _ln(x, p["ln1"])
        x = x + _attn(p["attn"], h, h, cfg, causal=False)
        x = x + mlp_forward(p["mlp"], _ln(x, p["ln2"]))
    return _ln(x, params["enc_ln"])


def cross_kv(params, enc_out, cfg):
    """Per-layer cross-attention K/V, computed ONCE per request (an exact
    cache: the conditioning is fixed across all decode steps).  Returns
    (xk, xv), each (L, B, S_enc, H, hd)."""
    kvs = [(_heads(enc_out, p["cross"]["wk"], cfg),
            _heads(enc_out, p["cross"]["wv"], cfg))
           for p in layer_list(params["dec_blocks"])]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _decoder(params, tokens, enc_out, cfg):
    x = params["embed"][tokens]
    x = x + _positions(tokens.shape[1], x)
    for p in layer_list(params["dec_blocks"]):
        h = _ln(x, p["ln1"])
        x = x + _attn(p["self"], h, h, cfg, causal=True)
        x = x + _attn(p["cross"], _ln(x, p["ln2"]), enc_out, cfg,
                      causal=False)
        x = x + mlp_forward(p["mlp"], _ln(x, p["ln3"]))
    return _ln(x, params["dec_ln"])


def forward(params, frames, tokens, cfg):
    """Training forward: (B, S_enc, d) frames + (B, S_dec) tokens ->
    logits (B, S_dec, vocab).  (JAX's `remat` memory knob is not ported.)"""
    enc_out = encode(params, frames, cfg)
    return dot(_decoder(params, tokens, enc_out, cfg), params["lm_head"])


def init_dec_cache(cfg, batch, cache_len, enc_seq, dtype=None, device=None):
    """An empty rolling self-attention cache of capacity cache_len and zero
    cross K/V of enc_seq positions (fill "xk" / "xv" from `cross_kv`)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim

    def zeros(S):
        return torch.zeros((L, batch, S, H, hd), dtype=dtype, device=device)

    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.long,
                              device=device),
            "xk": zeros(enc_seq), "xv": zeros(enc_seq)}


def decode_step(params, token, pos, cache, cfg):
    """One decoder token against the self-cache and the precomputed cross
    K/V.  token: (B,) integer; pos: (B,) absolute position.  Returns
    (logits (B, vocab), cache); the cache is updated in place."""
    B = token.shape[0]
    W = cache["k"].shape[2]
    x = spmd.embed(params["embed"], token)[:, None, :]
    x = x + sinusoidal_positions(pos[:, None], cfg.d_model).to(x.dtype)
    slot = pos % W
    bidx = torch.arange(B, device=token.device)
    spmd.put_rows(cache["pos"], bidx, slot, pos.to(cache["pos"].dtype))
    for i, p in enumerate(layer_list(params["dec_blocks"])):
        ck, cv = cache["k"][i], cache["v"][i]
        # self-attention with the rolling cache
        h = _ln(x, p["ln1"])
        q = _heads(h, p["self"]["wq"], cfg)
        spmd.put_rows(ck, bidx, slot,
                      _heads(h, p["self"]["wk"], cfg)[:, 0].to(ck.dtype))
        spmd.put_rows(cv, bidx, slot,
                      _heads(h, p["self"]["wv"], cfg)[:, 0].to(cv.dtype))
        o = decode_attention(q, ck, cv, pos[:, None], cache["pos"],
                             causal=True)
        x = x + spmd.reduce_partial(dot(o.reshape(B, 1, -1),
                                        p["self"]["wo"]))
        # cross-attention against the exact cached K/V
        q = _heads(_ln(x, p["ln2"]), p["cross"]["wq"], cfg)
        o = decode_attention(q, cache["xk"][i], cache["xv"][i], causal=False)
        x = x + spmd.reduce_partial(dot(o.reshape(B, 1, -1),
                                        p["cross"]["wo"]))
        x = x + mlp_forward(p["mlp"], _ln(x, p["ln3"]))
    x = _ln(x, params["dec_ln"])
    return dot(x, params["lm_head"])[:, 0], cache
