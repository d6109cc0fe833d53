"""Decoder LM of the port: the `hybrid` family (zamba2) of the JAX
`models/transformer.py`.  The dense, ssm, moe and vlm families are not
ported yet and raise (ROADMAP.md §A).

Entry points, plain functions of (params, inputs, cfg):

  init_lm(generator, cfg)                          -> params
  forward(params, tokens, cfg, collect_kv=...)     -> logits[, caches]
  prefill(params, tokens, cfg, cache_len)          -> (logits, cache)
  decode_step(params, token, pos, cache, cfg)      -> (logits, cache)

Per-layer params are stacked on a leading layer axis, as in JAX; the port
walks the layers in a Python loop where JAX scans.  A hybrid model runs
`hybrid_attn_every` Mamba2 layers, then the one shared attention+MLP block,
`num_layers // hybrid_attn_every` times.  KV caches are rolling buffers of
capacity `cache_len` with absolute positions stored beside them.
`decode_step` updates the cache in place (JAX returns a new one) so that a
step does not copy the whole SSM state.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import layer_params

from .layers import (attention_decode, attention_forward, dense_init, dot,
                     embed_init, init_attention, init_mlp, mlp_forward,
                     rms_norm)
from .ssm import init_mamba2, mamba2_decode, mamba2_forward


def _require_hybrid(cfg):
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"repro_torch ports only the hybrid LLM family so far ('{cfg.name}' "
            f"is '{cfg.family}'); see ROADMAP.md §A")


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_block(generator, cfg, dtype, device):
    """One layer's params (unstacked)."""
    return {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "mamba": init_mamba2(generator, cfg, dtype, device)}


def init_lm(generator, cfg, dtype=None, device=None):
    _require_hybrid(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    d = cfg.d_model
    blocks = _stack([_init_block(generator, cfg, dtype, device)
                     for _ in range(cfg.num_layers)])
    return {
        "embed": embed_init(generator, cfg.vocab_size, d, dtype, device),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": dense_init(generator, d, cfg.vocab_size, dtype,
                              device=device),
        # one *shared* attention+MLP block reused at every application point
        "shared_attn": {
            "ln1": torch.ones((d,), dtype=dtype, device=device),
            "attn": init_attention(generator, cfg, dtype, device),
            "ln2": torch.ones((d,), dtype=dtype, device=device),
            "mlp": init_mlp(generator, d, cfg.d_ff, dtype, device=device),
        },
    }


def hybrid_points(cfg) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


def _shared_block(sp, x, cfg):
    h, kv = attention_forward(sp["attn"], rms_norm(x, sp["ln1"], cfg.norm_eps),
                              cfg)
    x = x + h
    return x + mlp_forward(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps)), kv


def forward(params, tokens, cfg, *, collect_kv=False):
    """Full-sequence forward.  tokens: (B, S) integer.

    Returns logits (B, S, vocab), or (logits, caches) with collect_kv, where
    caches holds per attention point (Mamba2 caches of its segment, (k, v)).
    JAX also returns the MoE losses, which this family does not have."""
    _require_hybrid(cfg)
    x = params["embed"][tokens]
    k = cfg.hybrid_attn_every
    caches = []
    for g in range(hybrid_points(cfg)):
        states = []
        for i in range(g * k, (g + 1) * k):
            p = layer_params(params["blocks"], i)
            h, c = mamba2_forward(p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                  cfg)
            x = x + h
            states.append(c)
        x, kv = _shared_block(params["shared_attn"], x, cfg)
        if collect_kv:
            caches.append((states, kv))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dot(x, params["lm_head"])
    return (logits, caches) if collect_kv else logits


def init_cache(cfg, batch: int, cache_len: int, device=None):
    """Empty decode cache with capacity cache_len."""
    _require_hybrid(cfg)
    dtype = getattr(torch, cfg.dtype)
    L, B, W = cfg.num_layers, batch, cache_len
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    npts = hybrid_points(cfg)
    kv = (npts, B, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "conv": torch.zeros((L, B, cfg.ssm_conv, din + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
        "state": torch.zeros((L, B, nh, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.full((B, W), -1, dtype=torch.long, device=device),
    }


def decode_step(params, token, pos, cache, cfg):
    """token: (B,) integer; pos: (B,) absolute position.  Returns (logits,
    cache); the cache is updated in place."""
    _require_hybrid(cfg)
    x = params["embed"][token][:, None, :]                      # (B, 1, d)
    sp = params["shared_attn"]
    k = cfg.hybrid_attn_every
    for g in range(hybrid_points(cfg)):
        for i in range(g * k, (g + 1) * k):
            p = layer_params(params["blocks"], i)
            h, conv, state = mamba2_decode(
                p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                cache["conv"][i], cache["state"][i])
            cache["conv"][i] = conv
            cache["state"][i] = state
            x = x + h
        h = attention_decode(sp["attn"], rms_norm(x, sp["ln1"], cfg.norm_eps),
                             cfg, cache["k"][g], cache["v"][g], cache["pos"],
                             pos)
        x = x + h
        x = x + mlp_forward(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dot(x, params["lm_head"])[:, 0], cache


def prefill(params, tokens, cfg, cache_len: int):
    """Returns (logits (B, S, vocab), cache ready for decode at pos = S)."""
    logits, collected = forward(params, tokens, cfg, collect_kv=True)
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len, device=tokens.device)
    keep = min(S, cache_len)
    src = torch.arange(S - keep, S, device=tokens.device)
    slots = src % cache_len
    mamba = [c for states, _ in collected for c in states]
    cache["state"] = torch.stack([c["state"] for c in mamba])
    cache["conv"] = torch.stack([c["conv"] for c in mamba]).to(
        cache["conv"].dtype)
    for g, (_, (kk, vv)) in enumerate(collected):
        cache["k"][g][:, slots] = kk[:, src].to(cache["k"].dtype)
        cache["v"][g][:, slots] = vv[:, src].to(cache["v"].dtype)
    cache["pos"][:, slots] = src
    return logits, cache
