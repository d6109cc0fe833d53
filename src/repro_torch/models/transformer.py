"""Decoder LM of the port: the `dense` (Llama-style GQA) and `hybrid`
(zamba2) families of the JAX `models/transformer.py`.  The ssm, moe and vlm
families are not ported yet and raise (ROADMAP.md §A.7).

Entry points, plain functions of (params, inputs, cfg):

  init_lm(generator, cfg)                          -> params
  forward(params, tokens, cfg, collect_kv=...)     -> logits[, caches]
  prefill(params, tokens, cfg, cache_len)          -> (logits, cache)
  decode_step(params, token, pos, cache, cfg)      -> (logits, cache)

Per-layer params are stacked on a leading layer axis, as in JAX; the port
walks the layers in a Python loop where JAX scans (one unbind per stacked
leaf, so that under autograd each leaf gets one stacked gradient).  A dense
layer is pre-norm attention then a pre-norm SwiGLU MLP.  A hybrid model
runs `hybrid_attn_every` Mamba2 layers, then the one shared attention+MLP
block, `num_layers // hybrid_attn_every` times.  Prefill attention goes
through the flash kernel; one-token decode attends with
`blocked_attention`.  KV caches are rolling buffers of capacity
`cache_len` with absolute positions stored beside them.  `decode_step`
updates the cache in place (JAX returns a new one) so that a step does not
copy the whole cache.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import layer_list

from .layers import (attention_decode, attention_forward, dense_init, dot,
                     embed_init, init_attention, init_mlp, mlp_forward,
                     rms_norm)
from .ssm import init_mamba2, mamba2_decode, mamba2_forward

FAMILIES = ("dense", "hybrid")


def _require_ported(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"repro_torch ports the {' and '.join(FAMILIES)} LLM families "
            f"('{cfg.name}' is '{cfg.family}'); the ssm, moe and vlm "
            f"families are ROADMAP.md §A.7")


def _stacked(n, make):
    """The trees make() returns n times, stacked leaf by leaf on a new
    leading axis, filled in place: the layers are never held twice (a
    full-width qwen2.5-14b holds 29.5 GB of them)."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + t.shape)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def _ones(cfg, dtype, device):
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def _attn_mlp_block(generator, cfg, dtype, device):
    """ln1, attn, ln2, mlp: a dense layer, and zamba2's shared block."""
    return {"ln1": _ones(cfg, dtype, device),
            "attn": init_attention(generator, cfg, dtype, device),
            "ln2": _ones(cfg, dtype, device),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                            device=device)}


def _init_block(generator, cfg, dtype, device):
    """One layer's params (unstacked)."""
    if cfg.family == "dense":
        return _attn_mlp_block(generator, cfg, dtype, device)
    return {"ln1": _ones(cfg, dtype, device),
            "mamba": init_mamba2(generator, cfg, dtype, device)}


def init_lm(generator, cfg, dtype=None, device=None):
    _require_ported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    d = cfg.d_model
    blocks = _stacked(cfg.num_layers,
                      lambda: _init_block(generator, cfg, dtype, device))
    params = {
        "embed": embed_init(generator, cfg.vocab_size, d, dtype, device),
        "blocks": blocks,
        "final_norm": _ones(cfg, dtype, device),
        "lm_head": dense_init(generator, d, cfg.vocab_size, dtype,
                              device=device),
    }
    if cfg.family == "hybrid":
        # one *shared* attention+MLP block reused at every application point
        params["shared_attn"] = _attn_mlp_block(generator, cfg, dtype, device)
    return params


def hybrid_points(cfg) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


def _attn_mlp(p, x, cfg):
    h, kv = attention_forward(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                              cfg)
    x = x + h
    return x + mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps)), kv


def forward(params, tokens, cfg, *, collect_kv=False):
    """Full-sequence forward.  tokens: (B, S) integer.

    Returns logits (B, S, vocab), or (logits, caches) with collect_kv:
    dense, (k, v) per layer; hybrid, per attention point (Mamba2 caches of
    its segment, (k, v)).  JAX also returns the MoE losses, which these
    families do not have."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    blocks = layer_list(params["blocks"])
    caches = []
    if cfg.family == "dense":
        for p in blocks:
            x, kv = _attn_mlp(p, x, cfg)
            if collect_kv:
                caches.append(kv)
    else:
        k = cfg.hybrid_attn_every
        for g in range(hybrid_points(cfg)):
            states = []
            for p in blocks[g * k:(g + 1) * k]:
                h, c = mamba2_forward(p["mamba"],
                                      rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
                x = x + h
                states.append(c)
            x, kv = _attn_mlp(params["shared_attn"], x, cfg)
            if collect_kv:
                caches.append((states, kv))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dot(x, params["lm_head"])
    return (logits, caches) if collect_kv else logits


def init_cache(cfg, batch: int, cache_len: int, device=None):
    """Empty decode cache with capacity cache_len."""
    _require_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    L, B, W = cfg.num_layers, batch, cache_len
    pos = torch.full((B, W), -1, dtype=torch.long, device=device)
    if cfg.family == "dense":
        kv = (L, B, W, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device), "pos": pos}
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    kv = (hybrid_points(cfg), B, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "conv": torch.zeros((L, B, cfg.ssm_conv, din + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
        "state": torch.zeros((L, B, nh, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": pos,
    }


def _attn_mlp_decode(p, x, cfg, cache, i, pos):
    """One token through an attention+MLP block against KV slot i."""
    x = x + attention_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                             cfg, cache["k"][i], cache["v"][i], cache["pos"],
                             pos)
    return x + mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def decode_step(params, token, pos, cache, cfg):
    """token: (B,) integer; pos: (B,) absolute position.  Returns (logits,
    cache); the cache is updated in place."""
    _require_ported(cfg)
    x = params["embed"][token][:, None, :]                      # (B, 1, d)
    blocks = layer_list(params["blocks"])
    if cfg.family == "dense":
        for i, p in enumerate(blocks):
            x = _attn_mlp_decode(p, x, cfg, cache, i, pos)
    else:
        k = cfg.hybrid_attn_every
        for g in range(hybrid_points(cfg)):
            for i in range(g * k, (g + 1) * k):
                p = blocks[i]
                h, conv, state = mamba2_decode(
                    p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                    cache["conv"][i], cache["state"][i])
                cache["conv"][i] = conv
                cache["state"][i] = state
                x = x + h
            x = _attn_mlp_decode(params["shared_attn"], x, cfg, cache, g, pos)
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
    if cfg.family == "dense":
        kvs = collected
    else:
        mamba = [c for states, _ in collected for c in states]
        cache["state"] = torch.stack([c["state"] for c in mamba])
        cache["conv"] = torch.stack([c["conv"] for c in mamba]).to(
            cache["conv"].dtype)
        kvs = [kv for _, kv in collected]
    for i, (kk, vv) in enumerate(kvs):
        cache["k"][i][:, slots] = kk[:, src].to(cache["k"].dtype)
        cache["v"][i][:, slots] = vv[:, src].to(cache["v"].dtype)
    cache["pos"][:, slots] = src
    return logits, cache
