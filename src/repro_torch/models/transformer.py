"""Decoder LM of the port: the `dense` (Llama-style GQA), `moe` (arctic:
GQA attention and a top-2 MoE with a dense residual FFN; deepseek-v2: MLA
and a top-6 MoE with shared experts), `hybrid` (zamba2), `ssm`
(falcon-mamba, Mamba1; or Mamba2 layers alone) and `vlm` (pixtral: the
dense decoder over projected patch embeddings prepended to the text)
families of the JAX `models/transformer.py`; the encoder-decoder (family
"audio") is `models/encdec.py`.

Entry points, plain functions of (params, inputs, cfg):

  init_lm(generator, cfg)                                    -> params
  forward(params, tokens, cfg, vision_embeds=, collect_kv=, with_aux=,
          remat=, ep=, last_only=)               -> logits[, aux][, caches]
  prefill(params, tokens, cfg, cache_len, vision_embeds=, ep=, cache=,
          last_only=)                                        -> (logits, cache)
  decode_step(params, token, pos, cache, cfg, ep=)           -> (logits, cache)

`remat=True` checkpoints each layer (`torch.utils.checkpoint`, JAX's
`jax.checkpoint`: the train cases' memory knob).  `ep` (a dict of
`moe_forward_ep` keyword arguments: mesh, batch_ax, ep_axis, inner_axes)
runs a moe model's MoE layers expert-parallel (JAX's `_moe_layer`).  On
DTensor params and inputs (`sharding.distribute`) the functions run
sharded; call them under `implicit_replication()`, so that the plain
tensors they make (positions, masks) count as replicated.

Per-layer params are stacked on a leading layer axis, as in JAX; the port
walks the layers in a Python loop where JAX scans (one unbind per stacked
leaf, so that under autograd each leaf gets one stacked gradient).  A dense
layer is pre-norm attention then a pre-norm SwiGLU MLP.  A hybrid model
runs `hybrid_attn_every` Mamba2 layers, then the one shared attention+MLP
block, `num_layers // hybrid_attn_every` times.  An ssm model is a stack of
pre-norm Mamba1 (or Mamba2) layers.  A vlm forward prepends
`vision_embeds @ vision_proj` to the token embeddings, so its sequence is
`num_vision_tokens` longer than the text.  A moe layer is pre-norm
attention (MLA when cfg.use_mla) then a pre-norm MoE FFN
(`models/moe.py`), whose load-balance and router-z losses `forward` sums
over the layers (`with_aux`, as JAX returns them).  Prefill attention
goes through the flash kernel; one-token decode attends with
`blocked_attention` (MLA: its absorbed form, `models/mla.py`).  KV caches
are rolling buffers of capacity `cache_len` with absolute positions
stored beside them.  `decode_step`
updates the cache in place (JAX returns a new one) so that a step does not
copy the whole cache.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spmd
from repro_torch.core.engine import layer_list

from .layers import (attention_decode, attention_forward, dense_init, dot,
                     embed_init, init_attention, init_mlp, mlp_forward,
                     normal_into, rms_norm)
from .mla import init_mla, mla_decode, mla_forward
from .moe import init_experts, init_moe, moe_forward
from .ssm import (init_mamba1, init_mamba2, mamba1_decode, mamba1_forward,
                  mamba2_decode, mamba2_forward)

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")
ATTN_FAMILIES = ("dense", "vlm")       # a stack of attention+MLP layers
AUX_KEYS = ("load_balance_loss", "router_z_loss", "dropped")


def _require_ported(cfg):
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"'{cfg.name}' is an encoder-decoder: drive it through "
            f"repro_torch.models.encdec (encode, cross_kv, decode_step)")
    if cfg.family not in FAMILIES:
        raise ValueError(f"'{cfg.name}' is family '{cfg.family}': the "
                         f"decoder LM families are {', '.join(FAMILIES)}")
    if cfg.family == "moe" and not 1 <= cfg.experts_per_token \
            <= cfg.num_experts:
        raise ValueError(f"'{cfg.name}' is a moe model with "
                         f"{cfg.num_experts} experts, {cfg.experts_per_token} "
                         f"a token: it needs 1 <= experts per token <= "
                         f"experts")


def _mamba(cfg):
    """(init, forward, decode) of an ssm or hybrid model's layers."""
    if cfg.family == "ssm" and cfg.mamba_version == 1:
        return init_mamba1, mamba1_forward, mamba1_decode
    return init_mamba2, mamba2_forward, mamba2_decode


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
    """One layer's params (unstacked); a moe layer's without its routed
    experts, which `init_lm` draws for all layers at once."""
    if cfg.family in ATTN_FAMILIES:
        return _attn_mlp_block(generator, cfg, dtype, device)
    if cfg.family == "moe":
        attn = init_mla if cfg.use_mla else init_attention
        return {"ln1": _ones(cfg, dtype, device),
                "attn": attn(generator, cfg, dtype, device),
                "ln2": _ones(cfg, dtype, device),
                "moe": init_moe(generator, cfg, dtype, device)}
    return {"ln1": _ones(cfg, dtype, device),
            "mamba": _mamba(cfg)[0](generator, cfg, dtype, device)}


def init_lm(generator, cfg, dtype=None, device=None):
    _require_ported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    d = cfg.d_model
    blocks = _stacked(cfg.num_layers,
                      lambda: _init_block(generator, cfg, dtype, device))
    if cfg.family == "moe":
        # straight into their storage, in blocks of rows: one layer's
        # experts built whole and copied in would not fit beside the
        # others, and the f32 draw of a whole (102400, 5120) embedding
        # would stand 4 GB above the params
        blocks["moe"].update(init_experts(generator, cfg, dtype, device,
                                          lead=(cfg.num_layers,)))

        def empty(*shape):
            return torch.empty(shape, dtype=dtype, device=device)
        embed = normal_into(empty(cfg.vocab_size, d), generator, 0.02)
        lm_head = normal_into(empty(d, cfg.vocab_size), generator,
                              1.0 / d ** 0.5)
    else:
        embed = embed_init(generator, cfg.vocab_size, d, dtype, device)
        lm_head = dense_init(generator, d, cfg.vocab_size, dtype,
                             device=device)
    params = {"embed": embed, "blocks": blocks,
              "final_norm": _ones(cfg, dtype, device), "lm_head": lm_head}
    if cfg.family == "hybrid":
        # one *shared* attention+MLP block reused at every application point
        params["shared_attn"] = _attn_mlp_block(generator, cfg, dtype, device)
    if cfg.family == "vlm":
        params["vision_proj"] = dense_init(generator, cfg.vision_dim, d, dtype,
                                           device=device)
    return params


def hybrid_points(cfg) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


def _attn_mlp(p, x, cfg):
    h, kv = attention_forward(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                              cfg)
    x = x + h
    return x + mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps)), kv


def _embed_inputs(params, tokens, cfg, vision_embeds=None):
    """Token embeddings; a vlm prepends the projected patch embeddings
    (cast to the embeddings' dtype first, as JAX does)."""
    x = spmd.embed(params["embed"], tokens)
    if cfg.family == "vlm":
        if vision_embeds is None:
            raise ValueError(f"{cfg.name} needs vision_embeds (B, "
                             f"{cfg.num_vision_tokens}, {cfg.vision_dim}): "
                             f"the stub patch embeddings")
        v = dot(vision_embeds.to(x.dtype), params["vision_proj"])
        x = torch.cat([v, x], dim=1)
    return x


def _layer(fn, remat, *args):
    """fn(*args), its activations recomputed in the backward when remat."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _moe_layer(p, x, cfg, ep=None):
    """A moe layer: attention (MLA or GQA), then the MoE FFN (expert
    parallel with `ep`).  Returns (x, the attention's cache entries, the
    MoE's aux)."""
    xi = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        h, kv = mla_forward(p["attn"], xi, cfg)
    else:
        h, kv = attention_forward(p["attn"], xi, cfg)
    x = x + h
    mo, aux = moe_forward(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                          ep=ep)
    return x + mo, kv, aux


def _mamba_layer(fwd, p, x, cfg):
    h, c = fwd(p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    return x + h, c


def forward(params, tokens, cfg, *, vision_embeds=None, collect_kv=False,
            with_aux=False, remat=False, ep=None, last_only=False):
    """Full-sequence forward.  tokens: (B, S) integer; vision_embeds (B,
    num_vision_tokens, vision_dim) for a vlm.

    Returns logits (B, S', vocab), S' = S (+ num_vision_tokens for a vlm),
    or with `last_only` the last position's, (B, 1, vocab);
    with `with_aux` also aux, JAX's MoE losses summed over the layers
    (load_balance_loss, router_z_loss; 0 for the other families) and the
    (token, choice) pairs `dropped` past capacity; with collect_kv also the
    caches: dense, vlm and arctic, (k, v) per layer; deepseek-v2, (c_kv,
    k_rope) per layer; ssm, the Mamba cache of each layer; hybrid, per
    attention point (Mamba2 caches of its segment, (k, v))."""
    _require_ported(cfg)
    x = _embed_inputs(params, tokens, cfg, vision_embeds)
    blocks = layer_list(params["blocks"])
    caches = []
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in AUX_KEYS}
    aux["dropped"] = aux["dropped"].long()
    if cfg.family == "moe":
        for p in blocks:
            x, kv, a = _layer(_moe_layer, remat, p, x, cfg, ep)
            aux = {k: aux[k] + a[k] for k in AUX_KEYS}
            if collect_kv:
                caches.append(kv)
    elif cfg.family in ATTN_FAMILIES:
        for p in blocks:
            x, kv = _layer(_attn_mlp, remat, p, x, cfg)
            if collect_kv:
                caches.append(kv)
    elif cfg.family == "ssm":
        fwd = _mamba(cfg)[1]
        for p in blocks:
            x, c = _layer(_mamba_layer, remat, fwd, p, x, cfg)
            if collect_kv:
                caches.append(c)
    else:
        k = cfg.hybrid_attn_every
        for g in range(hybrid_points(cfg)):
            states = []
            for p in blocks[g * k:(g + 1) * k]:
                x, c = _layer(_mamba_layer, remat, mamba2_forward, p, x, cfg)
                states.append(c)
            x, kv = _layer(_attn_mlp, remat, params["shared_attn"], x, cfg)
            if collect_kv:
                caches.append((states, kv))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    out = (dot(x, params["lm_head"]),) + ((aux,) if with_aux else ()) \
        + ((caches,) if collect_kv else ())
    return out if len(out) > 1 else out[0]


def init_cache(cfg, batch: int, cache_len: int, device=None):
    """Empty decode cache with capacity cache_len."""
    _require_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    L, B, W = cfg.num_layers, batch, cache_len
    pos = torch.full((B, W), -1, dtype=torch.long, device=device)
    if cfg.family == "moe" and cfg.use_mla:
        return {"ckv": torch.zeros((L, B, W, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "kr": torch.zeros((L, B, W, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device), "pos": pos}
    if cfg.family in ATTN_FAMILIES + ("moe",):
        kv = (L, B, W, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device), "pos": pos}
    din = cfg.ssm_expand * cfg.d_model
    if cfg.family == "ssm" and cfg.mamba_version == 1:
        return {"conv": torch.zeros((L, B, cfg.ssm_conv, din), dtype=dtype,
                                    device=device),
                "state": torch.zeros((L, B, din, cfg.ssm_state),
                                     dtype=torch.float32, device=device)}
    nh = din // cfg.ssm_head_dim
    cache = {
        "conv": torch.zeros((L, B, cfg.ssm_conv, din + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
        "state": torch.zeros((L, B, nh, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }
    if cfg.family == "ssm":
        return cache
    kv = (hybrid_points(cfg), B, W, cfg.num_kv_heads, cfg.head_dim)
    return dict(cache, k=torch.zeros(kv, dtype=dtype, device=device),
                v=torch.zeros(kv, dtype=dtype, device=device), pos=pos)


def _attn_mlp_decode(p, x, cfg, cache, i, pos):
    """One token through an attention+MLP block against KV slot i."""
    x = x + attention_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                             cfg, cache["k"][i], cache["v"][i], cache["pos"],
                             pos)
    return x + mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _moe_decode(p, x, cfg, cache, i, pos, ep=None):
    """One token through a moe layer against cache slot i."""
    xi = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        h = mla_decode(p["attn"], xi, cfg, cache["ckv"][i], cache["kr"][i],
                       cache["pos"], pos)
    else:
        h = attention_decode(p["attn"], xi, cfg, cache["k"][i],
                             cache["v"][i], cache["pos"], pos)
    x = x + h
    return x + moe_forward(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps),
                           cfg, ep=ep)[0]


def decode_step(params, token, pos, cache, cfg, *, ep=None):
    """token: (B,) integer; pos: (B,) absolute position.  Returns (logits,
    cache); the cache is updated in place."""
    _require_ported(cfg)
    x = spmd.embed(params["embed"], token)[:, None, :]          # (B, 1, d)
    blocks = layer_list(params["blocks"])
    if cfg.family in ATTN_FAMILIES:
        for i, p in enumerate(blocks):
            x = _attn_mlp_decode(p, x, cfg, cache, i, pos)
    elif cfg.family == "moe":
        for i, p in enumerate(blocks):
            x = _moe_decode(p, x, cfg, cache, i, pos, ep)
    elif cfg.family == "ssm":
        dec = _mamba(cfg)[2]
        for i, p in enumerate(blocks):
            h, conv, state = dec(p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                 cfg, cache["conv"][i], cache["state"][i])
            spmd.put(cache["conv"], i, conv)
            spmd.put(cache["state"], i, state)
            x = x + h
    else:
        k = cfg.hybrid_attn_every
        for g in range(hybrid_points(cfg)):
            for i in range(g * k, (g + 1) * k):
                p = blocks[i]
                h, conv, state = mamba2_decode(
                    p["mamba"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                    cache["conv"][i], cache["state"][i])
                spmd.put(cache["conv"], i, conv)
                spmd.put(cache["state"], i, state)
                x = x + h
            x = _attn_mlp_decode(params["shared_attn"], x, cfg, cache, g, pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dot(x, params["lm_head"])[:, 0], cache


def _put_mamba(cache, mamba) -> None:
    """Each layer's Mamba cache into its entry of the stacked cache."""
    for i, c in enumerate(mamba):
        spmd.put(cache["state"], i, c["state"])
        spmd.put(cache["conv"], i, c["conv"])


def prefill(params, tokens, cfg, cache_len: int, *, vision_embeds=None,
            ep=None, cache=None, last_only=False):
    """Returns (logits (B, S, vocab), cache ready for decode at pos = S);
    a vlm's S counts its `num_vision_tokens` patch positions too.  A given
    `cache` (init_cache's at (B, cache_len)) is reset and written in place
    instead of a new one; `last_only` keeps the last position's logits,
    (B, 1, vocab)."""
    logits, collected = forward(params, tokens, cfg,
                                vision_embeds=vision_embeds, collect_kv=True,
                                ep=ep, last_only=last_only)
    B = tokens.shape[0]
    S = tokens.shape[1] + (cfg.num_vision_tokens if cfg.family == "vlm"
                           else 0)
    if cache is None:
        cache = init_cache(cfg, B, cache_len, device=tokens.device)
    else:
        for name, t in cache.items():
            t.fill_(-1 if name == "pos" else 0)
    if cfg.family == "ssm":
        _put_mamba(cache, collected)
        return logits, cache
    keep = min(S, cache_len)
    src = torch.arange(S - keep, S, device=tokens.device)
    slots = src % cache_len
    names = ("ckv", "kr") if cfg.use_mla else ("k", "v")
    if cfg.family in ATTN_FAMILIES + ("moe",):
        kvs = collected
    else:
        _put_mamba(cache, [c for states, _ in collected for c in states])
        kvs = [kv for _, kv in collected]
    for i, pair in enumerate(kvs):
        for name, t in zip(names, pair):
            cache[name][i][:, slots] = t[:, src].to(cache[name].dtype)
    cache["pos"][:, slots] = src
    return logits, cache
