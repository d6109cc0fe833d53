"""ClipCap-style prefix text encoder: tokens -> (L_text, d_model) prompt
embeddings for the DiT cross-attention branches — the port of the JAX
`conditioning/encoder.py`.

Deliberately small: a byte-level tokenizer, a few bidirectional pre-LN
transformer blocks and a projection into the backbone's d_model.  The
caching claims it supports do not depend on encoder quality: prompt
embeddings are deterministic per prompt and step-invariant across the
whole denoise trajectory.

Every prompt is padded to exactly `max_len` (= cfg.dit_text_len) tokens.
Padding positions are masked out of the encoder's self-attention (negative
key positions are always masked by `blocked_attention`, the port's plain
attention: at d_model 1152 and 4 heads the head dim is 288, more than the
flash kernel takes) and the output rows at padding positions are zeroed,
the invariant the cross-attention no-op relies on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core.engine import layer_params
from repro_torch.device import resolve_device
from repro_torch.models.dit import _stack
from repro_torch.models.encdec import sinusoidal_positions
from repro_torch.models.layers import (blocked_attention, dense_init, dot,
                                       embed_init, init_mlp, layer_norm,
                                       mlp_forward)

__all__ = ["TextEncoderConfig", "text_encoder_config", "init_text_encoder",
           "tokenize", "encode_tokens", "pooled_embedding"]

TokensLike = Union[str, Sequence[int]]


@dataclass(frozen=True)
class TextEncoderConfig:
    """Shape contract between encoder, PromptCache and serving engine."""
    d_model: int                 # output width == backbone d_model
    max_len: int                 # padded prompt length == cfg.dit_text_len
    vocab: int = 256             # byte-level tokens
    num_layers: int = 2
    num_heads: int = 4
    d_ff: int = 0                # 0 -> 4 * d_model

    def __post_init__(self):
        if self.max_len < 1:
            raise ValueError("text encoder needs max_len >= 1 "
                             "(cfg.dit_text_len > 0)")
        if self.d_ff == 0:
            object.__setattr__(self, "d_ff", 4 * self.d_model)
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"num_heads {self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def text_encoder_config(cfg, **overrides) -> TextEncoderConfig:
    """Derive the encoder shape contract from a text-enabled ArchConfig."""
    kw = dict(d_model=cfg.d_model, max_len=cfg.dit_text_len)
    kw.update(overrides)
    return TextEncoderConfig(**kw)


def _init_block(gen, tc, dtype, device):
    d, width = tc.d_model, tc.num_heads * tc.head_dim
    attn = {name: dense_init(gen, *dims, dtype, device=device)
            for name, dims in (("wq", (d, width)), ("wk", (d, width)),
                               ("wv", (d, width)), ("wo", (width, d)))}
    return {"attn": attn,
            "mlp": init_mlp(gen, d, tc.d_ff, dtype, gated=False,
                            device=device)}


def init_text_encoder(generator: torch.Generator, tc: TextEncoderConfig,
                      dtype=torch.float32, device=None):
    """Random encoder params drawn from `generator` on `device` (the GPU
    unless the caller passes device="cpu"); `blocks` leaves carry a
    leading layer axis, as JAX's vmapped init gives."""
    dev = resolve_device(device)
    return {
        "tok_embed": embed_init(generator, tc.vocab, tc.d_model, dtype,
                                device=dev),
        "blocks": _stack([_init_block(generator, tc, dtype, dev)
                          for _ in range(tc.num_layers)]),
        "proj": dense_init(generator, tc.d_model, tc.d_model, dtype,
                           device=dev),
    }


def tokenize(prompt: TokensLike, tc: TextEncoderConfig):
    """prompt (str or explicit int token sequence) -> (ids, mask):
    ids (max_len,) int32, mask (max_len,) bool, as numpy arrays.

    Strings tokenize byte-level (UTF-8) and truncate silently at max_len;
    an explicit overlong token sequence is a caller error and raises."""
    if isinstance(prompt, str):
        ids = list(prompt.encode("utf-8"))[:tc.max_len]
    else:
        ids = [int(t) for t in prompt]
        if len(ids) > tc.max_len:
            raise ValueError(f"prompt token sequence of length {len(ids)} "
                             f"exceeds max_len {tc.max_len}")
        bad = [t for t in ids if not 0 <= t < tc.vocab]
        if bad:
            raise ValueError(f"prompt tokens out of vocab range "
                             f"[0, {tc.vocab}): {bad[:4]}")
    n = len(ids)
    out = np.zeros((tc.max_len,), np.int32)
    out[:n] = ids
    mask = np.zeros((tc.max_len,), bool)
    mask[:n] = True
    return out, mask


def encode_tokens(params, ids, mask, tc: TextEncoderConfig):
    """(B, L) integer ids + (B, L) bool mask -> (B, L, d_model) prompt
    embeddings (f32 params give f32), zeroed at padding positions."""
    L, dev = tc.max_len, ids.device
    x = params["tok_embed"][ids.long()]
    pos = torch.arange(L, device=dev)[None]
    x = x + sinusoidal_positions(pos, tc.d_model).to(x.dtype)
    qpos = pos.expand(ids.shape[0], L)
    kpos = torch.where(mask, qpos, -1)           # negative -> always masked
    B, H, hd = ids.shape[0], tc.num_heads, tc.head_dim
    for i in range(tc.num_layers):
        p = layer_params(params["blocks"], i)
        h = layer_norm(x)
        q = dot(h, p["attn"]["wq"]).reshape(B, L, H, hd)
        k = dot(h, p["attn"]["wk"]).reshape(B, L, H, hd)
        v = dot(h, p["attn"]["wv"]).reshape(B, L, H, hd)
        o = blocked_attention(q, k, v, causal=False, q_positions=qpos,
                              k_positions=kpos)
        x = x + dot(o.reshape(B, L, H * hd), p["attn"]["wo"])
        x = x + mlp_forward(p["mlp"], layer_norm(x))
    out = dot(layer_norm(x), params["proj"])
    return torch.where(mask[..., None], out, 0.0)


def pooled_embedding(embed, mask):
    """Masked mean over the token axis: (..., L, d) -> (..., d).  Embeds
    are already zeroed at padding, so a sum over L only needs the count.
    This is the pooled vector the CFG negative-prompt path feeds through
    the engine's null-vector tables."""
    n = mask.sum(dim=-1, keepdim=True).clamp(min=1)
    return embed.sum(dim=-2) / n
