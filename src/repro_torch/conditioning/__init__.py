"""repro_torch.conditioning — text conditioning for T2I/T2V serving (the
JAX `repro.conditioning`).

  encoder — ClipCap-style prefix text encoder: byte-level tokens -> a
            (L_text, d_model) prompt-embedding table, padded to exactly
            cfg.dit_text_len
  cache   — PromptCache: content-hashed LRU over prompt embeddings; the
            encoder runs once per unique prompt (metrics:
            repro_conditioning_prompt_cache_*)

Downstream, the serving engine holds per-slot cross-attention K/V tables
beside its negative-prompt vectors: K/V are projected once per admission
wave (models.dit.text_kv over all layers at once) and read by every tick,
so no tick projects text.  A CFG negative prompt conditions the uncond
rows through its pooled embedding (the null-vector path) and its own K/V
tables.
"""
from .cache import PromptCache, PromptEmbedding
from .encoder import (TextEncoderConfig, encode_tokens, init_text_encoder,
                      pooled_embedding, text_encoder_config, tokenize)

__all__ = [
    "PromptCache", "PromptEmbedding",
    "TextEncoderConfig", "encode_tokens", "init_text_encoder",
    "pooled_embedding", "text_encoder_config", "tokenize",
]
