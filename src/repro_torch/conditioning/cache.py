"""Prompt-level embedding cache: content-hashed, LRU-bounded — the port of
the JAX `conditioning/cache.py`.

Prompt embeddings are deterministic per prompt and step-invariant across
the whole denoise trajectory, the static-reuse end of the survey's
static -> dynamic spectrum.  PromptCache therefore pays the text encoder
exactly once per unique prompt; every re-submission (popular prompts, CFG
pairs, retries) is a host-side dict hit.  The engine's per-slot
cross-attention K/V tables extend the same invariance: K/V are projected
once per admission wave, never per step.

Entries are keyed by a content hash of the padded token buffer, so a
string prompt and its explicit token-sequence spelling share one entry.
Hit, miss and eviction counts publish through a `repro_torch.obs`
MetricsRegistry (`repro_conditioning_prompt_cache_*`, JAX's names).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import tree_device

from .encoder import (TextEncoderConfig, TokensLike, encode_tokens,
                      pooled_embedding, tokenize)

__all__ = ["PromptEmbedding", "PromptCache"]


@dataclass(frozen=True)
class PromptEmbedding:
    """One cached prompt: padded tokens + the two embedding views."""
    key: str                     # content hash of the padded token buffer
    tokens: np.ndarray           # (L,) int32
    mask: np.ndarray             # (L,) bool
    embed: np.ndarray            # (L, d) f32, zeroed at padding
    pooled: np.ndarray           # (d,) f32 masked mean (neg-prompt vector)


class PromptCache:
    """prompt -> PromptEmbedding with LRU bounds and metrics.

    Host-side by design: admission-time code, never tick code.  The encoder
    runs on the params' device once per unique prompt, and its two outputs
    come back in one device-to-host copy.  `warmup()` runs the encoder once
    on dummy operands, so that the first miss builds nothing."""

    def __init__(self, params, tc: TextEncoderConfig, capacity: int = 128,
                 metrics=None, name: str = "default"):
        if capacity < 1:
            raise ValueError(f"PromptCache capacity must be >= 1, "
                             f"got {capacity}")
        self.params = params
        self.tc = tc
        self.device = tree_device(params)
        self.capacity = int(capacity)
        self.name = name
        self._entries: "OrderedDict[str, PromptEmbedding]" = OrderedDict()
        self._metrics = metrics
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def content_key(self, prompt: TokensLike) -> str:
        ids, mask = tokenize(prompt, self.tc)
        return self._hash(ids, mask)

    @staticmethod
    def _hash(ids: np.ndarray, mask: np.ndarray) -> str:
        return hashlib.sha1(ids.tobytes() + mask.tobytes()).hexdigest()

    def _count(self, what: str) -> None:
        setattr(self, what, getattr(self, what) + 1)
        if self._metrics is not None:
            self._metrics.counter(
                f"repro_conditioning_prompt_cache_{what}_total",
                "PromptCache LRU events").inc(1, cache=self.name)
            self._metrics.gauge(
                "repro_conditioning_prompt_cache_size",
                "live PromptCache entries").set(len(self._entries),
                                                cache=self.name)

    def _encode(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(L, d) embedding and (d,) pooled vector stacked into one
        (L + 1, d) host array: one device-to-host copy."""
        tid = torch.from_numpy(ids[None]).to(self.device)
        tm = torch.from_numpy(mask[None]).to(self.device)
        emb = encode_tokens(self.params, tid, tm, self.tc)
        both = torch.cat([emb[0], pooled_embedding(emb, tm)], dim=0)
        return both.float().cpu().numpy()

    def get(self, prompt: TokensLike) -> PromptEmbedding:
        """Embedding table for `prompt`; the encoder runs only on a miss."""
        ids, mask = tokenize(prompt, self.tc)
        key = self._hash(ids, mask)
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self._count("hits")
            return hit
        both = self._encode(ids, mask)
        entry = PromptEmbedding(key=key, tokens=ids, mask=mask,
                                embed=both[:-1], pooled=both[-1])
        self._entries[key] = entry
        self._count("misses")
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._count("evictions")
        return entry

    def warmup(self) -> None:
        """Run the encoder once on an all-padding dummy prompt (builds and
        touches every kernel it needs); counts no hit and no miss."""
        L = self.tc.max_len
        self._encode(np.zeros((L,), np.int32), np.zeros((L,), bool))

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "capacity": self.capacity,
                "hit_rate": self.hits / max(self.hits + self.misses, 1)}
