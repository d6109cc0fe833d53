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

from repro_torch.device import to_device, tree_device
from repro_torch.obs import watch

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
    come back in one device-to-host copy (`repro_torch.obs.watch.host_read`,
    outside the encoder program).  `warmup()` runs the encoder once on
    dummy operands, so that the first miss builds nothing; `warmup(verify=
    True)` also records that run's operators (`repro_torch.analysis.ir`)
    and returns the record."""

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
        self._warmed = False

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

    def _encode_program(self, ids: np.ndarray,
                        mask: np.ndarray) -> torch.Tensor:
        """The encoder program: (L, d) embedding and (d,) pooled vector
        stacked into one (L + 1, d) f32 tensor on the device."""
        tid = to_device(ids[None], self.device)
        tm = to_device(mask[None], self.device)
        emb = encode_tokens(self.params, tid, tm, self.tc)
        return torch.cat([emb[0], pooled_embedding(emb, tm)], dim=0).float()

    def _encode(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """The encoder program, then its output in one device-to-host
        copy."""
        if not self._warmed:
            watch.emit("program", f"PromptCache[{self.name!r}].text_encoder")
        return watch.host_read(self._encode_program(ids, mask))

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

    def warmup(self, verify: bool = False):
        """Run the encoder program once on an all-padding dummy prompt
        (builds and touches every kernel it needs); counts no hit and no
        miss.  `verify=True` runs it under the program verifier's operator
        recorder and returns the record (else None)."""
        L = self.tc.max_len
        args = (np.zeros((L,), np.int32), np.zeros((L,), bool))
        self._warmed = True
        if not verify:
            self._encode_program(*args)
            return None
        from repro_torch.analysis.ir.op_checks import record_program
        _, rec = record_program("text_encoder",
                                lambda: self._encode_program(*args))
        return rec

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "capacity": self.capacity,
                "hit_rate": self.hits / max(self.hits + self.misses, 1)}
