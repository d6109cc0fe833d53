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
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import StaticInputs, tree_device
from repro_torch.obs import watch
from repro_torch.obs.profiling import compile_program

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
    outside the encoder program).  The program reads the prompt from static
    buffers and writes one static output.  `warmup()` compiles it
    (`repro_torch.obs.profiling.compile_program`: a CUDA graph on the
    card, on the cache's own pool; `program_profile` its profile), so that
    the first miss builds and captures nothing; `warmup(verify=True)` also
    records one run's operators (`repro_torch.analysis.ir`) and returns the
    record.  Before a warmup the program runs eagerly."""

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
        L = tc.max_len
        self._in = StaticInputs(self.device)
        self._in.alloc("ids", (1, L), torch.int32)
        self._in.alloc("mask", (1, L), torch.bool)
        self._out = torch.zeros((L + 1, tc.d_model), device=self.device)
        self._program = None
        self._pool = None
        #: the encoder program's ProgramProfile, set by warmup()
        self.program_profile = None

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

    def _encode_static(self) -> None:
        """The encoder program over the static prompt buffers: (L, d)
        embedding and (d,) pooled vector stacked into the static (L + 1,
        d) f32 output."""
        tid, tm = self._in.dev["ids"], self._in.dev["mask"]
        emb = encode_tokens(self.params, tid, tm, self.tc)
        self._out.copy_(torch.cat([emb[0], pooled_embedding(emb, tm)],
                                  dim=0).float())

    def _encode_program(self, ids: np.ndarray,
                        mask: np.ndarray) -> torch.Tensor:
        """The prompt into the static buffers, then the encoder program
        (its graph once warmed); the static output."""
        self._in.put("ids", ids[None])
        self._in.put("mask", mask[None])
        if self._program is not None:
            self._program.run()
        else:
            self._encode_static()
        return self._out

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
        """Compile the encoder program on an all-padding dummy prompt
        (builds every kernel it needs and, on the card, captures it), or
        replay it when compiled before; counts no hit and no miss.
        `verify=True` also runs it under the program verifier's operator
        recorder and returns the record (else None)."""
        L = self.tc.max_len
        self._in.put("ids", np.zeros((1, L), np.int32))
        self._in.put("mask", np.zeros((1, L), bool))
        self._warmed = True
        if self._program is None:
            if self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            me = weakref.proxy(self)     # no cycle through the program
            self._program, self.program_profile = compile_program(
                lambda: me._encode_static(), key="text_encoder",
                device=self.device, pool=self._pool)
        else:
            self._program.run()
        if not verify:
            return None
        from repro_torch.analysis.ir.op_checks import record_program
        _, rec = record_program("text_encoder", self._encode_static)
        return rec

    def param_leaf_specs(self):
        """(shape, dtype-name) of the encoder's param leaves: what the
        engine declares to the ir-const-bloat check for this program."""
        from repro_torch.analysis.ir.verify import param_leaf_specs
        return param_leaf_specs(self.params)

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "capacity": self.capacity,
                "hit_rate": self.hits / max(self.hits + self.misses, 1)}
