"""Batched LLM serving engine (counterpart of the JAX `serving/engine.py`).

A fixed batch of `slots`, each slot running one request: prompt prefill,
then greedy or temperature decode against the rolling KV cache and SSM
state of `repro_torch.models`.  Requests are taken from a queue `slots` at
a time.  Prompts are right-aligned into a `max_prompt` window with token 0
on the left and no mask, exactly as JAX does: the SSM state sees those
zeros, and a MoE routes the padding and the empty slots' rows too, where
they take expert capacity; parity with JAX depends on both.

Tokens and the done mask stay on the device: the host probes the mask once
every `sync_every` decode steps (only when an EOS id is set) and copies the
tokens back once per chunk of requests.  Greedy picks the first maximum,
as `jnp.argmax` does.  Temperature sampling draws from a `torch.Generator`
seeded from `seed`; its draws differ from `jax.random.categorical`.

Programs (JAX jits `prefill` and `decode`).  Prefill at (slots,
max_prompt) and one decode step at (slots, cache_len) read and write
static buffers that outlive every call, all allocated outside the
programs: the prompt window and the token and position vectors, the KV
cache and SSM state (`init_cache`; prefill resets and fills it in place,
the decode step updates it in place), the last position's logits.  The
first `generate` compiles both (`repro_torch.obs.profiling.compile_program`:
a CUDA graph each on the engine's pool on the card; the eager run of the
compile is that call's real prefill and first decode step), every later
step replays them.  The pool then holds the programs' temporaries only:
prefill makes the last position's logits, not the window's.  The
position's advance is inside the programs; the pick (greedy argmax or a
temperature draw from the generator) is made outside, on the logits the
program left in its static buffer, so the graphs hold no random state.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import (DeviceLike, StaticInputs, resolve_device,
                                tree_device)
from repro_torch.models import decode_step, prefill
from repro_torch.models.transformer import init_cache
from repro_torch.obs.profiling import compile_program
from repro_torch.serving.common import RequestQueue


def engine_refusal(cfg) -> Optional[str]:
    """Why ServingEngine cannot take `cfg` (JAX's cannot either), naming
    the entry points that drive it; None if it can."""
    if cfg.is_encoder_decoder:
        return (f"{cfg.name} is an encoder-decoder, which ServingEngine does "
                f"not serve: drive it with repro_torch.models.encdec "
                f"(encode, cross_kv once, then decode_step)")
    if cfg.family == "vlm":
        return (f"{cfg.name} needs vision_embeds, which ServingEngine's "
                f"prefill does not pass: drive it with "
                f"repro_torch.models.prefill(..., vision_embeds=...), then "
                f"decode_step")
    return None


@dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int] = field(default_factory=list)


class ServingEngine:
    """Fixed-slot batched generation over one architecture.  Runs on the
    GPU unless the caller passes device="cpu"; params must live there."""

    def __init__(self, params, cfg, *, slots: int = 8, cache_len: int = 1024,
                 max_prompt: int = 256, temperature: float = 0.0,
                 eos_id: Optional[int] = None, sync_every: int = 8,
                 device: DeviceLike = None):
        refusal = engine_refusal(cfg)
        if refusal:
            raise ValueError(refusal)
        self.device = resolve_device(device)
        if tree_device(params) != self.device:
            raise ValueError(f"params live on {tree_device(params)}, the "
                             f"engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.slots, self.cache_len = slots, cache_len
        self.max_prompt = max_prompt
        self.temperature = temperature
        self.eos_id = eos_id
        #: decode steps between early-exit probes; each probe is a scalar
        #: host sync, so probing every step would serialize the decode loop
        self.sync_every = max(1, sync_every)
        #: the compiled programs by name ("prefill", "decode") and profiles
        self.programs: dict = {}
        self.program_profile: dict = {}
        self._in = None
        self._pool = None

    # -- static buffers and programs -------------------------------------
    def _alloc_static(self) -> None:
        S, dev = self.slots, self.device
        self._in = StaticInputs(dev)
        self._in.alloc("toks", (S, self.max_prompt), torch.int64)
        self._tok = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._cache = init_cache(self.cfg, S, self.cache_len, device=dev)
        #: the last position's logits of prefill / of a decode step (made
        #: by the first eager run, never inside a capture)
        self._logits = None

    def _keep_logits(self, logits) -> None:
        if self._logits is None:
            self._logits = torch.empty_like(logits)
        self._logits.copy_(logits)

    def _prefill_static(self) -> None:
        """The prefill program: the prompt window into the static cache,
        the last position's logits, the positions."""
        logits, _ = prefill(self.params, self._in.dev["toks"], self.cfg,
                            self.cache_len, cache=self._cache,
                            last_only=True)
        self._keep_logits(logits[:, -1, :])
        self._pos.fill_(self.max_prompt)

    def _decode_static(self) -> None:
        """The decode program: the static token against the static cache
        (updated in place), its logits, the positions advanced."""
        logits, _ = decode_step(self.params, self._tok, self._pos,
                                self._cache, self.cfg)
        self._keep_logits(logits)
        self._pos.add_(1)

    def _run(self, name: str, fn) -> None:
        """Replay program `name`; the first call compiles it (its eager run
        is this call's work)."""
        prog = self.programs.get(name)
        if prog is not None:
            prog.run()
        else:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            key = (name, self.slots, self.max_prompt if name == "prefill"
                   else self.cache_len)
            method = weakref.WeakMethod(fn)    # no cycle through the program
            self.programs[name], self.program_profile[name] = \
                compile_program(lambda: method()(), key=key,
                                device=self.device, pool=self._pool)

    def _pick(self, logits, gen):
        if self.temperature > 0.0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 seed: int = 0) -> List[GenerationResult]:
        """Generate for every prompt, `slots` at a time."""
        results = [GenerationResult(i, p) for i, p in enumerate(prompts)]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self._in is None:
            self._alloc_static()
        queue = RequestQueue(range(len(prompts)))
        while queue:
            chunk = queue.pop_many(self.slots)
            toks = np.zeros((self.slots, self.max_prompt), np.int64)
            for row, ridx in enumerate(chunk):
                p = prompts[ridx][-self.max_prompt:]
                toks[row, -len(p):] = p       # right-aligned
            # the previous chunk's token copy synchronized: the pinned
            # prompt buffer is free to refill
            self._in.put("toks", toks)
            self._run("prefill", self._prefill_static)
            tok = self._pick(self._logits, gen)
            done = torch.from_numpy(np.arange(self.slots) >= len(chunk)).to(
                self.device)
            emitted = []
            since_probe = 0
            for step in range(max_new_tokens):
                emitted.append(tok)
                if self.eos_id is not None:
                    done = done | (tok == self.eos_id)
                    since_probe += 1
                    if (since_probe >= self.sync_every
                            and step + 1 < max_new_tokens):
                        since_probe = 0
                        # repro-lint: disable-next-line=host-sync-in-hot-path -- priced: the strided EOS probe, one scalar per sync_every steps
                        if bool(done.all()):
                            break
                if step + 1 < max_new_tokens:
                    self._tok.copy_(tok)
                    self._run("decode", self._decode_static)
                    tok = self._pick(self._logits, gen)
            if emitted:
                # one bulk transfer per chunk, outside the per-token loop
                # repro-lint: disable-next-line=host-sync-in-hot-path -- priced: a chunk's tokens in one copy after its decode loop
                toks_host = torch.stack(emitted, dim=1).cpu().numpy()
                for row, ridx in enumerate(chunk):
                    row_toks = toks_host[row]
                    if self.eos_id is not None:
                        hits = np.nonzero(row_toks == self.eos_id)[0]
                        if hits.size:          # keep through the first EOS
                            row_toks = row_toks[:hits[0] + 1]
                    results[ridx].tokens.extend(int(t) for t in row_toks)
        return results


def greedy_generate(params, cfg, prompt_tokens, max_new_tokens: int = 16,
                    cache_len: int = 256, device: DeviceLike = None):
    """Single-sequence convenience wrapper used by tests and examples."""
    eng = ServingEngine(params, cfg, slots=1, cache_len=cache_len,
                        max_prompt=len(prompt_tokens), device=device)
    return eng.generate([list(prompt_tokens)], max_new_tokens)[0].tokens
