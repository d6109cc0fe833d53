"""The golden mixed-modality session: the lint-time serving fixture the
ir-* rules (and the sentinel tests) share (the counterpart of the JAX
package's `ir/golden.py`).

One cached context per process and device builds tiny image + video +
prompted-t2i engines as JAX's does (TeaCache / teacache_video with
FasterCacheCFG, a PromptCache conditioner, so the device want pass, the
uncond rows, every bucket program and the text programs all exist), warms
them with `warmup(verify=True)`, collects their findings, then serves a
mixed guided / unguided / prompted queue through a MixedModalityEngine
under a RetraceSentinel — serving after warmup must build, load and run
nothing warmup did not, in-session prompt-cache misses included.

Tiny is load-bearing: the configs are reduced to 1 layer / 32 dims and
the checks run in seconds inside the lint.  The contracts checked are
size-independent.  The device is an argument; its default is the card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["GoldenContext", "golden_context", "build_golden_engines",
           "golden_requests", "GOLDEN_POLICIES"]

#: modality -> the golden engine's policy (JAX's golden set)
GOLDEN_POLICIES = (("image", "teacache"), ("video", "teacache_video"),
                   ("t2i", "teacache"))


@dataclass
class GoldenContext:
    """Everything the ir-* rules consult, built once per process and
    device."""
    device: str = "cuda"
    engines: Dict[str, object] = field(default_factory=dict)
    program_findings: List = field(default_factory=list)   # warmup(verify)
    retrace_count: int = -1             # -1 = session did not run
    retrace_names: List[str] = field(default_factory=list)
    sentinel_live: bool = False         # selftest: both channels see events
    requests_served: int = 0
    error: str = ""                     # non-empty = context build failed


def build_golden_engines(device="cuda") -> Dict[str, object]:
    """Tiny image + video + t2i engines with state-dependent policies and
    a CFG branch: the want pass, every bucket, the uncond rows and the
    text programs (prompt encoder, admission-time text_kv) all run at
    warmup."""
    from repro_torch.core import FasterCacheCFG
    from repro_torch.modalities import get_modality, make_workload

    engines = {}
    for modality, policy in GOLDEN_POLICIES:
        spec = get_modality(modality)
        extra = {"dit_text_len": 4} if spec.text else {}
        cfg = spec.config(smoke=True).reduced(
            num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
            **extra)
        wl = make_workload(modality, cfg=cfg, device=device)
        kw = {"conditioner": wl.conditioner(seed=0)} if spec.text else {}
        engines[modality] = wl.engine(
            policy, slots=2, max_steps=6, cfg_policy=FasterCacheCFG(2, 6),
            **kw)
    return engines


def golden_requests(num_steps: int = 6):
    """JAX's golden queue: guided + unguided, image + video + prompted t2i,
    enough requests that slots refill mid-flight.  The t2i prompts include
    a fresh-at-admission prompt and a CFG negative prompt, so the sentinel
    covers the whole text path — encoder miss, K/V table rebuild."""
    from repro_torch.serving.diffusion import DiffusionRequest
    reqs = []
    rid = 0
    for modality, n in (("image", 3), ("video", 2), ("t2i", 3)):
        for i in range(n):
            kw = {}
            if modality == "t2i":
                kw["prompt_tokens"] = ("cat", "dog")[i % 2]
                if i % 2 == 0:
                    kw["neg_prompt_tokens"] = "bad"
            reqs.append(DiffusionRequest(
                rid, num_steps=num_steps, seed=rid, class_label=i % 3,
                cfg_scale=2.0 if i % 2 == 0 else 0.0, modality=modality,
                **kw))
            rid += 1
    return reqs


@functools.lru_cache(maxsize=2)
def golden_context(device: str = "cuda") -> GoldenContext:
    ctx = GoldenContext(device=device)
    try:
        from repro_torch.modalities import MixedModalityEngine
        from .retrace import RetraceSentinel

        mixed = MixedModalityEngine(build_golden_engines(device))
        ctx.engines = mixed.pools
        mixed.warmup(verify=True)
        ctx.program_findings = list(mixed.ir_findings)

        # prove both channels see events BEFORE trusting the session's
        # zero (run outside the session sentinel)
        ctx.sentinel_live = RetraceSentinel().selftest()

        with RetraceSentinel() as sentinel:
            results = mixed.serve(golden_requests())
        ctx.retrace_count = sentinel.count
        ctx.retrace_names = list(sentinel.compiled_names)
        ctx.requests_served = len(results)
    except Exception as e:  # pragma: no cover - broken checkout
        ctx.error = repr(e)
    return ctx
