"""Mixed-modality serving: per-modality sub-pools under one umbrella — the
port of the JAX `modalities/serving.py`.

Latent row shapes differ per modality (a video clip's token axis is
frames x patches, an audio latent's channel axis is the mel-bin count), so
one batched tick cannot span modalities.  The mixed pool therefore runs ONE
DiffusionServingEngine per modality — each with its own slots, policies,
buckets and row accounting — and interleaves their tick-granular
ServeSessions round-robin under a single loop, so image, video and audio
requests make progress together.

Each sub-pool's ServingTelemetry keeps its own backbone row counters
(video rows are much wider than image rows, so they are never summed
without the per-modality split), and MixedTelemetry reports both the
per-modality breakdown and token-weighted totals.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.obs.clock import monotonic
from repro_torch.serving.diffusion import (SLA, DiffusionRequest,
                                           DiffusionResult,
                                           DiffusionServingEngine,
                                           ServingTelemetry, TunedPolicy,
                                           autotune)
from repro_torch.serving.diffusion.autotune import DEFAULT_CANDIDATES

from .spec import DenoiseWorkload


@dataclass
class MixedTelemetry:
    """Telemetry umbrella over the per-modality sub-pool telemetries."""
    pools: Dict[str, ServingTelemetry] = field(default_factory=dict)
    #: tokens per backbone row, per modality (row width — what makes raw
    #: row counts incomparable across pools)
    row_tokens: Dict[str, int] = field(default_factory=dict)
    elapsed_s: float = 0.0

    def by_modality(self) -> Dict[str, Dict[str, float]]:
        return {m: t.summary() for m, t in sorted(self.pools.items())}

    def summary(self) -> Dict[str, float]:
        per = self.by_modality()
        n = sum(s["requests"] for s in per.values())
        rows = {m: s["backbone_rows_computed"] for m, s in per.items()}
        saved = {m: s["backbone_rows_saved"] for m, s in per.items()}
        return {
            "requests": n,
            "requests_preempted": sum(s["requests_preempted"]
                                      for s in per.values()),
            "elapsed_s": self.elapsed_s,
            "throughput_rps": (n / self.elapsed_s if self.elapsed_s > 0
                               else 0.0),
            "backbone_rows_computed": sum(rows.values()),
            "backbone_rows_saved": sum(saved.values()),
            # token-weighted: a video row is frames x patches wide, so raw
            # row counts under-state the video pool's share of the compute
            "backbone_tokens_computed": sum(
                rows[m] * self.row_tokens.get(m, 1) for m in rows),
            "backbone_tokens_saved": sum(
                saved[m] * self.row_tokens.get(m, 1) for m in saved),
            "rows_by_modality": rows,
            "rows_saved_by_modality": saved,
        }


class MixedModalityEngine:
    """Serve image + video + audio requests through per-modality sub-pools
    under one loop and one telemetry umbrella.

    pools: {modality name: DiffusionServingEngine}.  Requests are routed by
    `DiffusionRequest.modality`; each sub-pool keeps its own slot count,
    cache policies and buckets.  Every round of the outer loop advances
    each unfinished sub-pool session once (round-robin), so a long video
    queue never starves the image pool and vice versa."""

    def __init__(self, pools: Mapping[str, DiffusionServingEngine]):
        if not pools:
            raise ValueError("MixedModalityEngine needs at least one pool")
        # one engine object per pool: sessions of one engine share its
        # per-slot tables and must never be interleaved
        if len({id(e) for e in pools.values()}) != len(pools):
            raise ValueError("each modality pool needs its own engine "
                             "instance (an engine hosts one session)")
        self.pools: Dict[str, DiffusionServingEngine] = dict(pools)
        #: findings of the last warmup(verify=True) over every pool: None =
        #: never verified, [] = verified clean
        self.ir_findings: Optional[List] = None
        #: MixedTelemetry of the most recent serve() call
        self.telemetry: Optional[MixedTelemetry] = None

    @classmethod
    def from_workloads(cls, workloads: Mapping[str, DenoiseWorkload],
                       policies: Optional[Mapping[str, object]] = None,
                       cfg_policies: Optional[Mapping[str, object]] = None,
                       conditioners: Optional[Mapping[str, object]] = None,
                       **engine_kw) -> "MixedModalityEngine":
        """One sub-pool per workload; `policies` / `cfg_policies` map
        modality -> policy (name or instance), defaulting to None.
        `conditioners` maps text modalities to their PromptCache — per
        modality, never in engine_kw: the non-text pools reject a
        conditioner."""
        policies = dict(policies or {})
        cfg_policies = dict(cfg_policies or {})
        conditioners = dict(conditioners or {})
        return cls({
            name: wl.engine(policies.get(name),
                            cfg_policy=cfg_policies.get(name),
                            conditioner=conditioners.get(name), **engine_kw)
            for name, wl in workloads.items()})

    def warmup(self, verify: bool = False) -> Dict[str, List]:
        """Run every sub-pool's tick programs once (each bucket of each
        modality shape), so the kernels are built and every batch shape is
        touched before the first mixed tick, and profile them into each
        pool's `program_profile`.  Returns {modality: the buckets run}
        (JAX returns the profiles).  `verify=True` verifies every pool's
        programs (`DiffusionServingEngine.warmup(verify=True)`) and sets
        `self.ir_findings` to all their findings ([] = every pool clean)."""
        runs = {m: eng.warmup(verify=verify) for m, eng in self.pools.items()}
        if verify:
            self.ir_findings = [f for _, eng in sorted(self.pools.items())
                                for f in eng.ir_findings]
        return runs

    def serve(self, requests: Sequence[DiffusionRequest],
              max_ticks: Optional[int] = None,
              hooks: Optional[Mapping[str, Sequence]] = None,
              metrics=None) -> List[DiffusionResult]:
        """Route requests to their modality sub-pools and interleave the
        sessions until all are done; results come back in request order.
        `max_ticks` bounds the outer loop (each sub-pool advances at most
        that many ticks); cut-off requests are recorded as preempted in
        their pool's telemetry.  `hooks` maps modality -> TickHook list;
        `metrics` (a repro_torch.obs MetricsRegistry) is shared across
        sub-pools, every sample labelled with its modality."""
        by_mod: Dict[str, List[DiffusionRequest]] = {}
        for r in requests:
            if r.modality not in self.pools:
                raise KeyError(f"request {r.request_id}: no pool for "
                               f"modality '{r.modality}' "
                               f"(pools: {sorted(self.pools)})")
            by_mod.setdefault(r.modality, []).append(r)

        t0 = monotonic()
        sessions = {}
        try:
            hooks = dict(hooks or {})
            for m, rs in by_mod.items():
                sessions[m] = self.pools[m].start_session(
                    rs, hooks=hooks.get(m), modality=m, metrics=metrics)
            ticks = 0
            while any(not s.done for s in sessions.values()):
                for s in sessions.values():
                    if not s.done:
                        s.tick()
                ticks += 1
                if max_ticks is not None and ticks >= max_ticks:
                    break
        finally:
            # also on a failed tick: release every engine's session latch
            # (finish() is idempotent; unfinished requests -> preempted)
            for s in sessions.values():
                s.finish()

        results: Dict[int, DiffusionResult] = {}
        for s in sessions.values():
            for res in s.finish():
                results[res.request_id] = res
        self.telemetry = MixedTelemetry(
            pools={m: s.tele for m, s in sessions.items()},
            row_tokens={m: self.pools[m].tokens for m in sessions},
            elapsed_s=monotonic() - t0)
        return [results[r.request_id] for r in requests
                if r.request_id in results]


def autotune_pools(workloads: Mapping[str, DenoiseWorkload], sla: SLA,
                   num_steps: int = 16, extra_candidates: Optional[
                       Mapping[str, Sequence]] = None,
                   **kw) -> Dict[str, TunedPolicy]:
    """One SLA-driven policy sweep per modality (the calibration reference
    is that modality's exact trajectory); video workloads add a temporal
    candidate (teacache_video with the clip's frame count) to the default
    sweep.  Returns {modality: TunedPolicy}."""
    out = {}
    for name, wl in workloads.items():
        cands = list(DEFAULT_CANDIDATES)
        if wl.spec.temporal:
            cands.append(("teacache_video",
                          {"delta": 0.1, "frames": wl.frames}))
        if extra_candidates and name in extra_candidates:
            cands.extend(extra_candidates[name])
        out[name] = autotune(wl.params, wl.cfg, sla, candidates=cands,
                             num_steps=num_steps, **kw)
    return out
