"""SLA-driven cache-policy autotuning for the diffusion serving engine —
the port of the JAX `serving/diffusion/autotune.py`.

The autotuner sweeps candidate (policy, hyperparams) pairs on a small
calibration batch against the exact (uncached) trajectory and picks, per
traffic class, the cheapest candidate that still meets the SLA:

    minimize   compute_fraction                 (~ 1/speedup, survey §III-B)
    subject to PSNR(x0_policy, x0_exact) >= sla.min_psnr
               est_latency <= sla.max_latency_ms     (when timings given)

falling back to the highest-PSNR candidate when nothing is feasible, so
the server keeps serving under an over-tight SLA.

With `cfg_scale > 0` the reference is the exact two-branch guided
trajectory and each candidate is also swept over `cfg_intervals`
(unconditional-branch reuse intervals: None = naive two-branch, N =
FasterCacheCFG(interval=N)); the cost becomes the row-weighted fraction
(cond computes + uncond computes) / (2 T).

Latency is priced in backbone rows: T * (occupancy * rows_per_step *
ms_per_row + tick_overhead_ms) with `row_time_ms` from
`ServingTelemetry.row_time_ms()`, plus a per-step `plan_ms` surcharge for
candidates the engine cannot plan on the host; `step_time_ms` (tick-kind
pricing) is the fallback.

The calibration runs on the params' device.  Its initial latent is drawn
from a `torch.Generator` seeded with `seed`, which draws differently from
`jax.random`, so the calibration noise (not the method) differs from JAX's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (CachePolicy, FasterCacheCFG, make_policy, psnr,
                              static_plan)
from repro_torch.device import tree_device
from repro_torch.diffusion import ddim_step, linear_schedule, sample
from repro_torch.diffusion.pipeline import CachedDenoiser, cfg_denoise_fn


@dataclass(frozen=True)
class SLA:
    """Per-traffic-class serving objective."""
    name: str = "default"
    min_psnr: float = 20.0           # quality floor vs the exact trajectory
    max_latency_ms: Optional[float] = None  # per-request budget (optional)


@dataclass
class TunedPolicy:
    """Autotuner output: a constructible policy choice + its measurements."""
    policy_name: str
    kwargs: Dict = field(default_factory=dict)
    psnr: float = 0.0
    #: minimized cost: cond compute fraction for unguided tuning, the
    #: row-weighted (cond + uncond) / 2 fraction for guided tuning
    compute_fraction: float = 1.0
    est_latency_ms: Optional[float] = None
    feasible: bool = True
    #: guided tuning only: FasterCacheCFG reuse interval (None = naive
    #: two-branch) and the resulting uncond-branch compute fraction
    cfg_interval: Optional[int] = None
    uncond_compute_fraction: float = 0.0
    #: cond-branch compute fraction alone (== compute_fraction unguided)
    cond_compute_fraction: float = 1.0
    #: True when the engine plans every tick on the host (both branches'
    #: want_compute are step-only); else `price_and_pick` charges plan_ms
    static_plan: bool = True

    def make(self) -> CachePolicy:
        return make_policy(self.policy_name, **self.kwargs)

    def make_cfg_policy(self, num_steps: int) -> Optional[CachePolicy]:
        """The tuned uncond-branch gate, or None for naive two-branch
        guidance."""
        if self.cfg_interval is None:
            return None
        return FasterCacheCFG(self.cfg_interval, num_steps)

    @property
    def align(self) -> int:
        """Phase-alignment interval for the serving scheduler: the lcm of
        the two branch intervals so their refreshes land on shared ticks."""
        a = max(int(self.kwargs.get("interval", 1)), 1)
        b = max(int(self.cfg_interval or 1), 1)
        return a * b // math.gcd(a, b)


#: default sweep: one representative per taxonomy branch, two operating
#: points for the interval-scheduled families
DEFAULT_CANDIDATES: List[Tuple[str, Dict]] = [
    ("none", {}),
    ("fora", {"interval": 2}),
    ("fora", {"interval": 4}),
    ("taylorseer", {"interval": 2, "order": 1}),
    ("taylorseer", {"interval": 4, "order": 2}),
    ("teacache", {"delta": 0.1}),
    ("teacache", {"delta": 0.3}),
    ("magcache", {"delta": 0.1}),
    ("freqca", {"interval": 4}),
]


def _plans_on_host(policy: CachePolicy, num_steps: int) -> bool:
    """The serving engine's static-plan probe: True when want_compute is a
    pure function of the step, so ticks are planned on the host."""
    return static_plan(policy, num_steps) is not None


def _measured_compute_fraction(policy: CachePolicy, state,
                               num_steps: int) -> float:
    """Computes issued / steps, from whichever counter the policy keeps."""
    pol = state.get("policy", {}) if isinstance(state, dict) else {}
    if isinstance(pol, dict):
        for key in ("n_compute", "n_valid"):
            if key in pol:
                return float(pol[key]) / max(num_steps, 1)
    sched = policy.static_schedule(num_steps)
    if sched is not None:
        return sum(map(bool, sched)) / max(num_steps, 1)
    return 1.0


def calibration_reference(params, cfg, num_steps: int, batch: int = 1,
                          seed: int = 0, noise_schedule=None,
                          cfg_scale: float = 0.0, class_label: int = 0):
    """Exact (uncached) calibration trajectory shared by all candidates, on
    the params' device: (schedule, timesteps, xT, exact x0 as numpy).
    With cfg_scale > 0 it is the exact two-branch guided trajectory."""
    dev = tree_device(params)
    sched = noise_schedule or linear_schedule(1000)
    ts = sched.spaced(num_steps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xT = torch.randn((batch, cfg.dit_tokens, cfg.dit_in_dim), generator=gen,
                     device=dev)
    exact, _ = sample(cfg_denoise_fn(params, cfg, cfg_scale, class_label),
                      xT, ts, sched, step_fn=ddim_step)
    return sched, ts, xT, exact.cpu().numpy()


def evaluate_candidate(name: str, kwargs: Dict, params, cfg, sched, ts, xT,
                       exact: np.ndarray, cfg_scale: float = 0.0,
                       cfg_interval: Optional[int] = None,
                       class_label: int = 0) -> Tuple[float, float, float]:
    """Run one candidate on the calibration trajectory.

    Returns (psnr_db, cond_compute_fraction, uncond_compute_fraction)."""
    policy = make_policy(name, **kwargs)
    cfg_pol = (FasterCacheCFG(cfg_interval, len(ts))
               if (cfg_scale > 0.0 and cfg_interval is not None) else None)
    den = CachedDenoiser(params, cfg, policy, cfg_scale=cfg_scale,
                         cfg_policy=cfg_pol, class_label=class_label,
                         device=xT.device)
    x0, state = sample(den, xT, ts, sched, step_fn=ddim_step,
                       denoiser_state=den.init_state(xT.shape[0]))
    q = float(psnr(x0.cpu(), torch.as_tensor(exact)))
    cf = _measured_compute_fraction(policy, state, len(ts))
    if cfg_scale <= 0.0:
        cf_u = 0.0
    elif cfg_pol is None:
        cf_u = 1.0                      # naive: uncond recomputes every step
    else:
        cf_u = sum(map(bool, cfg_pol.static_schedule(len(ts)))) / max(
            len(ts), 1)
    return q, cf, cf_u


def sweep_candidates(params, cfg,
                     candidates: Optional[Sequence[Tuple[str, Dict]]] = None,
                     num_steps: int = 16, batch: int = 1, seed: int = 0,
                     noise_schedule=None, cfg_scale: float = 0.0,
                     cfg_intervals: Sequence[Optional[int]] = (None,),
                     verbose: bool = False) -> List[TunedPolicy]:
    """Quality sweep: PSNR against the exact trajectory and per-branch
    compute fractions of every candidate — traffic-independent, so the
    list can be re-priced (`price_and_pick`) without re-running it."""
    candidates = list(candidates if candidates is not None
                      else DEFAULT_CANDIDATES)
    cfg_ivs = list(cfg_intervals) if cfg_scale > 0.0 else [None]
    sched, ts, xT, exact = calibration_reference(
        params, cfg, num_steps, batch, seed, noise_schedule,
        cfg_scale=cfg_scale)

    evaluated: List[TunedPolicy] = []
    for name, kwargs in candidates:
        # the full hyperparameters, so TunedPolicy.make() rebuilds exactly
        # what was calibrated (magcache sizes its gamma curve from num_steps)
        kwargs = dict(kwargs)
        kwargs.setdefault("num_steps", num_steps)
        host_plan = _plans_on_host(make_policy(name, **kwargs), num_steps)
        for ci in cfg_ivs:
            q, cf, cf_u = evaluate_candidate(
                name, kwargs, params, cfg, sched, ts, xT, exact,
                cfg_scale=cfg_scale, cfg_interval=ci)
            cost = (cf + cf_u) / 2.0 if cfg_scale > 0.0 else cf
            # host-planned only when BOTH branches are step-only (ci None
            # means an all-True host plan)
            static = host_plan and (
                ci is None
                or _plans_on_host(FasterCacheCFG(ci, num_steps), num_steps))
            evaluated.append(TunedPolicy(name, dict(kwargs), psnr=q,
                                         compute_fraction=cost,
                                         cfg_interval=ci,
                                         uncond_compute_fraction=cf_u,
                                         cond_compute_fraction=cf,
                                         static_plan=static))
            if verbose:
                tag = f" cfg_iv={ci}" if cfg_scale > 0.0 else ""
                print(f"  {name:12s} {kwargs}{tag} "
                      f"psnr={q:6.2f}dB cf={cost:.3f}")
    return evaluated


def price_and_pick(evaluated: Sequence[TunedPolicy], sla: SLA,
                   num_steps: int = 16,
                   step_time_ms: Optional[Tuple[float, float]] = None,
                   row_time_ms: Optional[Tuple[float, float]] = None,
                   occupancy: int = 1,
                   plan_ms: float = 0.0,
                   verbose: bool = False,
                   registry=None) -> TunedPolicy:
    """Price swept candidates against timings and pick for the SLA.

    Host arithmetic over the `sweep_candidates` output.  With row pricing
    the pick minimizes estimated latency (quality breaks ties); without
    timings it minimizes the compute fraction.  `plan_ms` (the host cost of
    the device want pass a tick) is charged per step to candidates without
    a host plan.  Falls back to the highest-PSNR candidate, marked
    infeasible, when nothing meets the SLA.  `registry` (a
    `repro_torch.obs.MetricsRegistry`) records the pick as an event."""
    priced: List[TunedPolicy] = []
    for t in evaluated:
        rows_per_step = t.cond_compute_fraction + t.uncond_compute_fraction
        lat = None
        if row_time_ms is not None:
            t_row, t_tick = row_time_ms
            lat = num_steps * (max(occupancy, 1) * rows_per_step * t_row
                               + t_tick)
            if not t.static_plan:
                lat += num_steps * max(plan_ms, 0.0)
        elif step_time_ms is not None:
            t_full, t_skip = step_time_ms
            cost = t.compute_fraction
            lat = num_steps * (cost * t_full + (1.0 - cost) * t_skip)
        ok = t.psnr >= sla.min_psnr and (
            lat is None or sla.max_latency_ms is None
            or lat <= sla.max_latency_ms)
        priced.append(replace(t, est_latency_ms=lat, feasible=ok))
        if verbose:
            tag = (f" cfg_iv={t.cfg_interval}"
                   if t.cfg_interval is not None else "")
            lat_s = f" lat={lat:.1f}ms" if lat is not None else ""
            print(f"  [{sla.name}] {t.policy_name:12s} {t.kwargs}{tag} "
                  f"psnr={t.psnr:6.2f}dB cf={t.compute_fraction:.3f}"
                  f"{lat_s} {'ok' if ok else 'infeasible'}")

    feasible = [t for t in priced if t.feasible]
    if feasible:
        if row_time_ms is not None:
            pick = min(feasible, key=lambda t: (t.est_latency_ms, -t.psnr))
        else:
            pick = min(feasible, key=lambda t: (t.compute_fraction, -t.psnr))
    else:
        best = max(priced, key=lambda t: t.psnr)
        pick = replace(best, feasible=False)
    if registry is not None:
        registry.event(
            "autotune.price_and_pick", sla=sla.name,
            picked=pick.policy_name, feasible=pick.feasible,
            n_candidates=len(priced), n_feasible=len(feasible),
            est_latency_ms=pick.est_latency_ms,
            row_time_ms=row_time_ms, occupancy=occupancy, plan_ms=plan_ms)
    return pick


def autotune(params, cfg, sla: SLA,
             candidates: Optional[Sequence[Tuple[str, Dict]]] = None,
             num_steps: int = 16, batch: int = 1, seed: int = 0,
             noise_schedule=None,
             step_time_ms: Optional[Tuple[float, float]] = None,
             row_time_ms: Optional[Tuple[float, float]] = None,
             occupancy: int = 1,
             cfg_scale: float = 0.0,
             cfg_intervals: Sequence[Optional[int]] = (None,),
             verbose: bool = False) -> TunedPolicy:
    """Sweep candidates against `sla` on a calibration batch and pick: the
    composition of `sweep_candidates` (quality) and `price_and_pick`
    (pricing).  `row_time_ms` / `step_time_ms` and `occupancy` as in
    `price_and_pick`; `cfg_scale > 0` tunes for guided traffic over
    `cfg_intervals`."""
    evaluated = sweep_candidates(
        params, cfg, candidates=candidates, num_steps=num_steps, batch=batch,
        seed=seed, noise_schedule=noise_schedule, cfg_scale=cfg_scale,
        cfg_intervals=cfg_intervals)
    return price_and_pick(evaluated, sla, num_steps=num_steps,
                          step_time_ms=step_time_ms, row_time_ms=row_time_ms,
                          occupancy=occupancy, verbose=verbose)


def autotune_traffic_classes(params, cfg, slas: Mapping[str, SLA],
                             **kw) -> Dict[str, TunedPolicy]:
    """One tuned policy per traffic class (e.g. interactive vs quality)."""
    return {name: autotune(params, cfg, sla, **kw)
            for name, sla in slas.items()}
