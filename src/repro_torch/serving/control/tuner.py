"""OnlineTuner / ControlPlane — live policy retuning at refill boundaries;
the port of the JAX `serving/control/tuner.py`.

The offline autotuner picks one policy per traffic class before serving
starts, priced with whatever timings the operator measured once.  The
online tuner closes the loop while the engine serves:

  1. quality sweep ONCE at startup (`sweep_candidates` — PSNR and compute
     fractions are traffic-independent, so they never need re-measuring);
  2. a TelemetryWindow hook watches the live engine (row_time_ms,
     occupancy);
  3. every `retune_every` ticks, `price_and_pick` re-prices the cached
     sweep against the window (host-side arithmetic over ~10 candidates —
     cheap enough for every window) and, if a different candidate wins,
     ROLLS OVER to it.

Rollover is blue/green at the session level, which is what makes the
"never mutate in-flight slots" invariant structural rather than policed:
policy hyperparameters are baked into an engine's slot functions and
per-slot cache states, so the tuner never touches a live engine.  Instead
the active session stops receiving new submissions and keeps ticking until
its in-flight requests drain under the policy they were admitted with
(reset-on-refill untouched), while a fresh session — on a cached engine for
the new candidate, or a newly built one — becomes the admission target and
inherits the old session's un-admitted backlog.
Policy swaps therefore apply exactly at refill boundaries: a request's
whole trajectory runs under one policy, the one that admitted it.

ControlPlane bundles one OnlineTuner per modality behind a single
submit/tick/drain surface — the mixed-modality umbrella with a control
loop per sub-pool.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import tree_device
from repro_torch.obs.clock import monotonic
from repro_torch.serving.diffusion import (SLA, DiffusionRequest,
                                           DiffusionResult,
                                           DiffusionServingEngine,
                                           ServeSession, TunedPolicy,
                                           price_and_pick, sweep_candidates)

from .trace import SignalTraceLog
from .window import TelemetryWindow


def _stable(v):
    """A hashable, device-independent stand-in for one kwarg value.

    A tensor or array becomes (dtype, shape, sha1 of its bytes on the
    host): `repr` of a torch tensor elides values past a size and carries
    the device, so two equal gates on different devices (or two large
    gates that differ past the elision) would otherwise key wrongly.
    Mappings and sequences recurse; anything else keys by its repr, as in
    JAX."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        return ("array", a.dtype.str, a.shape,
                hashlib.sha1(a.tobytes()).hexdigest())
    if isinstance(v, Mapping):
        return tuple((k, _stable(v[k])) for k in sorted(v))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_stable(x) for x in v))
    return repr(v)


def _policy_key(t: TunedPolicy) -> Tuple:
    """Identity of a tuned operating point (kwargs may hold unhashable
    values like gate tensors — see `_stable`)."""
    return (t.policy_name, _stable(dict(t.kwargs)), t.cfg_interval)


class OnlineTuner:
    """One modality sub-pool's control loop: sweep once, watch the window,
    re-pick at refill boundaries via blue/green session rollover."""

    def __init__(self, params, cfg, sla: SLA, *,
                 slots: int = 4, max_steps: int = 16,
                 modality: str = "image",
                 candidates: Optional[Sequence[Tuple[str, Dict]]] = None,
                 cfg_scale: float = 0.0,
                 cfg_intervals: Sequence[Optional[int]] = (None,),
                 calib_batch: int = 1, seed: int = 0,
                 retune_every: int = 64, min_window_ticks: int = 8,
                 window: Optional[TelemetryWindow] = None,
                 trace: Optional[SignalTraceLog] = None,
                 initial: Union[TunedPolicy, Tuple[str, Dict], None] = None,
                 engine_kw: Optional[Dict] = None,
                 warmup: bool = False, verbose: bool = False,
                 registry=None):
        self.params, self.cfg, self.sla = params, cfg, sla
        self.slots, self.max_steps = slots, max_steps
        self.modality = modality
        self.retune_every = int(retune_every)
        self.min_window_ticks = int(min_window_ticks)
        self.window = window if window is not None else TelemetryWindow()
        self.trace = trace
        self.engine_kw = dict(engine_kw or {})
        # engines run where the params live (the caller chose the device)
        self.engine_kw.setdefault("device", tree_device(params))
        self._warmup = bool(warmup)
        self.verbose = bool(verbose)
        #: optional repro_torch.obs MetricsRegistry: retune decisions become
        #: repro_control_* counters and blue/green swaps land in the event
        #: ring; sessions opened by this tuner publish repro_engine_* too
        self.registry = registry

        # 1. quality sweep once: PSNR / compute fractions are
        # traffic-independent, so retunes only ever re-PRICE this list
        self.swept: List[TunedPolicy] = sweep_candidates(
            params, cfg, candidates=candidates, num_steps=max_steps,
            batch=calib_batch, seed=seed, cfg_scale=cfg_scale,
            cfg_intervals=cfg_intervals, verbose=verbose)

        if initial is None:
            # no live timings yet: pick on quality/compute alone
            self.current = price_and_pick(self.swept, sla,
                                          num_steps=max_steps,
                                          registry=self.registry)
        elif isinstance(initial, TunedPolicy):
            self.current = initial
        else:                              # ("name", {kwargs}) shorthand
            name, kwargs = initial
            match = [t for t in self.swept if t.policy_name == name
                     and all(_stable(t.kwargs.get(k)) == _stable(v)
                             for k, v in kwargs.items())]
            self.current = (match[0] if match
                            else TunedPolicy(name, dict(kwargs)))

        #: engines cached per tuned operating point (hyperparameters are
        #: baked into an engine's slot functions — an engine can be REUSED
        #: for a policy it was built for, once its previous session
        #: finished, but never retuned in place)
        self._engines: Dict[Tuple, List[DiffusionServingEngine]] = {}
        #: audit log of applied swaps
        self.swaps: List[Dict] = []
        self.results: Dict[int, DiffusionResult] = {}
        self._order: List[int] = []
        self.ticks = 0

        self.active: ServeSession = self._new_session(self.current)
        #: sessions rolled over but still draining in-flight requests
        #: under the policy that admitted them
        self.draining: List[ServeSession] = []

    # ------------------------------------------------------------------
    def _engine_for(self, tuned: TunedPolicy) -> DiffusionServingEngine:
        key = _policy_key(tuned)
        for eng in self._engines.get(key, []):
            if not eng._session_active:
                return eng
        eng = DiffusionServingEngine(
            self.params, self.cfg, tuned.make(),
            slots=self.slots, max_steps=self.max_steps,
            cfg_policy=tuned.make_cfg_policy(self.max_steps),
            **self.engine_kw)
        if self._warmup:
            eng.warmup()
        self._engines.setdefault(key, []).append(eng)
        return eng

    def prewarm(self) -> None:
        """Build and warm an engine for every swept candidate so a later
        rollover swaps onto an engine whose programs already ran (kernels
        built, every bucket touched) instead of paying that mid-traffic.
        Optional: engines are otherwise built lazily at the first swap onto
        their candidate."""
        for t in self.swept:
            self._engine_for(t).warmup()

    def _new_session(self, tuned: TunedPolicy) -> ServeSession:
        hooks = [self.window.observe]
        capture = False
        if self.trace is not None:
            hooks.append(self.trace.observe)
            capture = self.trace.wants_latents
        return self._engine_for(tuned).start_session(
            [], hooks=hooks, capture_latents=capture,
            modality=self.modality, metrics=self.registry)

    # ------------------------------------------------------------------
    def submit(self, request: DiffusionRequest) -> None:
        """Enqueue on the ACTIVE session — new admissions always see the
        current policy; draining sessions take no new work.  After a drain/
        finish the tuner stays live: the next submit opens a fresh session
        on the current policy (bursty traffic, serve-measure-serve loops)."""
        if self.active._finished:
            self.active = self._new_session(self.current)
        self._order.append(request.request_id)
        self.active.submit(request)

    def submit_all(self, requests: Sequence[DiffusionRequest]) -> None:
        for r in requests:
            self.submit(r)

    @property
    def done(self) -> bool:
        return self.active.done and not self.draining

    def _collect(self, session: ServeSession) -> None:
        for rid, res in session.results.items():
            self.results.setdefault(rid, res)

    def tick(self) -> None:
        """Advance the active session and every draining session one tick;
        retire drained sessions; retune on the cadence."""
        if not self.active.done:
            self.active.tick()
        for s in self.draining:
            if not s.done:
                s.tick()
        for s in list(self.draining):
            if s.done:
                s.finish()          # releases the engine for reuse
                self._collect(s)
                self.draining.remove(s)
        self._collect(self.active)
        self.ticks += 1
        if self.retune_every > 0 and self.ticks % self.retune_every == 0:
            self.maybe_retune()

    def drain(self, max_ticks: int = 100_000) -> List[DiffusionResult]:
        """Tick until every session (active + draining) is done; results in
        submission order."""
        ticks = 0
        while not self.done and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finish()

    def finish(self) -> List[DiffusionResult]:
        """Close every session (idempotent) and return completed results
        in submission order."""
        for s in [self.active] + self.draining:
            s.finish()
            self._collect(s)
        return [self.results[rid] for rid in self._order
                if rid in self.results]

    # ------------------------------------------------------------------
    def maybe_retune(self,
                     force_to: Optional[TunedPolicy] = None
                     ) -> Optional[TunedPolicy]:
        """Re-price the sweep against the live window and roll over if a
        different candidate wins.  Returns the new TunedPolicy when a swap
        happened, else None.  `force_to` bypasses the pricing (tests and
        operator overrides)."""
        row_time = self.window.row_time_ms()
        occ = self.window.occupancy()
        if force_to is not None:
            pick = force_to
        else:
            if (row_time is None
                    or len(self.window.ticks) < self.min_window_ticks):
                return None                 # window not informative yet
            pick = price_and_pick(self.swept, self.sla,
                                  num_steps=self.max_steps,
                                  row_time_ms=row_time, occupancy=occ,
                                  plan_ms=self.window.plan_time_ms(),
                                  verbose=self.verbose,
                                  registry=self.registry)
            if self.registry is not None:
                self.registry.counter(
                    "repro_control_retunes_total",
                    "Window re-pricings of the candidate sweep."
                ).inc(modality=self.modality,
                      swapped=str(_policy_key(pick)
                                  != _policy_key(self.current)).lower())
        if _policy_key(pick) == _policy_key(self.current):
            return None
        self._swap(pick, row_time, occ)
        return pick

    def _swap(self, pick: TunedPolicy, row_time, occ: int) -> None:
        """Blue/green rollover at the refill boundary: the old session
        drains its in-flight requests under the policy that admitted them
        (per-slot cache state and slot functions untouched); only NEW
        submissions land on the new policy's session."""
        old = self.active
        self.draining.append(old)
        self.active = self._new_session(pick)
        # in-flight slots stay on `old` until they drain, but the
        # un-admitted backlog follows the admission target — otherwise a
        # rollover would leave queued requests serving under the policy
        # the tuner just decided against
        for r in old.transfer_queued():
            self.active.submit(r)
        self.swaps.append({
            "tick": self.ticks, "time": monotonic(),
            "from": (self.current.policy_name, dict(self.current.kwargs),
                     self.current.cfg_interval),
            "to": (pick.policy_name, dict(pick.kwargs), pick.cfg_interval),
            "row_time_ms": row_time, "occupancy": occ,
            "plan_time_ms": self.window.plan_time_ms(),
            "est_latency_ms": pick.est_latency_ms,
        })
        if self.registry is not None:
            self.registry.counter(
                "repro_control_swaps_total",
                "Blue/green session rollovers applied by the online tuner."
            ).inc(modality=self.modality, to=pick.policy_name)
            self.registry.event(
                "control.swap", modality=self.modality, tick=self.ticks,
                policy_from=self.current.policy_name,
                policy_to=pick.policy_name,
                row_time_ms=row_time, occupancy=occ,
                est_latency_ms=pick.est_latency_ms)
        self.current = pick
        if self.verbose:
            print(f"[control:{self.modality}] tick {self.ticks}: "
                  f"{self.swaps[-1]['from']} -> {self.swaps[-1]['to']} "
                  f"(row_time={row_time}, occupancy={occ})")

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        return {
            "modality": self.modality,
            "policy": self.current.policy_name,
            "policy_kwargs": {k: v for k, v in self.current.kwargs.items()
                              if not hasattr(v, "keys")},
            "cfg_interval": self.current.cfg_interval,
            "swaps": len(self.swaps),
            "ticks": self.ticks,
            "draining_sessions": len(self.draining),
            "requests_completed": len(self.results),
            "window": self.window.summary(),
            **({"trace": self.trace.summary()}
               if self.trace is not None else {}),
        }


class ControlPlane:
    """Per-modality OnlineTuners behind one submit/tick/drain surface."""

    def __init__(self, tuners: Mapping[str, OnlineTuner],
                 registry=None):
        if not tuners:
            raise ValueError("ControlPlane needs at least one tuner")
        self.tuners: Dict[str, OnlineTuner] = dict(tuners)
        self._order: List[int] = []
        #: optional repro_torch.obs MetricsRegistry; also handed to tuners that
        #: don't already publish somewhere
        self.registry = registry
        if registry is not None:
            for t in self.tuners.values():
                if t.registry is None:
                    t.registry = registry

    def submit(self, request: DiffusionRequest) -> None:
        if request.modality not in self.tuners:
            raise KeyError(f"request {request.request_id}: no tuner for "
                           f"modality '{request.modality}' "
                           f"(tuners: {sorted(self.tuners)})")
        self._order.append(request.request_id)
        if self.registry is not None:
            self.registry.counter(
                "repro_control_submitted_total",
                "Requests submitted through the control plane."
            ).inc(modality=request.modality,
                  traffic_class=request.traffic_class)
        self.tuners[request.modality].submit(request)

    def submit_all(self, requests: Sequence[DiffusionRequest]) -> None:
        for r in requests:
            self.submit(r)

    @property
    def done(self) -> bool:
        return all(t.done for t in self.tuners.values())

    def tick(self) -> None:
        """Round-robin: advance each non-idle modality loop one tick."""
        for t in self.tuners.values():
            if not t.done:
                t.tick()

    def drain(self, max_ticks: int = 100_000) -> List[DiffusionResult]:
        ticks = 0
        while not self.done and ticks < max_ticks:
            self.tick()
            ticks += 1
        results: Dict[int, DiffusionResult] = {}
        for t in self.tuners.values():
            for res in t.finish():
                results[res.request_id] = res
        return [results[rid] for rid in self._order if rid in results]

    def summary(self) -> Dict[str, Dict]:
        return {m: t.summary() for m, t in sorted(self.tuners.items())}
