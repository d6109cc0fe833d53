"""SignalTraceLog — per-slot signal traces from a live engine, and the
learned want_compute predictor trained on them; the port of the JAX
`serving/control/trace.py`.

The survey's arc is static reuse -> dynamic prediction -> learned
prediction.  The serving engine already *computes* the dynamic signals
every tick (TeaCache accumulated distances, FasterCacheCFG refresh
decisions) — the fused want pass returns them as the per-slot `metric` in
the tick's one read back.  This module keeps them:

  * SignalTraceLog.observe — a TickHook recording one TraceEntry per active
    slot per tick (ring-bounded): (tick, request id, step, want_cond,
    want_uncond, metric).  This is the serving-side dataset the survey's
    learned methods assume exists.
  * Probe capture — every `probe_every`-th admitted request additionally
    logs its pre-tick latent trajectory (needs the session started with
    `capture_latents=True`; the tuner does this automatically when given a
    probing trace log).
  * probe_training_set — replays the backbone over each probe's logged
    latents in ONE batched forward (the trajectory axis is the batch axis,
    so the flash kernel runs with B equal to the probe length) to produce
    (inputs, exact outputs) teacher pairs.
  * fit_want_gate — trains the LazyDiT gate (repro_torch.core.learned) on
    those pairs with the HarmoniCa-style full-trajectory soft-skip loss.
    The result serves through `make_policy("lazydit", gate=...)` — a
    learned want_compute flowing through the row-compacted bucket path,
    where a misprediction costs one gathered row, not a pool tick.

The gate's initial weights come from a `torch.Generator` (JAX: a PRNG key).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.learned import _sgd, init_gate, lazy_trajectory_loss
from repro_torch.device import tree_device
from repro_torch.diffusion.pipeline import backbone_fns
from repro_torch.serving.diffusion.engine import TickEvent


@dataclass(frozen=True)
class TraceEntry:
    """One (slot, tick) observation of the serving-time cache decisions."""
    tick: int
    modality: str
    request_id: int
    step: int
    want_cond: bool
    want_uncond: bool
    #: the scalar the refresh decision thresholded on (CachePolicy
    #: .want_metric — TeaCache's corrected accumulated distance, LazyDiT's
    #: gate score, 0.0 under host-side static plans)
    metric: float
    guided: bool


class SignalTraceLog:
    """Ring-bounded log of per-slot serving signals + probe trajectories."""

    def __init__(self, max_entries: int = 4096, probe_every: int = 0,
                 max_probes: int = 8, max_probe_steps: int = 64):
        self.entries: Deque[TraceEntry] = deque(maxlen=max_entries)
        self.entries_seen = 0
        #: probe capture: every probe_every-th admitted request logs its
        #: latent trajectory (0 disables probing)
        self.probe_every = int(probe_every)
        self.max_probes = int(max_probes)
        self.max_probe_steps = int(max_probe_steps)
        #: request_id -> {"label", "steps", "tvals", "xs"}
        self.probes: Dict[int, Dict] = {}
        self._admitted = 0

    @property
    def wants_latents(self) -> bool:
        """Should sessions feeding this log run with capture_latents?"""
        return self.probe_every > 0

    # ------------------------------------------------------------------
    def observe(self, event: TickEvent) -> None:
        """TickHook entry point."""
        for req in event.admitted:
            self._admitted += 1
            if (self.probe_every > 0
                    and (self._admitted - 1) % self.probe_every == 0
                    and len(self.probes) < self.max_probes):
                self.probes.setdefault(req.request_id, {
                    "label": int(req.class_label), "steps": [],
                    "tvals": [], "xs": []})

        active = np.asarray(event.active, bool)
        metric = (np.asarray(event.metric)
                  if event.metric is not None else None)
        for s in np.nonzero(active)[0]:
            rid = int(event.request_ids[s])
            self.entries.append(TraceEntry(
                tick=event.tick, modality=event.modality, request_id=rid,
                step=int(event.steps[s]),
                want_cond=bool(event.want_cond[s]),
                want_uncond=bool(event.want_uncond[s]),
                metric=float(metric[s]) if metric is not None else 0.0,
                guided=bool(event.guided[s])))
            self.entries_seen += 1
            probe = self.probes.get(rid)
            if (probe is not None and event.latents is not None
                    and len(probe["steps"]) < self.max_probe_steps):
                probe["steps"].append(int(event.steps[s]))
                probe["tvals"].append(float(event.tvals[s]))
                probe["xs"].append(np.asarray(event.latents[s]))

    # ------------------------------------------------------------------
    def by_request(self, request_id: int) -> List[TraceEntry]:
        return [e for e in self.entries if e.request_id == request_id]

    def summary(self) -> Dict[str, float]:
        n = len(self.entries)
        return {
            "entries": n,
            "entries_seen": self.entries_seen,
            "probes": len(self.probes),
            "probe_steps": sum(len(p["steps"]) for p in self.probes.values()),
            "want_cond_rate": (sum(e.want_cond for e in self.entries) / n
                               if n else 0.0),
            "want_uncond_rate": (sum(e.want_uncond for e in self.entries) / n
                                 if n else 0.0),
            "metric_mean": (sum(e.metric for e in self.entries) / n
                            if n else 0.0),
        }


# ----------------------------------------------------------------------
# learned want_compute: probe trajectories -> teacher pairs -> gate
# ----------------------------------------------------------------------

def probe_training_set(params, cfg, trace: SignalTraceLog,
                       min_steps: int = 3) -> List[Tuple]:
    """Teacher pairs from the log's probe trajectories, on the params'
    device.

    For each probed request, replays the backbone over the logged pre-tick
    latents in ONE batched forward (trajectory axis == batch axis — the
    same layout trick the serving engine uses for slots) and returns
    [(inputs (T, tokens, D), exact outputs (T, tokens, D)), ...].  Probes
    shorter than `min_steps` carry no skippable structure and are dropped."""
    forward_fn, _ = backbone_fns(params, cfg)
    dev = tree_device(params)
    sets = []
    with torch.no_grad():
        for rid in sorted(trace.probes):
            p = trace.probes[rid]
            if len(p["xs"]) < min_steps:
                continue
            xs = torch.as_tensor(np.stack(p["xs"]), dtype=torch.float32,
                                 device=dev)
            tv = torch.as_tensor(np.asarray(p["tvals"], np.float32),
                                 device=dev)
            labels = torch.full((xs.shape[0],), int(p["label"]),
                                dtype=torch.long, device=dev)
            sets.append((xs, forward_fn(xs, tv, labels)))
    return sets


def fit_want_gate(generator: torch.Generator, trajectories, *,
                  steps: int = 150, lr: float = 0.05, rho: float = 0.1):
    """Train a LazyDiT gate on (inputs, outputs) trajectory pairs.

    Mean of the HarmoniCa-style full-trajectory soft-skip loss over all
    trajectories (each rolled out with its own carried cache, so no
    cross-request boundary artifacts), plain SGD from
    `init_gate(generator, D)` on the trajectories' device.  Returns
    (gate, loss_history), the gate detached; serve it via
    make_policy("lazydit", gate=gate, threshold=...)."""
    if not trajectories:
        raise ValueError("fit_want_gate needs at least one probe "
                         "trajectory (is SignalTraceLog.probe_every set, "
                         "and the session capturing latents?)")
    first = trajectories[0][0]
    gate = init_gate(generator, first.shape[-1], device=first.device)

    def loss_fn(g):
        losses = [lazy_trajectory_loss(g, i, o, rho=rho)
                  for i, o in trajectories]
        return sum(losses) / len(losses)

    return _sgd(gate, loss_fn, steps, lr)
