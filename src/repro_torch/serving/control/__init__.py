"""repro_torch.serving.control — online control plane for cache-aware
serving; the port of the JAX `repro.serving.control`.

The serving engine executes per-slot cache policies; this package decides
WHICH policy, continuously, from the running system itself:

  window      — TelemetryWindow: a TickHook keeping sliding-window serving
                stats (backbone row times, occupancy, compute fraction,
                want-metric means, attached PSNR proxies) shaped exactly
                like the autotuner's pricing inputs
  tuner       — OnlineTuner: quality-sweep once, re-price per window,
                blue/green session rollover at refill boundaries (in-flight
                slots finish under the policy that admitted them);
                ControlPlane: one tuner per modality sub-pool behind a
                single submit/tick/drain surface
  trace       — SignalTraceLog: ring-bounded per-slot signal traces
                (want_cond / want_uncond / want_metric per tick) + probe
                latent trajectories; probe_training_set / fit_want_gate
                turn them into a learned want_compute predictor served via
                make_policy("lazydit", gate=...)
  smoothcache — SmoothCacheSchedule: calibrate-once static per-modality
                schedule (profile rel-L1 drift, greedy threshold), the
                static baseline the online tuner is benchmarked against
"""
from .smoothcache import (SmoothCacheSchedule, calibration_profile,
                          smoothcache_for_modality)
from .trace import SignalTraceLog, TraceEntry, fit_want_gate, probe_training_set
from .tuner import ControlPlane, OnlineTuner
from .window import TelemetryWindow, TickStat

__all__ = [
    "TelemetryWindow", "TickStat",
    "OnlineTuner", "ControlPlane",
    "SignalTraceLog", "TraceEntry", "probe_training_set", "fit_want_gate",
    "SmoothCacheSchedule", "calibration_profile", "smoothcache_for_modality",
]
