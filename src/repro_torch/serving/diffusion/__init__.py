"""repro_torch.serving.diffusion — cache-aware continuous-batching diffusion
serving of the port:

  engine     — DiffusionServingEngine: row-compacted ticks (or the dense
               full/cond/skip engine), classifier-free guidance with
               per-slot FasterCacheCFG reuse and negative-prompt vectors,
               mid-flight refill with reset-on-refill, the tick-granular
               ServeSession with TickEvent hooks and metrics
  scheduler  — SlotScheduler: admission queue, slot lifecycle, per-request
               step budgets, phase-aligned admission
  autotune   — SLA-driven sweep of the policy registry (optionally x CFG
               reuse intervals), priced in backbone rows
  telemetry  — per-request and fleet metrics, backbone row accounting
"""
from .autotune import (DEFAULT_CANDIDATES, SLA, TunedPolicy, autotune,
                       autotune_traffic_classes, calibration_reference,
                       evaluate_candidate, price_and_pick, sweep_candidates)
from .engine import (DiffusionResult, DiffusionServingEngine, ServeSession,
                     TickEvent, TickHook, compact_rows)
from .scheduler import DiffusionRequest, Slot, SlotScheduler
from .telemetry import RequestRecord, ServingTelemetry

__all__ = [
    "DEFAULT_CANDIDATES", "SLA", "TunedPolicy", "autotune",
    "autotune_traffic_classes", "calibration_reference",
    "evaluate_candidate", "price_and_pick", "sweep_candidates",
    "DiffusionResult", "DiffusionServingEngine", "ServeSession", "TickEvent",
    "TickHook", "compact_rows",
    "DiffusionRequest", "Slot", "SlotScheduler",
    "RequestRecord", "ServingTelemetry",
]
