"""repro_torch.serving.diffusion — the diffusion serving engine of the port."""
from .engine import (DiffusionResult, DiffusionServingEngine, ServeSession,
                     compact_rows)
from .scheduler import DiffusionRequest, Slot, SlotScheduler
from .telemetry import RequestRecord, ServingTelemetry

__all__ = [
    "DiffusionRequest", "DiffusionResult", "DiffusionServingEngine",
    "RequestRecord", "ServeSession", "ServingTelemetry", "Slot",
    "SlotScheduler", "compact_rows",
]
