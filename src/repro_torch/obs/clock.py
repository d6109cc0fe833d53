"""The one host-side clock for the port's serving stack.

Every wall-time measurement in `repro_torch.serving` (engine tick seconds,
telemetry latencies) comes from this module, so all spans share one
monotonic axis and tests can monkeypatch a single symbol.

`monotonic()` is the measurement clock (seconds, arbitrary epoch, never
steps backwards).
"""
from __future__ import annotations

import time

__all__ = ["monotonic"]


def monotonic() -> float:
    """Monotonic seconds (arbitrary epoch) — use for ALL duration math."""
    return time.perf_counter()
