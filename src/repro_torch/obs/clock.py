"""The one host-side clock for the port's serving stack.

Every wall-time measurement in `repro_torch.serving` (engine tick seconds,
telemetry latencies) comes from this module, so all spans share one
monotonic axis and tests can monkeypatch a single symbol.

`monotonic()` is the measurement clock (seconds, arbitrary epoch, never
steps backwards).  `wall()` is for human-facing timestamps only (metric
events, log lines) and is never subtracted from `monotonic()`.
"""
from __future__ import annotations

import time

__all__ = ["monotonic", "monotonic_ns", "wall"]


def monotonic() -> float:
    """Monotonic seconds (arbitrary epoch) — use for ALL duration math."""
    return time.perf_counter()


def monotonic_ns() -> int:
    """Monotonic nanoseconds — for exporters that want integer ticks."""
    return time.perf_counter_ns()


def wall() -> float:
    """Wall-clock epoch seconds — human-facing timestamps only."""
    return time.time()
