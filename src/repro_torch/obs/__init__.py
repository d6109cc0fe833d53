"""repro_torch.obs — the serving stack's clock and its metrics registry
(counters, gauges, histograms; Prometheus text and JSON snapshots)."""
from .clock import monotonic, wall
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)

__all__ = ["monotonic", "wall", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "default_registry"]
