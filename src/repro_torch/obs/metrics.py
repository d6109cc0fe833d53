"""Counter / gauge / histogram registry with label support — the port's
own copy of the JAX `obs/metrics.py` (pure Python).

The serving stack publishes into a registry only when one is passed
(`ServeSession(..., metrics=registry)`: engine ticks, scheduler admission;
`price_and_pick(..., registry=...)`: autotune events;
`ServingTelemetry.publish()`: summary gauges), so serving without one pays
nothing.  Exporters: `prometheus_text()` (the text exposition format) and
`snapshot()` (a JSON-able dict); discrete occurrences go through `event()`
into a bounded ring included in the snapshot.  Metric names follow
`repro_<subsystem>_<metric>_<unit>`, counters end in `_total`, and labels
carry dimensions.
"""
from __future__ import annotations

import json
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from .clock import wall

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]

#: label sets are stored as sorted (key, value) tuples — hashable, ordered
LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


@dataclass
class Counter:
    """Monotonically increasing value per label set."""
    name: str
    help: str = ""
    values: Dict[LabelKey, float] = field(default_factory=dict)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self.values.get(_label_key(labels), 0.0)


@dataclass
class Gauge:
    """Point-in-time value per label set (set/add, may go down)."""
    name: str
    help: str = ""
    values: Dict[LabelKey, float] = field(default_factory=dict)

    def set(self, value: float, **labels: str) -> None:
        self.values[_label_key(labels)] = float(value)

    def add(self, amount: float, **labels: str) -> None:
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self.values.get(_label_key(labels), 0.0)


#: default histogram buckets: tick/plan latencies in seconds, 100us..10s
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                   3.0, 10.0)


@dataclass
class Histogram:
    """Cumulative-bucket histogram per label set (Prometheus semantics:
    bucket counts are cumulative, +Inf bucket == total count)."""
    name: str
    help: str = ""
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS
    # per label set: (bucket counts incl +Inf, sum, count)
    values: Dict[LabelKey, List] = field(default_factory=dict)

    def observe(self, value: float, **labels: str) -> None:
        k = _label_key(labels)
        slot = self.values.get(k)
        if slot is None:
            slot = self.values[k] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        counts, _, _ = slot
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
        counts[-1] += 1
        slot[1] += float(value)
        slot[2] += 1

    def count(self, **labels: str) -> int:
        slot = self.values.get(_label_key(labels))
        return slot[2] if slot else 0

    def sum(self, **labels: str) -> float:
        slot = self.values.get(_label_key(labels))
        return slot[1] if slot else 0.0

    def mean(self, **labels: str) -> float:
        slot = self.values.get(_label_key(labels))
        return slot[1] / slot[2] if slot and slot[2] else math.nan


class MetricsRegistry:
    """Get-or-create instrument registry + exporters + event ring."""

    def __init__(self, max_events: int = 256):
        self._instruments: Dict[str, object] = {}
        self.events: Deque[Dict] = deque(maxlen=max_events)
        self.events_seen = 0

    # -- instruments ---------------------------------------------------
    def _get(self, cls, name: str, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, help, **kw)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric '{name}' already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        kw = {"buckets": tuple(buckets)} if buckets is not None else {}
        return self._get(Histogram, name, help, **kw)

    # -- events --------------------------------------------------------
    def event(self, name: str, **fields) -> None:
        """Record one discrete occurrence (a policy swap, a retune) in the
        bounded event ring — snapshot-visible, not Prometheus-exported."""
        self.events.append({"time": wall(), "event": name, **fields})
        self.events_seen += 1

    # -- exporters -----------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {name} counter")
                for k in sorted(inst.values):
                    lines.append(f"{name}{_fmt_labels(k)} {inst.values[k]:g}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {name} gauge")
                for k in sorted(inst.values):
                    lines.append(f"{name}{_fmt_labels(k)} {inst.values[k]:g}")
            elif isinstance(inst, Histogram):
                lines.append(f"# TYPE {name} histogram")
                for k in sorted(inst.values):
                    counts, total, n = inst.values[k]
                    for ub, c in zip(inst.buckets, counts):
                        lk = _fmt_labels(k + (("le", f"{ub:g}"),))
                        lines.append(f"{name}_bucket{lk} {c}")
                    lk = _fmt_labels(k + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lk} {counts[-1]}")
                    lines.append(f"{name}_sum{_fmt_labels(k)} {total:g}")
                    lines.append(f"{name}_count{_fmt_labels(k)} {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict:
        """JSON-able dump of every instrument + the event ring."""
        out: Dict = {"metrics": {}, "events": list(self.events),
                     "events_seen": self.events_seen}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, (Counter, Gauge)):
                out["metrics"][name] = {
                    "type": type(inst).__name__.lower(), "help": inst.help,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in sorted(inst.values.items())]}
            else:
                out["metrics"][name] = {
                    "type": "histogram", "help": inst.help,
                    "buckets": list(inst.buckets),
                    "values": [{"labels": dict(k), "bucket_counts": v[0],
                                "sum": v[1], "count": v[2]}
                               for k, v in sorted(inst.values.items())]}
        return out

    def write_snapshot(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, default=float)

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry (lazily created).  Instrumentation points
    never publish here implicitly — callers opt in by passing it around —
    so hooks-off serving stays zero-overhead."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT
