"""TelemetryWindow — sliding-window serving statistics for the control plane;
the port of the JAX `serving/control/window.py`.

The offline autotuner prices candidates with whatever `row_time_ms` /
`occupancy` the caller measured once; a live server's costs drift (traffic
mix, co-tenant load, pool occupancy).  TelemetryWindow is the control
plane's eye on the running engine: a TickHook (`observe`) fed one TickEvent
per engine tick, keeping bounded deques of recent ticks and finished
requests, from which it derives exactly the inputs the row-priced cost
model consumes —

    row_time_ms()  — (ms_per_backbone_row, skip_tick_ms) over the window,
                     the same shape ServingTelemetry.row_time_ms() reports
                     for a whole run
    occupancy()    — mean busy slots on backbone ticks (rounded >= 1), the
                     row-term multiplier under load

plus quality-side signals (compute fraction, mean want_metric, externally
attached PSNR proxies) the tuner can floor on.  Everything is host-side and
O(window) — safe to call between ticks.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional

import numpy as np

from repro_torch.serving.diffusion.engine import TickEvent
from repro_torch.serving.diffusion.telemetry import RequestRecord


@dataclass(frozen=True)
class TickStat:
    """One tick's window-relevant numbers (a compressed TickEvent)."""
    tick: int
    modality: str
    kind: str                 # "full" | "cond" | "skip"
    seconds: float
    plan_seconds: float       # host time spent deciding the tick
    planned_on_device: bool   # True when the want pass synced the device
    rows_computed: int
    rows_padding: int
    occupancy: int            # busy slots this tick
    mean_metric: float        # mean want_metric over active slots (0 if n/a)


class TelemetryWindow:
    """Sliding window over TickEvents; feeds the online tuner's cost model."""

    def __init__(self, max_ticks: int = 256, max_requests: int = 64):
        self.ticks: Deque[TickStat] = deque(maxlen=max_ticks)
        self.finished: Deque[RequestRecord] = deque(maxlen=max_requests)
        #: monotonic totals (survive window eviction)
        self.ticks_seen = 0
        self.requests_seen = 0
        #: externally attached quality proxies: request_id -> PSNR dB
        #: (the window cannot measure quality itself — it never sees a
        #: reference trajectory; benchmarks/calibrators attach it)
        self.psnr_proxies: Dict[int, float] = {}
        self._psnr_window: Deque[float] = deque(maxlen=max_requests)

    # ------------------------------------------------------------------
    def observe(self, event: TickEvent) -> None:
        """TickHook entry point: fold one engine tick into the window."""
        active = np.asarray(event.active, bool)
        occ = int(active.sum())
        if event.metric is not None and occ:
            mean_metric = float(np.asarray(event.metric)[active].mean())
        else:
            mean_metric = 0.0
        self.ticks.append(TickStat(
            tick=event.tick, modality=event.modality, kind=event.kind,
            seconds=float(event.seconds),
            plan_seconds=float(event.plan_seconds),
            planned_on_device=event.metric is not None,
            rows_computed=int(event.rows_computed),
            rows_padding=int(event.rows_padding),
            occupancy=occ, mean_metric=mean_metric))
        self.ticks_seen += 1
        for rec in event.finished:
            self.finished.append(rec)
            self.requests_seen += 1

    def note_psnr(self, request_id: int, psnr_db: float) -> None:
        """Attach an externally measured quality proxy for one request."""
        self.psnr_proxies[request_id] = float(psnr_db)
        self._psnr_window.append(float(psnr_db))

    # ------------------------------------------------------------------
    def _backbone(self):
        return [t for t in self.ticks if t.kind != "skip"]

    def row_time_ms(self) -> Optional[tuple]:
        """(ms_per_backbone_row, skip_tick_ms) over the window — the
        autotune-shaped pricing pair — or None while the window has no
        backbone ticks yet (nothing sound to price with)."""
        back = self._backbone()
        rows = sum(t.rows_computed + t.rows_padding for t in back)
        if rows == 0:
            return None
        t_row = 1e3 * sum(t.seconds for t in back) / rows
        skips = [t for t in self.ticks if t.kind == "skip"]
        t_skip = (1e3 * sum(t.seconds for t in skips) / len(skips)
                  if skips else 0.0)
        return t_row, t_skip

    def occupancy(self) -> int:
        """Mean busy slots on backbone ticks, rounded, floored at 1 — the
        multiplier on the row term of the latency estimate."""
        back = self._backbone()
        if not back:
            return 1
        return max(int(round(sum(t.occupancy for t in back) / len(back))), 1)

    def plan_time_ms(self) -> float:
        """Mean host ms per tick spent on the fused want pass, over ticks
        the engine had to plan ON DEVICE (metric present).  Static-schedule
        policies plan on the host for ~free, so those ticks are excluded —
        and 0.0 is returned while the window holds no device-planned ticks.
        That makes the tuner OPTIMISTIC about unmeasured dynamic candidates
        (it may swap onto one), after which the next window measures the
        real sync cost and the loop re-prices — self-correcting rather than
        pre-emptively pessimistic."""
        planned = [t for t in self.ticks if t.planned_on_device]
        if not planned:
            return 0.0
        return 1e3 * sum(t.plan_seconds for t in planned) / len(planned)

    def compute_fraction(self) -> float:
        """Mean per-request compute fraction over the finished window."""
        if not self.finished:
            return 1.0
        return sum(r.compute_fraction for r in self.finished) / \
            len(self.finished)

    def mean_metric(self) -> float:
        """Mean want_metric over the window's active slots (TeaCache-style
        accumulated distances; 0.0 under schedule-only policies)."""
        vals = [t.mean_metric for t in self.ticks if t.occupancy]
        return sum(vals) / len(vals) if vals else 0.0

    def psnr_mean(self) -> Optional[float]:
        """Mean attached PSNR proxy over the request window, if any."""
        if not self._psnr_window:
            return None
        return sum(self._psnr_window) / len(self._psnr_window)

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        rt = self.row_time_ms()
        back = self._backbone()
        return {
            "window_ticks": len(self.ticks),
            "ticks_seen": self.ticks_seen,
            "requests_seen": self.requests_seen,
            "backbone_ticks": len(back),
            "row_time_ms": rt[0] if rt else 0.0,
            "skip_tick_ms": rt[1] if rt else 0.0,
            "occupancy": self.occupancy(),
            "plan_time_ms": self.plan_time_ms(),
            "compute_fraction": self.compute_fraction(),
            "mean_metric": self.mean_metric(),
            "psnr_proxy_mean": self.psnr_mean() or 0.0,
        }

    def publish(self, registry, modality: Optional[str] = None) -> None:
        """Export the window's summary as `repro_window_*` gauges into a
        repro_torch.obs MetricsRegistry — the sliding-window view joins the
        same scrape surface as the engine counters (gauges because the window
        slides: each publish is a level reading, not an increment)."""
        labels = {"modality": modality} if modality is not None else {}
        for key, value in self.summary().items():
            registry.gauge(
                f"repro_window_{key}",
                f"TelemetryWindow.summary()['{key}'] (published view)."
            ).set(float(value), **labels)
