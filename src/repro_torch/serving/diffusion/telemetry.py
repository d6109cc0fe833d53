"""Serving telemetry: per-request and fleet-level metrics.

The survey's acceleration claims are single-trajectory (compute_fraction,
PSNR); a serving system additionally cares about queue wait, end-to-end
latency, request throughput, and how often the batch-level scheduler managed
to dispatch a cheap program instead of the full backbone.  This module
collects both views:

  * RequestRecord — one request's lifecycle timestamps + cache counters,
    including CFG accounting (how many unconditional-branch computes the
    per-slot FasterCacheCFG state saved) and an explicit `preempted` flag
    for requests cut off by `serve(max_ticks=...)`.
  * ServingTelemetry — fleet aggregation: throughput, latency percentiles,
    the full / cond-only / skip tick mix, backbone rows computed / padded /
    saved by row compaction, uncond rows dispatched vs saved, cache hit +
    forecast rates, cache_state_bytes/slot.

Tick kinds (kept for compatibility with the PR-3 dense engine; under row
compaction they classify WHICH branches the tick's gathered rows came from,
no longer the batch size):
  "full" — some gathered row is an uncond-branch refresh
  "cond" — cond-branch rows only (also the only backbone tick kind for
           unguided pools)
  "skip" — no backbone at all (forecast/reuse arithmetic only)
The true per-tick cost now lives in the row counters:
`backbone_rows_computed` (rows carrying real per-slot work), `_padding`
(power-of-two bucket waste), `_saved` (rows a dense whole-pool tick would
have dispatched on top).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.obs.clock import monotonic

TICK_KINDS = ("full", "cond", "skip")


def _pct(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default method).

    Nearest-rank via int(q * (len-1)) truncates DOWN, so p95 over a small
    fleet (10 requests -> index int(8.55) = 8) silently reported the ~p89
    sample; interpolating between the bracketing order statistics matches
    np.percentile exactly (tests/test_serving_compaction.py asserts so).
    An empty window has no percentile: nan, never a fake 0.0 an SLA check
    could mistake for "infinitely fast"."""
    if not xs:
        return math.nan
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclass
class RequestRecord:
    """Lifecycle + cache telemetry for one request."""
    request_id: int
    num_steps: int
    traffic_class: str = "default"
    cfg_scale: float = 0.0
    modality: str = "image"
    enqueue_time: float = 0.0
    admit_time: float = 0.0
    finish_time: float = 0.0
    admit_tick: int = -1
    finish_tick: int = -1
    slot: int = -1
    computed_steps: int = 0          # ticks where this slot ran a full compute
    uncond_computed_steps: int = 0   # ticks where the uncond branch refreshed
    #: True when serve(max_ticks=...) ended before this request completed
    #: (either mid-flight or still queued); its latency fields are partial
    #: and it is excluded from latency/throughput aggregation.
    preempted: bool = False

    @property
    def guided(self) -> bool:
        return self.cfg_scale > 0.0

    @property
    def latency(self) -> float:
        """End-to-end seconds from enqueue to completion."""
        return self.finish_time - self.enqueue_time

    @property
    def queue_wait(self) -> float:
        return self.admit_time - self.enqueue_time

    @property
    def compute_fraction(self) -> float:
        """Fraction of denoise steps that ran the backbone for this request;
        the survey's acceleration factor is ~ 1/compute_fraction (§III-B)."""
        return self.computed_steps / max(self.num_steps, 1)

    @property
    def cache_hit_rate(self) -> float:
        """Steps served from cache (verbatim reuse or forecast)."""
        return 1.0 - self.compute_fraction

    @property
    def uncond_saved_steps(self) -> int:
        """Unconditional-branch computes avoided by CFG-branch reuse
        (FasterCacheCFG); 0 for unguided requests."""
        if not self.guided:
            return 0
        return max(self.num_steps - self.uncond_computed_steps, 0)


@dataclass
class ServingTelemetry:
    """Aggregates RequestRecords plus per-tick engine counters.

    `max_records` bounds the retained RequestRecord lists (a ring buffer:
    oldest records are dropped once the cap is reached) so long-lived serve
    sessions don't grow without limit.  Aggregate counters (request counts,
    latency/compute-fraction/queue-wait sums, uncond savings) are kept
    monotonically regardless of the cap, so `summary()` means and totals
    stay exact over ALL traffic; only the percentile and per-traffic-class
    views narrow to the retained window — which is precisely what the
    control plane's sliding-window retuner wants.  The default (None) keeps
    every record, matching pre-cap behavior exactly."""
    cache_state_bytes_per_slot: int = 0
    max_records: Optional[int] = None
    records: List[RequestRecord] = field(default_factory=list)
    preempted_records: List[RequestRecord] = field(default_factory=list)
    # monotonic aggregates: survive ring-buffer eviction
    requests_finished: int = 0
    requests_preempted: int = 0
    latency_sum_s: float = 0.0
    queue_wait_sum_s: float = 0.0
    compute_fraction_sum: float = 0.0
    guided_finished: int = 0
    uncond_saved_steps_sum: int = 0
    ticks_full: int = 0          # both-branch backbone (2S rows)
    ticks_cond: int = 0          # cond-only backbone (S rows)
    ticks_skip: int = 0
    tick_seconds_full: float = 0.0
    tick_seconds_cond: float = 0.0
    tick_seconds_skip: float = 0.0
    #: uncond backbone rows that refreshed an active guided slot's CFG cache
    #: (rows a dense engine additionally dispatches but whose output the
    #: per-slot select discards are NOT counted here — they show up in
    #: backbone_rows_computed instead)
    uncond_rows_computed: int = 0
    #: uncond rows a naive two-branch server would have dispatched but this
    #: engine did not (active guided slots whose CFG cache was reused)
    uncond_rows_saved: int = 0
    #: backbone rows carrying real per-slot work (cond + uncond), summed over
    #: ticks.  For the dense whole-pool engine this is the full batch (S or
    #: 2S per backbone tick — slot-count inflation included, because those
    #: rows really run); for the row-compacted engine it is exactly the rows
    #: whose policies wanted a compute.
    backbone_rows_computed: int = 0
    #: pad rows added to reach the power-of-two bucket size (compacted engine
    #: only; these also run through the backbone, so actual dispatched batch
    #: rows = backbone_rows_computed + backbone_rows_padding)
    backbone_rows_padding: int = 0
    #: rows a dense whole-pool tick of the same kind would have dispatched
    #: minus the rows this engine actually needed
    backbone_rows_saved: int = 0
    _t0: Optional[float] = None
    _t1: Optional[float] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._t0 = monotonic()

    def stop(self) -> None:
        self._t1 = monotonic()

    def record_tick(self, kind: str, seconds: float, *,
                    rows_computed: int = 0, rows_padding: int = 0,
                    rows_saved: int = 0) -> None:
        assert kind in TICK_KINDS, kind
        if kind == "full":
            self.ticks_full += 1
            self.tick_seconds_full += seconds
        elif kind == "cond":
            self.ticks_cond += 1
            self.tick_seconds_cond += seconds
        else:
            self.ticks_skip += 1
            self.tick_seconds_skip += seconds
        self.backbone_rows_computed += int(rows_computed)
        self.backbone_rows_padding += int(rows_padding)
        self.backbone_rows_saved += int(rows_saved)

    def _trim(self, lst: List[RequestRecord]) -> None:
        if self.max_records is not None and len(lst) > self.max_records:
            del lst[:len(lst) - self.max_records]

    def finish_request(self, rec: RequestRecord) -> None:
        self.requests_finished += 1
        self.latency_sum_s += rec.latency
        self.queue_wait_sum_s += rec.queue_wait
        self.compute_fraction_sum += rec.compute_fraction
        if rec.guided:
            self.guided_finished += 1
            self.uncond_saved_steps_sum += rec.uncond_saved_steps
        self.records.append(rec)
        self._trim(self.records)

    def preempt_request(self, rec: RequestRecord) -> None:
        """Record a request cut off by max_ticks instead of dropping it."""
        rec.preempted = True
        self.requests_preempted += 1
        self.preempted_records.append(rec)
        self._trim(self.preempted_records)

    # ------------------------------------------------------------------
    @property
    def elapsed(self) -> float:
        t1 = self._t1 if self._t1 is not None else monotonic()
        return (t1 - self._t0) if self._t0 is not None else 0.0

    @property
    def ticks_backbone(self) -> int:
        return self.ticks_full + self.ticks_cond

    def step_time_ms(self):
        """(backbone_tick_ms, skip_tick_ms) — the pair autotune's latency
        constraint consumes.  Backbone time averages over full AND cond-only
        ticks (unguided pools only ever record the latter)."""
        nb = self.ticks_backbone
        t_back = (1e3 * (self.tick_seconds_full + self.tick_seconds_cond) / nb
                  if nb else 0.0)
        t_skip = (1e3 * self.tick_seconds_skip / self.ticks_skip
                  if self.ticks_skip else 0.0)
        return t_back, t_skip

    def row_time_ms(self):
        """(ms_per_backbone_row, skip_tick_ms) — autotune's row-priced
        latency model.  Backbone tick time divided by the rows those ticks
        actually dispatched (real + padding), so the estimate prices a
        candidate by the rows it gathers instead of by tick kind."""
        rows = self.backbone_rows_computed + self.backbone_rows_padding
        t_row = (1e3 * (self.tick_seconds_full + self.tick_seconds_cond) /
                 rows if rows else 0.0)
        t_skip = (1e3 * self.tick_seconds_skip / self.ticks_skip
                  if self.ticks_skip else 0.0)
        return t_row, t_skip

    def summary(self) -> Dict[str, float]:
        """Fleet summary.  Counts, means and totals come from the monotonic
        aggregate counters (exact over all traffic, ring buffer or not);
        latency percentiles come from the retained record window."""
        lat = [r.latency for r in self.records]
        ticks = self.ticks_full + self.ticks_cond + self.ticks_skip
        n = self.requests_finished
        cf_mean = self.compute_fraction_sum / n if n else 1.0
        return {
            "requests": n,
            "requests_preempted": self.requests_preempted,
            "elapsed_s": self.elapsed,
            "throughput_rps": n / self.elapsed if self.elapsed > 0 else 0.0,
            "latency_p50_s": _pct(lat, 0.50),
            "latency_p95_s": _pct(lat, 0.95),
            "queue_wait_mean_s": self.queue_wait_sum_s / n if n else 0.0,
            "compute_fraction_mean": cf_mean,
            "cache_hit_rate_mean": 1.0 - cf_mean,
            "ticks": ticks,
            # fraction of ticks that ran the backbone at all (full or cond)
            "full_tick_fraction": self.ticks_backbone / ticks if ticks else 0.0,
            # fraction that needed the 2S-row both-branch program
            "cfg_full_tick_fraction": self.ticks_full / ticks if ticks else 0.0,
            "tick_ms_backbone_mean": self.step_time_ms()[0],
            "tick_ms_full_mean": (1e3 * self.tick_seconds_full /
                                  self.ticks_full if self.ticks_full else 0.0),
            "tick_ms_cond_mean": (1e3 * self.tick_seconds_cond /
                                  self.ticks_cond if self.ticks_cond else 0.0),
            "tick_ms_skip_mean": (1e3 * self.tick_seconds_skip /
                                  self.ticks_skip if self.ticks_skip else 0.0),
            "guided_requests": self.guided_finished,
            "backbone_rows_computed": self.backbone_rows_computed,
            "backbone_rows_padding": self.backbone_rows_padding,
            "backbone_rows_saved": self.backbone_rows_saved,
            "backbone_rows_per_tick_mean":
                (self.backbone_rows_computed / self.ticks_backbone
                 if self.ticks_backbone else 0.0),
            "uncond_rows_computed": self.uncond_rows_computed,
            "uncond_rows_saved": self.uncond_rows_saved,
            "uncond_saved_steps_total": self.uncond_saved_steps_sum,
            "cache_state_bytes_per_slot": self.cache_state_bytes_per_slot,
        }

    def publish(self, registry, modality: Optional[str] = None) -> None:
        """Export this telemetry's aggregates as `repro_serving_*` gauges
        into a repro.obs MetricsRegistry — the telemetry becomes a VIEW
        over the unified metrics surface instead of a fourth export format.
        Gauges, not counters: `summary()` values are level readings of this
        object (re-publishing overwrites, never double-counts)."""
        labels = {"modality": modality} if modality is not None else {}
        for key, value in self.summary().items():
            registry.gauge(
                f"repro_serving_{key}",
                f"ServingTelemetry.summary()['{key}'] (published view)."
            ).set(float(value), **labels)

    def by_traffic_class(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for tc in sorted({r.traffic_class for r in self.records}):
            recs = [r for r in self.records if r.traffic_class == tc]
            lat = [r.latency for r in recs]
            out[tc] = {
                "requests": len(recs),
                "latency_p50_s": _pct(lat, 0.50),
                "latency_p95_s": _pct(lat, 0.95),
                "compute_fraction_mean":
                    sum(r.compute_fraction for r in recs) / len(recs),
            }
        return out
