"""Program profiling: per-program first-run time and FLOPs, the measured
redundancy ratio, and profiler trace contexts — the device-independent part
of the JAX `obs/profiling.py`.

The survey's redundancy claim — caching works because consecutive steps
recompute nearly identical activations — is usually reported in *rows* or
*steps* saved.  This module turns it into FLOPs: `engine.warmup()` runs
each bucket-size tick program once, keeping its first-run seconds and its
FLOPs (`count_flops`: `torch.utils.flop_counter.FlopCounterMode` plus what
the hand-written kernels report), and `redundancy_ratio` combines those
with telemetry row counters into the measured ratio
(FLOPs avoided) / (dense FLOPs) — what the cache ACTUALLY saved of the
compute a dense pool would have run.

FLOPs here count products only (matmuls, the attention's two products);
XLA's cost model, which the JAX package reads, also counts elementwise
work.  No cost model reports bytes, so `bytes_accessed` is nan.

`profiler_trace` is the opt-in `torch.profiler` context: a strict no-op
unless a directory is given.
"""
from __future__ import annotations

import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from .clock import monotonic

__all__ = ["ProgramProfile", "count_flops", "profile_program",
           "flops_per_row", "redundancy_ratio", "profiler_trace"]


@dataclass(frozen=True)
class ProgramProfile:
    """One program's cost card (engine.warmup fills one per bucket size /
    dense tick kind, plus "want" for the device plan pass)."""
    key: object                 # bucket size (int) or tick kind (str)
    #: synced wall seconds of the program's first run, kernel builds
    #: included (the port compiles nothing ahead of time)
    compile_seconds: float
    flops: float                # products counted by count_flops
    bytes_accessed: float       # nan: no cost model reports bytes
    #: the program's findings from warmup(verify=True)
    #: (repro_torch.analysis.ir); () = clean or not verified
    ir_findings: Tuple = ()

    def as_dict(self) -> Dict:
        d = {"key": self.key, "compile_seconds": self.compile_seconds,
             "flops": self.flops, "bytes_accessed": self.bytes_accessed}
        if self.ir_findings:
            d["ir_findings"] = [str(f) for f in self.ir_findings]
        return d


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of one call of fn(): the aten operators FlopCounterMode counts,
    plus the FLOPs the flash-attention and forecast wrappers report for
    their kernel launches (a ctypes launch is no aten operator; on CPU
    tensors the wrappers run their plain versions, whose products the
    counter sees as the same numbers, so card and CPU count alike)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention, forecast
    kernels = (flash_attention, forecast)
    before = [k.flops for k in kernels]
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops()
                 + sum(k.flops - b for k, b in zip(kernels, before)))


def profile_program(key, fn: Callable[[], object],
                    sync: Callable[[], None]):
    """Run fn() once timed (synced by `sync`: the first run, kernel builds
    included), then once more under `count_flops`.  Returns (the first
    run's result, ProgramProfile)."""
    t0 = monotonic()
    out = fn()
    sync()
    seconds = monotonic() - t0
    return out, ProgramProfile(key=key, compile_seconds=seconds,
                               flops=count_flops(fn),
                               bytes_accessed=math.nan)


def flops_per_row(profiles: Dict) -> float:
    """Marginal backbone FLOPs per gathered row, from the per-bucket
    program profiles: (flops[largest bucket] - flops[skip]) / bucket.
    Subtracting the bucket-0 (skip) program removes the per-slot policy /
    DDIM work every tick pays regardless of rows; nan when the profiles
    are missing or costless."""
    buckets = sorted(k for k in profiles if isinstance(k, int) and k > 0)
    if not buckets:
        return math.nan
    largest = buckets[-1]
    base = profiles.get(0)
    f_base = base.flops if base is not None and not math.isnan(
        base.flops) else 0.0
    f_top = profiles[largest].flops
    if math.isnan(f_top):
        return math.nan
    return max(f_top - f_base, 0.0) / largest


def redundancy_ratio(profiles: Dict, rows_computed: int, rows_padding: int,
                     rows_saved: int) -> Dict[str, float]:
    """The survey's redundancy ratio, measured: FLOPs avoided over the
    FLOPs a dense (no-cache, whole-pool) serving run would have dispatched
    for the same traffic.

    rows_* come straight from ServingTelemetry (backbone_rows_computed /
    _padding / _saved).  Padding rows DO run through the backbone, so they
    count against the saving — the ratio prices the pow-2 bucket waste
    honestly."""
    fpr = flops_per_row(profiles)
    dispatched = rows_computed + rows_padding
    dense = dispatched + rows_saved
    avoided = rows_saved - rows_padding  # padding burns part of the saving
    if math.isnan(fpr) or dense <= 0:
        return {"flops_per_row": fpr, "dense_flops": math.nan,
                "flops_avoided": math.nan, "redundancy_ratio": math.nan}
    return {"flops_per_row": fpr,
            "dense_flops": fpr * (rows_computed + rows_saved),
            "flops_avoided": fpr * avoided,
            "redundancy_ratio": avoided / (rows_computed + rows_saved)}


@contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """Opt-in `torch.profiler` context: profiles the enclosed block (CPU
    activity, plus CUDA when a card is present) and writes a Chrome trace
    into `log_dir` when a directory is given; a strict no-op otherwise —
    callers can wrap timed sections in it unconditionally."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(monotonic() * 1e6)}.json"))
