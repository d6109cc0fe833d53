"""repro_torch.obs — tracing, metrics and program profiling of the port (the
JAX `repro.obs`).

  clock      — the one monotonic clock helper (`monotonic()`); every wall
               time the serving stack measures goes through it
  trace      — TraceRecorder: TickEvents -> Chrome/Perfetto trace (per
               sub-pool tracks, plan/backbone phases, per-slot cache
               lifecycle spans annotated with signal vs threshold) + a
               cache-event JSONL that rebuilds a SignalTraceLog from disk
  metrics    — MetricsRegistry: labelled counters / gauges / histograms,
               Prometheus text exposition + JSON snapshots, an event ring
  profiling  — `compile_program` (a CUDA graph per program and shape
               key; the `Program` that replays it), each program's
               capture seconds and FLOPs, the measured redundancy ratio
               (FLOPs avoided / dense FLOPs), opt-in torch.profiler traces
  watch      — the events the program verifier and the retrace sentinel
               (repro_torch.analysis.ir) listen to, and `host_read`, the
               priced device-to-host read

Metric names follow JAX's `repro_<subsystem>_<metric>_<unit>`.
Instrumentation is opt-in: no registry is consulted unless one is passed,
so hooks-off serving pays nothing.
"""
from .clock import monotonic, monotonic_ns, wall
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .profiling import (Program, ProgramIR, ProgramProfile, capture_ir,
                        compile_program, count_flops, flops_per_row,
                        profiler_trace, program_cost, redundancy_ratio)
from .trace import (TraceRecorder, load_cache_events, load_probes,
                    policy_signature, signal_trace_from_files,
                    validate_chrome_trace)

__all__ = [
    "monotonic", "monotonic_ns", "wall",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "Program", "ProgramIR", "ProgramProfile", "capture_ir",
    "compile_program", "count_flops", "flops_per_row", "profiler_trace",
    "program_cost", "redundancy_ratio",
    "TraceRecorder", "load_cache_events", "load_probes", "policy_signature",
    "signal_trace_from_files", "validate_chrome_trace",
]
