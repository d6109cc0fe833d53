"""Program capture and profiling: each program of the served and trained
paths compiled once per shape key into a CUDA graph (`compile_program`,
the counterpart of JAX's AOT compile), per-program capture time and FLOPs,
the measured redundancy ratio, and profiler trace contexts — the port of
the JAX `obs/profiling.py`.

`compile_program(fn, key=..., device=...)` runs `fn` (a function of no
arguments that reads and writes only static buffers) eagerly once on a
side stream under `count_flops`, so that its kernels are built and
cuBLAS has its handles, then captures it into a `torch.cuda.CUDAGraph` on
the owner's one memory pool.  The returned `Program` replays the graph;
on the CPU, where CUDA graphs do not exist, it calls `fn`.  Memory rule:
every value that outlives a replay lives outside the pool (the static
buffers), so a replay reads nothing another graph allocated and the
graphs of one pool replay in any order.  A replay calls no kernel
wrapper, so the capture records the launches and FLOPs each wrapper
counted inside it (`repro_torch.kernels.KERNELS`' `launches` / `flops`,
and each C entry point's count in `_build.launches`),
takes them back off the counters, and every replay adds them: the
counters count device launches either way.  Each capture is announced to
`repro_torch.obs.watch` ("capture"), which the retrace sentinel counts.

The survey's redundancy claim — caching works because consecutive steps
recompute nearly identical activations — is usually reported in *rows* or
*steps* saved.  This module turns it into FLOPs: `engine.warmup()` compiles
each bucket-size tick program, keeping its capture seconds and its
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

import dataclasses
import inspect
import math
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import watch
from .clock import monotonic

__all__ = ["ProgramProfile", "ProgramIR", "Program", "count_flops",
           "compile_program", "capture_ir",
           "program_cost", "flops_per_row", "redundancy_ratio",
           "profiler_trace"]


@dataclass(frozen=True)
class ProgramProfile:
    """One program's cost card (engine.warmup fills one per bucket size /
    dense tick kind, plus "want" for the device plan pass)."""
    key: object                 # bucket size (int) or tick kind (str)
    #: synced wall seconds of the program's CUDA-graph capture (on the
    #: CPU, of its first run, kernel builds included)
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
    plus the FLOPs the flash-attention (forward and backward) and forecast
    wrappers report for their kernel launches (a ctypes launch is no aten
    operator; on CPU tensors the wrappers run their plain versions, whose
    products the counter sees as the same numbers, so card and CPU count
    alike)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import (flash_attention, flash_attention_backward,
                                     forecast)
    kernels = (flash_attention, forecast, flash_attention_backward)
    before = [k.flops for k in kernels]
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops()
                 + sum(k.flops - b for k, b in zip(kernels, before)))


@dataclass(frozen=True)
class ProgramIR:
    """What the port keeps of one compiled program for the checks (the
    counterpart of JAX's ProgramIR, which holds a jaxpr and StableHLO):
    the operator record of one eager run (`analysis.ir.op_checks`), the
    Python def site of the captured function, the (shape, dtype-name)
    specs of the param leaves the owner declares it reads, and the bytes
    its CUDA graph's capture added to the pool (0 on the CPU)."""
    key: object
    record: object                              # op_checks.OpRecord
    fn_file: str = ""
    fn_line: int = 0
    declared_param_specs: Tuple = ()
    pool_bytes: int = 0


def _def_site(fn) -> Tuple[str, int]:
    try:
        fn = inspect.unwrap(getattr(fn, "__func__", fn))
        return inspect.getsourcefile(fn) or "", inspect.getsourcelines(fn)[1]
    except (TypeError, OSError):
        return "", 0


def capture_ir(fn: Callable[[], object], *, key=None,
               declared_param_specs=(), pool_bytes: int = 0) -> ProgramIR:
    """Run fn() once under the operator recorder and keep its record."""
    from repro_torch.analysis.ir.op_checks import record_program
    _, rec = record_program(key, fn)
    file, line = _def_site(fn)
    return ProgramIR(key=key, record=rec, fn_file=file, fn_line=line,
                     declared_param_specs=tuple(declared_param_specs),
                     pool_bytes=int(pool_bytes))


def program_cost(profile: "ProgramProfile") -> Dict[str, float]:
    """{"flops", "bytes_accessed"} of a compiled program: its FLOPs from
    `count_flops`; bytes nan (no cost model reports them)."""
    return {"flops": float(profile.flops), "bytes_accessed": math.nan}


def _counters() -> List[Tuple[object, str]]:
    from repro_torch.kernels import KERNELS, _build
    return [(k, a) for k in KERNELS for a in ("launches", "flops")
            if hasattr(k, a)] + [(_build.launches, e) for e in _build.ENTRIES]


@dataclass
class Program:
    """One compiled program: `run()` replays its CUDA graph and adds the
    launches and FLOPs its capture recorded to the wrappers' counters; on
    the CPU it calls the function."""
    key: object
    fn: Callable[[], object]
    graph: object = None                        # torch.cuda.CUDAGraph
    counts: List = field(default_factory=list)  # [(wrapper, attr, delta)]
    replays: int = 0
    #: bytes the capture added to the pool's reservation (0 on the CPU,
    #: and for a graph that reused what earlier captures reserved)
    pool_bytes: int = 0

    def run(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        self.replays += 1
        for k, attr, d in self.counts:
            setattr(k, attr, getattr(k, attr) + d)


_SIDE_STREAMS: Dict = {}


def _side_stream(device):
    """One side stream per device for every compile: each new stream
    would get cuBLAS workspaces of its own that live for the process."""
    import torch
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def compile_program(fn: Callable[[], object], *, key, device, pool=None,
                    eager: bool = True, want_record: bool = False,
                    declared_param_specs=()):
    """Compile fn (no arguments; it reads and writes static buffers) at
    `key` on `device`: one eager run under `count_flops` (skipped with
    eager=False, when the caller's own first run warmed it: the profile's
    FLOPs are then nan), one recorded run with want_record=True, then
    on the card a capture into a CUDA graph on `pool` (a
    `torch.cuda.graph_pool_handle()`).  Returns (Program, ProgramProfile),
    plus the ProgramIR with want_record=True.  compile_seconds is the
    capture's synced seconds (on the CPU the eager run's)."""
    import torch
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = _side_stream(device) if cuda else None
    flops = math.nan
    t0 = monotonic()
    if eager:
        if cuda:
            torch.cuda.synchronize(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                flops = count_flops(fn)
            torch.cuda.synchronize(device)
        else:
            flops = count_flops(fn)
    seconds = monotonic() - t0
    ir = None
    if want_record:
        ir = capture_ir(fn, key=key,
                        declared_param_specs=declared_param_specs)
    watch.emit("capture", key)
    prog = Program(key, fn)
    if cuda:
        free, _ = torch.cuda.mem_get_info(device)
        if torch.cuda.memory_reserved(device) \
                - torch.cuda.memory_allocated(device) > free:
            # more cached in the default pool than is free: the eager
            # run's blocks back to the card before the graph's own pool
            # takes the program's temporaries (a large model's step)
            torch.cuda.empty_cache()
        counters = _counters()
        before = [getattr(k, a) for k, a in counters]
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        t0 = monotonic()
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                fn()
            finally:
                graph.capture_end()
        torch.cuda.synchronize(device)
        seconds = monotonic() - t0
        prog.graph = graph
        for (k, a), b in zip(counters, before):
            d = getattr(k, a) - b
            setattr(k, a, b)
            if d:
                prog.counts.append((k, a, d))
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
        prog.pool_bytes = int(pool_bytes)
        if ir is not None:
            ir = dataclasses.replace(ir, pool_bytes=int(pool_bytes))
    profile = ProgramProfile(key=key, compile_seconds=seconds, flops=flops,
                             bytes_accessed=math.nan)
    return (prog, profile, ir) if want_record else (prog, profile)


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
