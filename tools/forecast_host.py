#!/usr/bin/env python3
"""Where the forecast wrapper's host time goes, on one CUDA card.

    python3 tools/forecast_host.py [--src DIR] [--calls N]

Imports `repro_torch` from DIR (default: this checkout's `src`; pass an
unpacked older tree's `src` to profile its wrapper in the same way) and, at
the serving shape (4 slots, m+1 = 3, N = 4096, f32), times each part of
the forecast host path with `time.perf_counter_ns` over N calls (default
1000): loading the library, entering `torch.cuda.device`, looking up the
current stream (object and raw), `torch.empty` and `Tensor.new_empty`, the
bare ctypes call of `forecast_fwd` (a launch), the whole `forecast(d, c)`
beside `torch.bmm` on the same operands, `basis_coeffs`, `forecast_basis`
where the tree has it, and the policy's skip-tick forecast
(`PredictivePolicy.apply_slots` with no slot computing).  Host
time only: the device is synchronised after each timed loop, outside the
clock.  Then one skip tick under `torch.profiler`: the operators it runs
on the host and the kernels it launches on the device.  Prints the card,
a line per part and one JSON line.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("forecast_host: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import PredictivePolicy
    from repro_torch.kernels import _build
    from repro_torch.kernels.forecast import basis_coeffs, forecast
    fc_mod = importlib.import_module("repro_torch.kernels.forecast.ops")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    S, m1, n = 4, 3, 4096
    g = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn((S, m1, n), generator=g, device=dev)
    u = torch.linspace(0.25, 1.0, S, device=dev)
    nv = torch.full((S,), 3, dtype=torch.int32, device=dev)
    c = basis_coeffs(m1 - 1, u, "taylor", n_valid=nv)
    out = torch.empty((S, n), device=dev)
    lib = _build.load()
    idx = torch.cuda.current_device()
    pol = PredictivePolicy(4, m1 - 1, "taylor")
    states = {"diffs": d.view(S, m1, 16, 256).contiguous(), "n_valid": nv,
              "last_step": torch.zeros((S,), dtype=torch.int32, device=dev)}
    steps = np.array([1, 2, 3, 5])          # no slot computes (interval 4)
    xs = torch.zeros((S, 16, 256), device=dev)

    def ctypes_call():
        return lib.forecast_fwd(d.data_ptr(), c.data_ptr(), out.data_ptr(), 0,
                                S, m1, n, 1,
                                torch._C._cuda_getCurrentRawStream(idx))

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    parts = {
        "_build.load()": _build.load,
        "with torch.cuda.device": device_ctx,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(idx),
        "torch.empty": lambda: torch.empty((S, n), device=dev),
        "d.new_empty": lambda: d.new_empty((S, n)),
        "ctypes forecast_fwd (launch, raw stream)": ctypes_call,
        "forecast(d, c)": lambda: forecast(d, c),
        "torch.bmm (library)": lambda: torch.bmm(c.view(S, 1, m1), d),
        "basis_coeffs (device u)":
            lambda: basis_coeffs(m1 - 1, u, "taylor", n_valid=nv),
        "apply_slots skip tick":
            lambda: pol.apply_slots(states, steps, xs, xs),
    }
    if hasattr(fc_mod, "forecast_basis"):
        parts["forecast_basis"] = lambda: fc_mod.forecast_basis(
            states["diffs"], steps, states["last_step"], nv, 4, "taylor")
    us = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(args.calls):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        us[name] = (t1 - t0) / args.calls / 1e3
        print(f"forecast_host: {name:40s} {us[name]:8.3f} us per call",
              flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pol.apply_slots(states, steps, xs, xs)
        torch.cuda.synchronize()
    evts = prof.key_averages()
    dev_k = [e for e in evts if str(e.device_type).endswith("CUDA")
             and getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) > 0]
    ops = [e for e in evts if e.key.startswith("aten::")]
    tick = {"device_kernels": sum(e.count for e in dev_k),
            "kernels": {e.key[:60]: e.count for e in dev_k},
            "aten_ops": sum(e.count for e in ops),
            "memcpy_h2d": sum(e.count for e in evts if "HtoD" in e.key)}
    print(f"forecast_host: skip tick: {tick}", flush=True)
    print(card, flush=True)
    print(json.dumps({"src": args.src, "card": card, "us_per_call": us,
                      "skip_tick": tick}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
