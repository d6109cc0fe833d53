#!/usr/bin/env python3
"""The serve phase's traffic under two or more source trees, in turns, on
one CUDA card.

    python3 tools/serve_ab.py --src OLD/src --src src [--order 0,1,1,0]
        [--policy taylorseer|teacache-cfg]

For each entry of `--order` (indices into the `--src` list; default: the
first tree, then the others, then back, e.g. 0,1,1,0) a fresh process
imports `repro_torch` from that tree and serves chip_smoke.py's serve
traffic through full-width DiT-XL (28 layers, bf16 params, random weights
from seed 0, AdaLN gates perturbed): TaylorSeer interval 4 order 2 (or,
with `--policy teacache-cfg`, TeaCache delta 0.5 planned by the device
want pass with FasterCacheCFG(2) on the uncond branch), 4 slots, 8
requests of 8 and 16 steps, two guided at cfg_scale 4.0.  After warmup and
one untimed serve, `--reps` serves (default 5) are timed; the process
prints the medians of req/s, backbone tick ms and skip tick ms, then the
host syncs a tick of one more serve under torch's sync debug mode (every
synchronizing CUDA call torch makes warns: the blocking copies both ways
and the synchronizes), and a JSON line.  The kernels build once per tree.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def sync_count(torch, fn) -> int:
    """fn() under torch's sync debug mode: the synchronizing CUDA calls it
    made."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def child(src: str, reps: int, policy: str) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_ab: no CUDA device")
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_config("dit-xl")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)
    if policy == "teacache-cfg":
        from repro_torch.core import FasterCacheCFG, make_policy
        eng = DiffusionServingEngine(
            params, cfg, make_policy("teacache", delta=0.5), slots=4,
            max_steps=16, cfg_policy=FasterCacheCFG(2, 16), device="cuda")
    else:
        eng = DiffusionServingEngine(params, cfg, "taylorseer", slots=4,
                                     max_steps=16, device="cuda")
    eng.warmup()
    reqs = [DiffusionRequest(i, num_steps=(8, 16)[i % 2], seed=i,
                             class_label=(37 * i) % cfg.dit_num_classes,
                             cfg_scale=4.0 if i in (1, 4) else 0.0)
            for i in range(8)]
    eng.serve(reqs)
    rows = []
    for _ in range(reps):
        eng.serve(reqs)
        s = eng.telemetry.summary()
        rows.append((s["throughput_rps"], s["tick_ms_backbone_mean"],
                     s["tick_ms_skip_mean"]))
    med = [statistics.median(col) for col in zip(*rows)]
    syncs = sync_count(torch, lambda: eng.serve(reqs))
    ticks = eng.telemetry.summary()["ticks"]
    print(json.dumps({"src": src, "policy": policy,
                      "throughput_rps": med[0], "tick_ms_backbone": med[1],
                      "tick_ms_skip": med[2], "syncs": syncs,
                      "ticks": ticks, "syncs_per_tick": syncs / ticks,
                      "runs": rows}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--order", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--policy", default="taylorseer",
                    choices=("taylorseer", "teacache-cfg"))
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.reps, args.policy)
        return 0
    n = len(args.src)
    order = ([int(i) for i in args.order.split(",")] if args.order
             else [0] + list(range(1, n)) + list(range(n - 1, 0, -1)) + [0])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"serve_ab: {card}", flush=True)
    for i in order:
        out = subprocess.run([sys.executable, __file__, "--src", args.src[i],
                              "--child", args.src[i], "--reps",
                              str(args.reps), "--policy", args.policy],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"serve_ab: tree {i} ({args.src[i]}) {args.policy}: "
              f"throughput_rps={res['throughput_rps']:.4f} "
              f"tick_ms_backbone={res['tick_ms_backbone']:.3f} "
              f"tick_ms_skip={res['tick_ms_skip']:.3f} syncs_per_tick="
              f"{res['syncs_per_tick']:.3f} ({res['syncs']} in "
              f"{res['ticks']} ticks)", flush=True)
        print(json.dumps(dict(res, tree=i)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
