#!/usr/bin/env python3
"""The general flash units against the bf16 units the wrapper routes to
above head dim 128, on one CUDA card.

    python3 tools/flash_any_ab.py [--reps 20] [--rounds 4]

The general units (`csrc/flash_attention_any.cu`,
`csrc/flash_attention_bwd_any.cu`) take every head dim; in bf16 with
16-byte rows the wrapper still routes D 160 to flash_attention.cu's 160
instantiation and q/k 192 over v 128 to its split one, with
`csrc/flash_attention_bwd_wide.cu` under grad.  This times both on the
same inputs at pixtral-12b's training shape (B 2, S 1088, 32 / 8 heads of
160) and deepseek-v2's MLA (B 4, S 512, 128 heads of q/k 192 over v 128),
causal, bf16: the serving forward, the forward that also writes the
rows' log-sum-exp, and the backward (both from the routed forward's o
and lse).  For each: device ms per call (CUDA events around `reps`
back-to-back calls; the two units in turns, the order reversed each
round; the median of the rounds), the largest difference between the two
units' outputs, and each one's largest error against float64 (the plain
version for a forward, float64 autograd for the backward).  Prints the
card's name and power limit, then one JSON line of the rows.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (  # name, B, S, H, KH, D, Dv
    ("pixtral bf16 (d 160)", 2, 1088, 32, 8, 160, 160),
    ("mla bf16 (192 over 128)", 4, 512, 128, 128, 192, 128),
)
UNITS = ("routed", "any")


def device_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("flash_any_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import attention_ref, ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, B, S, H, KH, D, Dv in SHAPES:
        q, k, v, do = (torch.randn(sh, generator=gen, device="cuda")
                       .bfloat16() for sh in ((B, S, H, D), (B, S, KH, D),
                                              (B, S, KH, Dv), (B, S, H, Dv)))
        scale = 1.0 / math.sqrt(D)
        aligned = ops.aligned16(D, Dv, (q, k, v))
        serve = ops.route(q.dtype, D, Dv, aligned, False)
        train = ops.route(q.dtype, D, Dv, aligned, True)
        if ops.ANY_FWD in (serve.forward, train.forward) \
                or train.backward == ops.ANY_BWD:
            print(f"flash_any_ab: {name} is routed to the general units")
            return 1
        lse = {u: torch.empty((B, H, S), dtype=torch.float32, device="cuda")
               for u in UNITS}
        fwd = {"routed": serve.forward, "any": ops.ANY_FWD}
        fwd_lse = {"routed": train.forward, "any": ops.ANY_FWD}
        bwd = {"routed": train.backward, "any": ops.ANY_BWD}
        entries = {"forward": fwd, "forward with lse": fwd_lse,
                   "backward": bwd}
        o = {u: ops._forward(q, k, v, True, 0, scale, lse[u], fwd_lse[u])
             for u in UNITS}
        o_r, lse_r = o["routed"], lse["routed"]
        calls = {
            "forward": {u: (lambda u=u: ops._forward(
                q, k, v, True, 0, scale, None, fwd[u])) for u in UNITS},
            "forward with lse": {u: (lambda u=u: ops._forward(
                q, k, v, True, 0, scale, lse[u], fwd_lse[u])) for u in UNITS},
            "backward": {u: (lambda u=u: ops._backward(
                q, k, v, o_r, do, lse_r, True, 0, scale, bwd[u]))
                for u in UNITS}}
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        ref = attention_ref(q64, k64, v64, causal=True)
        grads = torch.autograd.grad(ref, (q64, k64, v64), do.double())
        ref = ref.detach()
        del q64, k64, v64
        for op, fns in calls.items():
            outs = {u: fns[u]() for u in UNITS}
            if op == "backward":
                diff = max(max_abs(a, b) for a, b in zip(*outs.values()))
                err = {u: max(max_abs(a, b) for a, b in zip(outs[u], grads))
                       for u in UNITS}
            else:
                diff = max_abs(outs["routed"], outs["any"])
                err = {u: max_abs(outs[u], ref) for u in UNITS}
            del outs
            times = {u: [] for u in UNITS}
            for r in range(args.rounds):
                for u in (UNITS if r % 2 == 0 else UNITS[::-1]):
                    times[u].append(device_ms(torch, fns[u], args.reps))
            ms = {u: statistics.median(t) for u, t in times.items()}
            row = {"shape": name, "op": op, "entries": entries[op], "ms": ms,
                   "any_over_routed": ms["any"] / ms["routed"],
                   "rounds_ms": times, "max_abs_diff": diff,
                   "max_abs_err_vs_float64": err}
            rows.append(row)
            print(f"{name} {op}: routed {row['entries']['routed']} "
                  f"{ms['routed']:.4f} ms, general {ms['any']:.4f} ms "
                  f"({row['any_over_routed']:.2f}x); outputs differ by "
                  f"{diff:.3e}; against float64 routed {err['routed']:.3e}, "
                  f"general {err['any']:.3e}", flush=True)
        del q, k, v, do, o, o_r, lse, lse_r, ref, grads, calls
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"flash_any_ab": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
