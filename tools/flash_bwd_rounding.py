#!/usr/bin/env python3
"""How far the flash backward's bf16 path lands from float64 autograd at
chip_smoke's bf16 flash-bwd shapes, for each way of carrying the f32 P and
dS into the bf16 tensor-core products, on the CPU.

    PYTHONPATH=src python3 tools/flash_bwd_rounding.py [--seeds 0 1 2 3]

For bf16 inputs (standard normal draws from a seed, the distribution
chip_smoke draws on the card) it recomputes the backward in float64 from the forward's bf16
output and f32 log-sum-exp, with P and dS
- as they are (f32 values, as f32 products take them);
- rounded once to bf16;
- as bf16 hi + lo pairs (what flash_attention_bwd.cu carries);
rounds the gradients to bf16 and prints, per shape and seed, the largest
absolute error of (dq, dk, dv) and its excess over one bf16 rounding of
the float64 value (chip_smoke's gates: 2e-2 abs; 2e-2 on the excess at
tinyllama's GQA group of 8).  About a minute.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention import (attention_lse_ref,  # noqa: E402
                                                 attention_ref)
from repro_torch.kernels.flash_attention.ref import _scores, bf16_pair  # noqa: E402

SHAPES = [  # name, B, S, H, KH, D, causal (chip_smoke's bf16 flash-bwd cases)
    ("dit-xl bf16 (train)", 8, 256, 16, 16, 72, False),
    ("zamba2 prefill", 4, 512, 32, 32, 80, True),
    ("tinyllama train (gqa 8)", 8, 128, 32, 4, 64, True),
]
MODES = {"f32 P, dS": lambda t: t,
         "bf16 P, dS": lambda t: t.float().to(torch.bfloat16).double(),
         "bf16 pairs": lambda t: bf16_pair(t.float()).double()}


def backward(q, k, v, o, do, lse, causal, operand):
    """(dq, dk, dv) in float64 with P and dS passed through `operand`."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    s, ok = _scores(q.double(), k.double(), causal, 0, scale)
    p = torch.exp(s - lse.double().reshape(B, KH, G, Sq, 1))
    do_g = do.double().reshape(B, Sq, KH, G, D)
    dv = torch.einsum("bkgqs,bqkgd->bskd", operand(p), do_g)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do_g, v.double())
    delta = (do_g * o.double().reshape(B, Sq, KH, G, D)).sum(-1)
    ds = torch.where(ok, p * (dp - delta.permute(0, 2, 3, 1)[..., None]),
                     torch.zeros((), dtype=torch.float64)) * scale
    ds = operand(ds)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.double())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.double().reshape(B, Sq, KH, G, D))
    return dq.reshape(B, Sq, H, D), dk, dv


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    torch.set_num_threads(4)
    for name, B, S, H, KH, D, causal in SHAPES:
        for seed in args.seeds:
            g = torch.Generator().manual_seed(seed)
            q, k, v, do = (torch.randn(sh, generator=g).to(torch.bfloat16)
                           for sh in ((B, S, H, D), (B, S, KH, D),
                                      (B, S, KH, D), (B, S, H, D)))
            q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
            ref = torch.autograd.grad(
                attention_ref(q64, k64, v64, causal=causal),
                (q64, k64, v64), do.double())
            o = attention_ref(q, k, v, causal=causal)
            lse = attention_lse_ref(q, k, causal=causal).float()
            for mode, operand in MODES.items():
                got = [t.float().to(torch.bfloat16).double() for t in
                       backward(q, k, v, o, do, lse, causal, operand)]
                err = [float((a - r).abs().max()) for a, r in zip(got, ref)]
                exc = [float(((a - r).abs() - 2.0 ** -8 * r.abs()).max())
                       for a, r in zip(got, ref)]
                print(f"{name} seed {seed} {mode}: max abs (dq, dk, dv) "
                      + ", ".join(f"{e:.3e}" for e in err)
                      + "; excess over one rounding "
                      + ", ".join(f"{e:.3e}" for e in exc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
