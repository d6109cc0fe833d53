"""Serving launcher: batched generation over a ported LLM architecture.

    python -m repro_torch.launch.serve                             # on the GPU
    python -m repro_torch.launch.serve --arch zamba2-2.7b
    python -m repro_torch.launch.serve --smoke --device cpu

`--arch` defaults to JAX's tinyllama-1.1b and takes the port's LLMs: the
dense tinyllama-1.1b, qwen2-7b, qwen2.5-14b and minitron-8b, the moe
arctic-480b and deepseek-v2-236b (whole, neither fits one 80 GB card: use
--smoke, or cut the depth as chip_smoke.py's serve-moe phase does), the
hybrid zamba2-2.7b and the Mamba1 falcon-mamba-7b.  whisper-small and pixtral-12b
exit with the entry points that drive them (JAX's launcher fails on them
too).  Random weights drawn from `--seed`; runs on the GPU unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import engine_refusal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_dit:
        raise SystemExit("dit-xl serves via repro_torch.serving.diffusion")
    if engine_refusal(cfg):
        raise SystemExit(engine_refusal(cfg))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(gen, cfg, device=dev)
    engine = ServingEngine(params, cfg, slots=args.slots,
                           cache_len=args.cache_len, max_prompt=32,
                           temperature=args.temperature, device=dev)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=rng.integers(4, 16)).tolist()
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=args.max_new,
                              seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {dev}")
    for r in results[:4]:
        print(f"  req{r.request_id}: prompt={r.prompt[:6]}... "
              f"-> {r.tokens[:12]}")


if __name__ == "__main__":
    main()
