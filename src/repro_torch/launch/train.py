"""Training launcher of the port: the flags of the JAX package's
`repro.launch.train`, plus `--device`.

    python -m repro_torch.launch.train --steps 100               # on the GPU
    python -m repro_torch.launch.train --arch zamba2-2.7b --steps 10
    python -m repro_torch.launch.train --arch dit-xl --smoke --device cpu

`--arch` takes the port's configs on which JAX's launcher trains, and
defaults to JAX's tinyllama-1.1b: the dense LMs (tinyllama-1.1b, qwen2-7b,
qwen2.5-14b, minitron-8b), the moe LMs arctic-480b and deepseek-v2-236b
(their load-balance and router-z losses in the loss; at full width
neither fits one card; deepseek-v2's MLA attention, q/k head dim 192 over
v 128, differentiates through the split flash backward), the hybrid LM
zamba2-2.7b (its SSD scans
differentiate through the scan's backward kernel on the card), the Mamba1
LM falcon-mamba-7b (its plain PyTorch scan differentiates) and the
class-conditioned DiTs (dit-xl, dit-audio and dit-t2i, whose prompt-less
forward runs the zero-table text branch).  JAX's launcher fails on the
video DiTs (it calls the image DiT's forward on their params), on
whisper-small (it runs the decoder LM's forward on an encoder-decoder) and
on pixtral-12b (its batches carry no vision embeddings), so the port
raises for them.  Random weights from `--seed`; the LM batches of step n
are `lm_batches(seed, ...)`'s, and the diffusion draws of step n come from
a generator seeded with (seed + 1, n).
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import ALL_ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.diffusion import linear_schedule
from repro_torch.train import train_loop
from repro_torch.train.steps import (diffusion_batches, init_train_state,
                                     make_diffusion_train_step,
                                     make_lm_train_step)


def train(arch: str, *, smoke: bool = False, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, accum: int = 1,
          ckpt_dir: Optional[str] = None, seed: int = 0, device=None,
          warmup: int = 100, ckpt_every: int = 500, log_every: int = 10,
          log_fn=print, start_step: int = 0, state=None):
    """Train `arch` for `steps` steps, as `main` does; the keywords past
    `seed` are the step factories' and the loop's defaults (JAX's launcher
    keeps them fixed).  `state` and `start_step` resume a run: the batches
    then start at `start_step` (the loop counts its steps from 1, so a
    resumed run writes no checkpoints).  Returns (state, history)."""
    if start_step and ckpt_dir:
        raise ValueError("a resumed run would number its checkpoints from "
                         "step 1: pass no ckpt_dir with start_step")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.is_dit and cfg.dit_num_frames > 0:
        raise ValueError(
            f"{cfg.name}: the video DiTs do not train through this launcher "
            f"(JAX's launcher fails on them as well: it runs the image DiT's "
            f"forward on video params)")
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder does not train through this "
            f"launcher (JAX's fails on it as well): differentiate a loss of "
            f"repro_torch.models.encdec.forward(params, frames, tokens, cfg)")
    if cfg.family == "vlm":
        raise ValueError(
            f"{cfg.name}: the launcher's batches carry no vision embeddings "
            f"(JAX's fail on it as well): train it with make_lm_train_step "
            f"on batches with \"vision_embeds\"")
    dev = resolve_device(device)
    log_fn(f"training {cfg.name} ({cfg.family}) for {steps} steps on {dev}")
    if state is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_train_state(gen, cfg, device=dev)
    if cfg.is_dit:
        step = make_diffusion_train_step(cfg, linear_schedule(1000),
                                         peak_lr=lr, warmup=warmup,
                                         total_steps=steps, accum=accum)
        it = diffusion_batches(seed, batch, cfg, dev, start_step=start_step)
    else:
        step = make_lm_train_step(cfg, peak_lr=lr, warmup=warmup,
                                  total_steps=steps, accum=accum)
        it = ({"tokens": torch.from_numpy(t).to(dev),
               "targets": torch.from_numpy(y).to(dev)}
              for t, y in lm_batches(seed, batch, seq, cfg.vocab_size,
                                     start_step=start_step))
    return train_loop(step, state, it, steps - start_step,
                      log_every=log_every, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, log_fn=log_fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    state, history = train(args.arch, smoke=args.smoke, steps=args.steps,
                           batch=args.batch, seq=args.seq, lr=args.lr,
                           accum=args.accum, ckpt_dir=args.ckpt_dir,
                           seed=args.seed, device=args.device)
    if history:
        print(f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    return state, history


if __name__ == "__main__":
    main()
