"""Train the JAX example's "~100M" DiT (12 layers x d_model 768, 130M
params) on the PyTorch port, then sample from it with a cache policy.

    PYTHONPATH=src python examples/torch_train_dit.py [--steps 300] [--small] [--device cpu]

The steps of `examples/train_dit.py` on `repro_torch`, on the GPU unless
--device says otherwise: the synthetic class-conditional latents of
`repro_torch.data`, AdamW with the cosine schedule and gradient clipping,
the train loop with a checkpoint at half the steps and at the end, restore,
and a TaylorSeer-cached DDIM sample from the trained params.  On the card
every self-attention runs through the flash kernel in both directions and
the cached sample's skip steps through the forecast kernel.

`run(steps, batch, small, device, log)` holds the steps, so a caller can
drive them (chip_smoke.py trains the 130M model through it).  Weights and
draws come from torch generators, so the numbers differ from the JAX
example's.
"""
import argparse
import os
import tempfile

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core import make_policy
from repro_torch.diffusion import (CachedDenoiser, ddim_step, linear_schedule,
                                   sample)
from repro_torch.train import train_loop
from repro_torch.train.steps import (diffusion_batches, init_train_state,
                                     make_diffusion_train_step)
from repro_torch.tree import tree_leaves


def example_config(small: bool):
    """The JAX example's configs: 12 layers x d_model 768 (130M params; the
    JAX example calls it ~100M), 64 tokens, 10 classes, or its 2-layer
    debug model."""
    if small:
        return get_config("dit-xl").reduced(num_layers=2, d_model=128,
                                            dit_patch_tokens=16)
    return get_config("dit-xl").reduced(
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, dit_patch_tokens=64, dit_in_dim=16, dit_num_classes=10,
        vocab_size=0)


def run(steps=300, batch=16, small=False, device="cuda", log=print):
    """Train, checkpoint, restore and sample; asserts that the loss falls,
    that the restored state equals the trained one and that the sample is
    finite.  Returns the history, the restored step, the checkpoint's
    directory listing and the sample."""
    cfg = example_config(small)
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    log(f"model: {cfg.num_layers}L d={cfg.d_model} "
        f"({n_params / 1e6:.0f}M params, {cfg.dtype})")

    sched = linear_schedule(1000)
    step_fn = make_diffusion_train_step(cfg, sched, peak_lr=2e-4, warmup=50,
                                        total_steps=steps)
    batches = diffusion_batches(0, batch, cfg, device, draw_seed=2)
    with tempfile.TemporaryDirectory() as d:
        state, hist = train_loop(step_fn, state, batches, steps,
                                 log_every=max(steps // 10, 1), ckpt_dir=d,
                                 ckpt_every=max(steps // 2, 1), log_fn=log)
        saved = sorted(os.listdir(d))
        restored, at_step, _ = ckpt.restore(d, state)
    log(f"checkpoint restored from step {at_step} (kept {saved})")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(state)))

    first, last = hist[0]["loss"], hist[-1]["loss"]
    log(f"loss: {first:.4f} -> {last:.4f}")
    assert last < first, "training should reduce the loss"

    # sample from the trained model under TaylorSeer
    ts = sched.spaced(40)
    x_T = torch.randn((4, cfg.dit_patch_tokens, cfg.dit_in_dim),
                      generator=torch.Generator(device=device).manual_seed(3),
                      device=device)
    with torch.no_grad():
        den = CachedDenoiser(restored.params, cfg,
                             make_policy("taylorseer", interval=4),
                             device=device)
        x0, _ = sample(den, x_T, ts, sched, step_fn=ddim_step,
                       denoiser_state=den.init_state(4))
    finite = bool(torch.isfinite(x0).all())
    log(f"cached sample stats: mean={float(x0.mean()):.3f} "
        f"std={float(x0.std()):.3f} finite={finite}")
    assert finite
    return {"history": hist, "restored_step": at_step, "kept": saved,
            "x0": x0, "params": n_params}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--small", action="store_true",
                    help="2-layer debug model instead of the 130M one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.steps, args.batch, args.small, args.device)
    print("OK")


if __name__ == "__main__":
    main()
