#!/usr/bin/env python3
"""How far one AdamW step moves when its gradients move a little, on the
CPU.

    PYTHONPATH=src python3 tools/adamw_first_step.py [--arch A ...] [--rel R ...]

For each SMOKE config (f32, params from seed 0, the batch lm_batches(0,
8, 100) as chip_smoke's check phases use) the gradient of `lm_loss` is
taken once; then for each relative size R every nonzero gradient element
gets N(0, R * the leaf's largest |g|) added, and one AdamW step (the
launcher's lr 3e-4, warmup 0, clip 1, weight decay 0.1) is applied to
the exact and to the perturbed gradients from the same state.  Prints
the largest relative difference of the params (max |a - b| / max |b|
over each leaf, the worst leaf) and of the moments.  AdamW's first
update is lr * g / (|g| + eps): an element near 0 whose sign the noise
flips moves its param by up to 2 lr, so the params' difference is far
above the gradients' while the moments' stays at it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import lm_batches
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.train.steps import (TrainState, _optimize, _value_and_grad,
                                     lm_loss)
from repro_torch.tree import tree_leaves, tree_map, tree_paths, \
    tree_unflatten_like


def worst(a, b):
    return max((float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)),
                k) for (k, x), (_, y) in zip(tree_paths(a), tree_paths(b)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append")
    ap.add_argument("--rel", action="append", type=float)
    args = ap.parse_args(argv)
    kw = dict(peak_lr=3e-4, warmup=0, total_steps=1, max_grad_norm=1.0,
              weight_decay=0.1)
    for arch in args.arch or ["tinyllama-1.1b", "arctic-480b",
                              "deepseek-v2-236b"]:
        cfg = get_smoke_config(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
        t, y = (torch.from_numpy(a) for a in next(lm_batches(
            0, 8, 100, cfg.vocab_size)))
        g, m = _value_and_grad(lambda p, _: lm_loss(p, t, y, cfg), params,
                               None)

        def step(grads):
            p = tree_map(lambda x: x.clone(), params)
            return _optimize(TrainState(p, adamw_init(p)), grads, m, **kw)[0]

        ref = step(g)
        gen = torch.Generator().manual_seed(1)
        for rel in args.rel or [3e-7, 1e-6, 3e-6]:
            noisy = tree_unflatten_like(g, [
                x + (x != 0) * torch.randn(x.shape, generator=gen) * rel
                * x.abs().max() for x in tree_leaves(g)])
            out = step(noisy)
            moments = max(worst(out.opt.mu, ref.opt.mu),
                          worst(out.opt.nu, ref.opt.nu))
            print(f"{arch}: gradient noise {rel:.0e} of each leaf's largest: "
                  f"params {worst(out.params, ref.params)}, moments "
                  f"{moments}", flush=True)


if __name__ == "__main__":
    main()
