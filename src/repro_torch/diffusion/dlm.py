"""Discrete diffusion language model (LLaDA-style) with feature caching: the
survey's §IV-F application (dLLM-Cache) on the port's transformer, the
counterpart of the JAX package's `diffusion/dlm.py`.

Generation is iterative mask-denoising: start from an all-[MASK] canvas;
at each of T steps run the (bidirectional) transformer over the full
canvas under a cache policy's scalar `apply`, then commit the most
confident still-masked positions of each row on a cosine schedule.
Adjacent steps differ in a few committed tokens, so the logits evolve
smoothly and a policy can reuse or forecast them between full computes.

The mask token id is `vocab_size - 1`.  Greedy generation (temperature 0)
follows JAX's decisions: the first maximum of each row, the same commit
counts from the same f32 cosine.  With a temperature, the draws come from a
`torch.Generator` and differ from `jax.random.categorical`'s.  Runs on the
device the params live on.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import CachePolicy, NoCachePolicy
from repro_torch.device import tree_device
from repro_torch.models import transformer


def dlm_forward(params, tokens, cfg):
    """Bidirectional logits for mask-denoising: the causal model run on the
    canvas and on the reversed canvas, averaged (no new weights)."""
    logits_f = transformer.forward(params, tokens, cfg)
    logits_b = transformer.forward(params, tokens.flip(1), cfg)
    return 0.5 * (logits_f + logits_b.flip(1))


def _commit_fraction(step: int, num_steps: int) -> float:
    """cos((step + 1) / T * pi / 2) at JAX's f32 argument, rounded to f32
    (JAX takes the cosine in f32: the commit counts int(frac * S) agree for
    every T <= 32 and S <= 1024)."""
    x = float(np.float32((step + 1) / num_steps * math.pi / 2))
    return float(np.float32(math.cos(x)))


def dlm_generate(params, cfg, *, batch: int, seq_len: int, num_steps: int = 8,
                 policy: Optional[CachePolicy] = None,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0):
    """Mask-denoising generation under an optional cache policy.

    Returns (tokens (B, S) int64 on the params' device, the number of full
    computes).  `generator` (on that device) feeds the draws when
    temperature > 0."""
    dev = tree_device(params)
    policy = policy or NoCachePolicy()
    mask_id = cfg.vocab_size - 1
    canvas = torch.full((batch, seq_len), mask_id, dtype=torch.long,
                        device=dev)
    shape = (batch, seq_len, cfg.vocab_size)
    try:   # TeaCache tracks the (B, S) occupancy signal separately
        state = policy.init_state(shape, device=dev,
                                  signal_shape=(batch, seq_len))
    except TypeError:
        state = policy.init_state(shape, device=dev)
    ones = torch.ones((1, 1, cfg.vocab_size), device=dev)
    n_computed = 0
    pred = None
    for step in range(num_steps):
        hit = []

        def compute_fn(_x, _canvas=canvas):
            hit.append(True)
            return dlm_forward(params, _canvas, cfg)

        # the signal: the canvas's occupancy, which changes as tokens commit
        sig = (canvas != mask_id).float()
        logits, state = policy.apply(state, step, canvas.float()[..., None]
                                     * ones, compute_fn, signal=sig)
        n_computed += bool(hit)

        frac_keep = _commit_fraction(step, num_steps)
        probs = torch.softmax(logits.float(), dim=-1)
        conf = probs.max(dim=-1).values
        pred = probs.argmax(dim=-1)
        if temperature > 0.0:
            p = torch.softmax(logits.float() / temperature, dim=-1)
            pred = torch.multinomial(p.reshape(-1, cfg.vocab_size), 1,
                                     generator=generator).reshape(batch,
                                                                  seq_len)
        still_masked = canvas == mask_id
        conf = torch.where(still_masked, conf,
                           torch.full_like(conf, -math.inf))
        n_mask = int(still_masked[0].sum())
        n_commit = max(n_mask - int(frac_keep * seq_len), 1)
        # each row's n_commit most confident masked positions
        thresh = torch.sort(conf, dim=-1, descending=True).values[
            :, n_commit - 1:n_commit]
        commit = still_masked & (conf >= thresh)
        canvas = torch.where(commit, pred, canvas)

    if pred is not None:   # any residual masks: fill greedily
        canvas = torch.where(canvas == mask_id, pred, canvas)
    return canvas, n_computed


__all__ = ["dlm_forward", "dlm_generate"]
