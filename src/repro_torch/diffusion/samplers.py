"""Reverse-process samplers (survey §II-D), the port of the JAX
`samplers.py`: DDIM and the generic sampling loop.  DDPM, DPM-Solver++ and
rectified flow are not ported yet (ROADMAP.md §A).

A sampler step is `x_prev, extra = step(x_t, eps_hat, i, timesteps, sched,
generator, extra)`; the loop runs over the Python step index so cache
policies with static schedules decide on the host.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .schedules import NoiseSchedule


def ddim_step(x, eps_hat, i, timesteps, sched: NoiseSchedule, generator, extra):
    """Deterministic DDIM step (survey ref [54]); `generator` is unused."""
    t = int(timesteps[i])
    t_next = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
    ab_t = float(sched.alpha_bars[t])
    ab_n = float(sched.alpha_bars[t_next]) if t_next >= 0 else 1.0
    x0_hat = (x - float(np.sqrt(1.0 - ab_t)) * eps_hat) / float(np.sqrt(ab_t))
    return (float(np.sqrt(ab_n)) * x0_hat
            + float(np.sqrt(1.0 - ab_n)) * eps_hat), extra


def sample(denoise_fn: Callable, x_T, timesteps, sched: Optional[NoiseSchedule],
           step_fn=ddim_step, generator: Optional[torch.Generator] = None,
           denoiser_state=None):
    """Run the reverse process.

    denoise_fn(state, i, x, t) -> (eps_hat, state); `i` is the Python step
    index, `t` the (B,) model-facing timestep.  `generator` feeds samplers
    that draw noise.  Returns (x_0, final denoiser state)."""
    x = x_T
    extra: Any = {}
    for i in range(len(timesteps)):
        t_vec = torch.full((x.shape[0],), float(timesteps[i]),
                           dtype=torch.float32, device=x.device)
        eps_hat, denoiser_state = denoise_fn(denoiser_state, i, x, t_vec)
        x, extra = step_fn(x, eps_hat, i, timesteps, sched, generator, extra)
    return x, denoiser_state
