"""Reverse-process samplers (survey §II-D, §III-A), the port of the JAX
`samplers.py`: DDPM, DDIM, DPM-Solver++(2M), the rectified-flow Euler step
and the generic sampling loop.

A sampler step is `x_prev, extra = step(x_t, eps_hat, i, timesteps, sched,
generator, extra)`; the loop runs over the Python step index so cache
policies with static schedules decide on the host.  DDPM draws its noise
from the explicit `torch.Generator` the loop passes (torch cannot reproduce
`jax.random`, so its draws differ from JAX's).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .schedules import NoiseSchedule


def ddpm_step(x, eps_hat, i, timesteps, sched: NoiseSchedule, generator,
              extra):
    """DDPM ancestral step (Eq. 7/9); the noise comes from `generator`."""
    t = int(timesteps[i])
    t_next = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
    ab_t = float(sched.alpha_bars[t])
    ab_n = float(sched.alpha_bars[t_next]) if t_next >= 0 else 1.0
    alpha = ab_t / ab_n
    beta = 1.0 - alpha
    mean = (x - beta / float(np.sqrt(1.0 - ab_t)) * eps_hat) / float(
        np.sqrt(alpha))
    if t_next >= 0:
        sigma = float(np.sqrt(beta * (1.0 - ab_n) / (1.0 - ab_t)))
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device)
        return mean + sigma * noise, extra
    return mean, extra


def ddim_step(x, eps_hat, i, timesteps, sched: NoiseSchedule, generator, extra):
    """Deterministic DDIM step (survey ref [54]); `generator` is unused."""
    t = int(timesteps[i])
    t_next = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
    ab_t = float(sched.alpha_bars[t])
    ab_n = float(sched.alpha_bars[t_next]) if t_next >= 0 else 1.0
    x0_hat = (x - float(np.sqrt(1.0 - ab_t)) * eps_hat) / float(np.sqrt(ab_t))
    return (float(np.sqrt(ab_n)) * x0_hat
            + float(np.sqrt(1.0 - ab_n)) * eps_hat), extra


def _lambda(ab):  # log-SNR/2
    return 0.5 * float(np.log(ab / (1.0 - ab)))


def dpmpp_2m_step(x, eps_hat, i, timesteps, sched: NoiseSchedule, generator,
                  extra):
    """DPM-Solver++(2M) (survey ref [58]), multistep 2nd order on the data
    prediction; `extra` carries the previous x0 prediction and step size."""
    t = int(timesteps[i])
    t_next = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
    ab_t = float(sched.alpha_bars[t])
    ab_n = float(sched.alpha_bars[t_next]) if t_next >= 0 else 1.0 - 1e-6
    x0_hat = (x - float(np.sqrt(1.0 - ab_t)) * eps_hat) / float(np.sqrt(ab_t))
    h = _lambda(ab_n) - _lambda(ab_t)
    sig_t, sig_n = float(np.sqrt(1.0 - ab_t)), float(np.sqrt(1.0 - ab_n))
    prev = extra.get("x0_prev") if isinstance(extra, dict) else None
    if prev is not None and extra.get("h_prev"):
        r = extra["h_prev"] / h
        D = (1.0 + 1.0 / (2.0 * r)) * x0_hat - (1.0 / (2.0 * r)) * prev
    else:
        D = x0_hat
    x_next = sig_n / sig_t * x - float(np.sqrt(ab_n) * np.expm1(-h)) * D
    return x_next, {"x0_prev": x0_hat, "h_prev": h}


def rf_euler_step(x, v_hat, i, times, sched, generator, extra):
    """Rectified-flow Euler step (survey Eq. 10); `times` is the float grid
    1 -> 0 of `rectified_flow_times`, v_hat = eps - x0."""
    return x + float(times[i + 1] - times[i]) * v_hat, extra


def sample(denoise_fn: Callable, x_T, timesteps, sched: Optional[NoiseSchedule],
           step_fn=ddim_step, generator: Optional[torch.Generator] = None,
           denoiser_state=None):
    """Run the reverse process.

    denoise_fn(state, i, x, t) -> (eps_hat, state); `i` is the Python step
    index, `t` the (B,) model-facing timestep.  `generator` feeds samplers
    that draw noise (a generator seeded 0 on x_T's device when None).
    Under `rf_euler_step` the loop runs len(times) - 1 steps.  Returns
    (x_0, final denoiser state)."""
    if generator is None:
        generator = torch.Generator(device=x_T.device).manual_seed(0)
    x = x_T
    extra: Any = {}
    n = len(timesteps) - 1 if step_fn is rf_euler_step else len(timesteps)
    for i in range(n):
        t_vec = torch.full((x.shape[0],), float(timesteps[i]),
                           dtype=torch.float32, device=x.device)
        eps_hat, denoiser_state = denoise_fn(denoiser_state, i, x, t_vec)
        x, extra = step_fn(x, eps_hat, i, timesteps, sched, generator, extra)
    return x, denoiser_state
