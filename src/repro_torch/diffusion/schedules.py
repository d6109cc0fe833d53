"""Noise schedules (survey §III-A), the port of the JAX `schedules.py`.

Schedules are host-side numpy tables.  Construction may run in float64,
but every table the class exposes is float32, and the alpha-bar cumprod
accumulates in float64 before the cast (a 1000-term f32 cumprod drifts).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    """Discrete-time DDPM schedule over T training steps."""
    betas: np.ndarray          # (T,) float32 (cast at construction)

    def __post_init__(self):
        object.__setattr__(self, "betas", np.asarray(self.betas, np.float32))

    @property
    def T(self) -> int:
        return int(self.betas.shape[0])

    @property
    def alphas(self) -> np.ndarray:
        return (1.0 - self.betas).astype(np.float32)

    @property
    def alpha_bars(self) -> np.ndarray:
        return np.cumprod(self.alphas, dtype=np.float64).astype(np.float32)

    def q_sample(self, x0, t, eps):
        """Forward diffuse x0 to step t (Eq. 4).  t: integer tensor (B,).
        The alpha-bar table goes to x0's device once and is kept there."""
        cache = self.__dict__.setdefault("_alpha_bars_on", {})
        ab_all = cache.get(x0.device)
        if ab_all is None:
            ab_all = cache[x0.device] = torch.as_tensor(
                self.alpha_bars, dtype=torch.float32, device=x0.device)
        ab = ab_all[t]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return (torch.sqrt(ab).reshape(shape) * x0
                + torch.sqrt(1.0 - ab).reshape(shape) * eps)

    def spaced(self, num_steps: int) -> np.ndarray:
        """Evenly spaced sampling timesteps T-1 ... 0 (descending)."""
        return np.linspace(self.T - 1, 0, num_steps).round().astype(np.int64)


def linear_schedule(T: int = 1000, beta_min: float = 1e-4,
                    beta_max: float = 0.02) -> NoiseSchedule:
    return NoiseSchedule(np.linspace(beta_min, beta_max, T, dtype=np.float64))


def cosine_schedule(T: int = 1000, s: float = 8e-3) -> NoiseSchedule:
    """IDDPM cosine alpha-bar schedule (survey ref [56]), built in float64."""
    steps = np.arange(T + 1, dtype=np.float64) / T
    abar = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    abar = abar / abar[0]
    return NoiseSchedule(np.clip(1.0 - abar[1:] / abar[:-1], 0.0, 0.999))


def rectified_flow_times(num_steps: int) -> np.ndarray:
    """Rectified-flow time grid 1 -> 0, float32 (survey Eq. 10 / ref [65]).

    x_t = (1-t) x0 + t eps; the model regresses velocity v = eps - x0."""
    return np.linspace(1.0, 0.0, num_steps + 1).astype(np.float32)
