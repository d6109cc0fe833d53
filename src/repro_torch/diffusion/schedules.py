"""Noise schedules (survey §III-A), the port of the JAX `schedules.py`.

Schedules are host-side numpy tables.  Construction may run in float64,
but every table the class exposes is float32, and the alpha-bar cumprod
accumulates in float64 before the cast (a 1000-term f32 cumprod drifts).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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

    def spaced(self, num_steps: int) -> np.ndarray:
        """Evenly spaced sampling timesteps T-1 ... 0 (descending)."""
        return np.linspace(self.T - 1, 0, num_steps).round().astype(np.int64)


def linear_schedule(T: int = 1000, beta_min: float = 1e-4,
                    beta_max: float = 0.02) -> NoiseSchedule:
    return NoiseSchedule(np.linspace(beta_min, beta_max, T, dtype=np.float64))
