"""Static caching policies (survey §III-C) of the port: FORA's fixed
interval.  Δ-DiT, PAB and FasterCacheCFG are not ported yet
(ROADMAP.md §A)."""
from __future__ import annotations

import torch

from .policy import CachePolicy, interval_pred, slot_mask


class FixedIntervalPolicy(CachePolicy):
    """FORA-style: compute at steps {0, N, 2N, ...}, reuse otherwise."""

    name = "fora"

    def __init__(self, interval: int):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.interval = interval

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {"cache": torch.zeros(shape, dtype=dtype, device=device)}

    def apply(self, state, step, x, compute_fn):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {"cache": y.to(state["cache"].dtype)}
        return state["cache"].to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys):
        want = interval_pred(steps, self.interval)
        cache = states["cache"]
        if not want.any():
            return cache.to(xs.dtype), states
        m = slot_mask(want, cache)
        y = torch.where(m, ys, cache.to(xs.dtype))
        return y, {"cache": torch.where(m, ys.to(cache.dtype), cache)}

    def want_compute(self, state, step, x=None):
        return interval_pred(step, self.interval)

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]
