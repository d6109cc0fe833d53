"""Static caching policies (survey §III-C) of the port: FORA's fixed
interval, Δ-DiT's residual cache and PAB's per-module-type ranges.
FasterCacheCFG is not ported yet (ROADMAP.md §A.2)."""
from __future__ import annotations

from typing import Dict

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

    def apply(self, state, step, x, compute_fn, **signals):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {"cache": y.to(state["cache"].dtype)}
        return state["cache"].to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        cache = states["cache"]
        if not want.any():
            return cache.to(xs.dtype), states
        m = slot_mask(want, cache)
        y = torch.where(m, ys, cache.to(xs.dtype))
        return y, {"cache": torch.where(m, ys.to(cache.dtype), cache)}

    def want_compute(self, state, step, x=None, **signals):
        return interval_pred(step, self.interval)

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]


class DeltaCachePolicy(FixedIntervalPolicy):
    """Δ-DiT residual caching: store F(x) - x, reuse as x' + Δ, so a reuse
    step incorporates the fresh input."""

    name = "delta_dit"

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {"delta": torch.zeros(shape, dtype=dtype, device=device)}

    def apply(self, state, step, x, compute_fn, **signals):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {"delta": (y - x).to(state["delta"].dtype)}
        return x + state["delta"].to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        delta = states["delta"]
        reuse = xs + delta.to(xs.dtype)
        if not want.any():
            return reuse, states
        m = slot_mask(want, delta)
        return torch.where(m, ys, reuse), {
            "delta": torch.where(m, (ys - xs).to(delta.dtype), delta)}


class PABPolicy(FixedIntervalPolicy):
    """Pyramid Attention Broadcast: the broadcast range (= interval) is
    chosen per module *type*; spatial attention gets the smallest range,
    cross attention the largest."""

    name = "pab"

    RANGES = {"spatial_attn": 2, "temporal_attn": 4, "cross_attn": 6, "mlp": 4}

    def __init__(self, module_type: str, ranges: Dict[str, int] | None = None):
        ranges = dict(self.RANGES if ranges is None else ranges)
        super().__init__(ranges[module_type])
        self.module_type = module_type


def lowpass(y, cutoff: float, dim: int = -2):
    """Low-frequency band of `y` along `dim` (FreqCa-style rfft mask):
    frequencies up to max(int(cutoff * n // 2), 1) are kept."""
    n = y.shape[dim]
    f = torch.fft.rfft(y.float(), dim=dim)
    keep = torch.arange(f.shape[dim], device=y.device) <= max(
        int(cutoff * n // 2), 1)
    shape = [1] * y.dim()
    shape[dim] = f.shape[dim]
    return torch.fft.irfft(f * keep.view(shape), n=n, dim=dim)
