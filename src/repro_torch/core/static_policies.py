"""Static caching policies (survey §III-C) of the port: FORA's fixed
interval, Δ-DiT's residual cache, PAB's per-module-type ranges and
FasterCache's CFG-branch reuse (FasterCacheCFG)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import Staged, to_device

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


class FasterCacheCFG(CachePolicy):
    """FasterCache's CFG-branch reuse (survey §III-C): it gates the
    unconditional stream of a guided request (CachedDenoiser's and the
    serving engine's `cfg_policy`), refreshing it every `interval` steps.

    Two reconstructions between refreshes:
      "extrapolate" (default): caches the last two uncond outputs and
        returns prev + w (prev - prev2), w the trajectory progress
        step / (num_steps - 1), or the `cfg_w` the caller passes (serving
        slots run different step budgets against one instance).
      "lowfreq": caches the low band (token-axis rfft, `cutoff`) of
        cond_out - eps_u and returns cond_out - that band, so the uncond
        branch follows every step's fresh cond output; needs `cond_out`.
    """

    name = "fastercache_cfg"

    def __init__(self, interval: int, num_steps: int,
                 mode: str = "extrapolate", cutoff: float = 0.25):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if mode not in ("extrapolate", "lowfreq"):
            raise ValueError(f"mode must be 'extrapolate' or 'lowfreq', got "
                             f"{mode!r}")
        self.interval = interval
        self.num_steps = num_steps
        self.mode = mode
        self.cutoff = float(cutoff)

    def init_state(self, shape, dtype=torch.float32, *, device):
        if self.mode == "lowfreq":
            return {"delta_low": torch.zeros(shape, dtype=torch.float32,
                                             device=device)}
        return {"prev": torch.zeros(shape, dtype=dtype, device=device),
                "prev2": torch.zeros(shape, dtype=dtype, device=device)}

    def _low(self, cond_out, y):
        return lowpass(cond_out.float() - y.float(), self.cutoff)

    @staticmethod
    def _need_cond_out(cond_out):
        if cond_out is None:
            raise ValueError(
                "FasterCacheCFG(mode='lowfreq') needs cond_out (the "
                "conditional branch output this step)")
        return cond_out

    def apply(self, state, step, x, compute_fn, **signals):
        cond_out = signals.get("cond_out")
        if self.mode == "lowfreq":
            cond_out = self._need_cond_out(cond_out)
            if interval_pred(step, self.interval):
                y = compute_fn(x)
                return y, {"delta_low": self._low(cond_out, y)}
            return (cond_out.float() - state["delta_low"]).to(x.dtype), state
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {"prev": y.to(state["prev"].dtype),
                       "prev2": state["prev"]}
        w = signals.get("cfg_w")
        if w is None:
            w = step / max(self.num_steps - 1, 1)
        w = to_device(w, x.device, x.dtype)
        prev = state["prev"]
        return (prev + w * (prev - state["prev2"])).to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None,
                    cfg_w=None, cond_out=None):
        """`cfg_w`: (S,) per-slot progress weights (default each slot's
        step / (num_steps - 1)); `cond_out`: (S, ...) cond outputs."""
        want = self._slot_want(states, steps, xs, signal, want)
        lowfreq = self.mode == "lowfreq"
        if lowfreq:
            cond_out = self._need_cond_out(cond_out)
        y = ys
        if not want.all():
            if lowfreq:
                fc = cond_out.float() - states["delta_low"]
            else:
                if cfg_w is None and isinstance(steps, Staged):
                    cfg_w = steps.dev.float() / max(self.num_steps - 1, 1)
                elif cfg_w is None:
                    cfg_w = (np.asarray(steps, np.float32)
                             / max(self.num_steps - 1, 1))
                w = to_device(cfg_w, xs.device).to(xs.dtype)
                w = w.view((-1,) + (1,) * (xs.dim() - 1))
                prev = states["prev"]
                fc = prev + w * (prev - states["prev2"])
            fc = fc.to(xs.dtype)
            y = fc if not want.any() else torch.where(slot_mask(want, fc),
                                                      ys, fc)
        if not want.any():
            return y, states
        if lowfreq:
            low = states["delta_low"]
            return y, {"delta_low": torch.where(
                slot_mask(want, low), self._low(cond_out, ys), low)}
        prev, prev2 = states["prev"], states["prev2"]
        m = slot_mask(want, prev)
        return y, {"prev": torch.where(m, ys.to(prev.dtype), prev),
                   "prev2": torch.where(m, prev, prev2)}

    def want_compute(self, state, step, x=None, **signals):
        return interval_pred(step, self.interval)

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]
