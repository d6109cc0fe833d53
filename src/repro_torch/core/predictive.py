"""Predictive ("Cache-Then-Forecast") policies — survey §III-D3, the port
of the JAX `core/predictive.py`: the taylor (TaylorSeer), newton, hermite
(HiCache), ab (AB-Cache) and foca (FoCa) bases, and FreqCa.

The state is a finite-difference stack over the features computed at the
last full steps (d[0] <- F, d[i] <- d[i-1] - d_old[i-1]), plus `n_valid`
(computes seen, masking unwarmed orders) and `last_step`.  A forecast
evaluates sum_i c_i(u) d[i] at u = (step - last_step) / interval through
the forecast kernel's fused entry `forecast_basis`, which computes each
slot's weights (its own u and n_valid) in the kernel: under serving a skip
tick's forecast is ONE launch over every slot, as XLA fuses JAX's
`forecast_from_diffs` under jit.  FoCa's BDF2 predictor + Heun corrector
reduces to the weights (1, min(ceil(u), 64)) (`basis_coeffs`), so it runs
on the same kernel.
"""
from __future__ import annotations

import torch

from repro_torch import spmd
from repro_torch.device import to_device
from repro_torch.kernels.forecast import (basis_coeffs, forecast,
                                          forecast_basis)

from .policy import CachePolicy, interval_pred, slot_mask
from .static_policies import lowpass

BASES = ("taylor", "newton", "hermite", "ab", "foca")


def update_diff_stack(diffs, y, dim: int = 0):
    """Shift an (order+1, ...) finite-difference stack (stack axis `dim`)
    with a new sample y."""
    order = diffs.shape[dim] - 1
    new = [y.to(diffs.dtype)]
    for i in range(1, order + 1):
        new.append(new[i - 1] - diffs.select(dim, i - 1))
    return torch.stack(new, dim=dim)


def forecast_from_diffs(diffs, u, n_valid, basis: str = "taylor",
                        sigma: float = 0.5):
    """Evaluate the basis at normalised offset u.

    u scalar: diffs (order+1, ...) -> (...).  u of shape (S,): diffs
    (S, order+1, ...) -> (S, ...), one kernel launch for all S rows."""
    u = to_device(u, diffs.device, torch.float32)
    order = diffs.shape[u.dim()] - 1
    coeffs = basis_coeffs(order, u, basis, sigma, n_valid)
    return spmd.forecast(forecast, diffs.contiguous(),
                         coeffs.contiguous()).float()


def forecast_slots(states, steps, ys, want, interval, basis, sigma, dtype,
                   key="diffs"):
    """One serving tick of a difference-stack policy: slots in `want` push
    their fresh output onto their stack, the others forecast (one kernel
    launch over every slot).  Returns (y, the new diffs / n_valid /
    last_step leaves)."""
    diffs, n_valid, last = states[key], states["n_valid"], states["last_step"]
    y = ys
    if not want.all():
        fc = forecast_basis(diffs, steps, last, n_valid, interval, basis,
                            sigma).to(dtype)
        y = fc if not want.any() else torch.where(slot_mask(want, fc), ys, fc)
    if not want.any():
        return y, {key: diffs, "n_valid": n_valid, "last_step": last}
    steps_t = to_device(steps, diffs.device, torch.int32)
    m = slot_mask(want, n_valid)
    return y, {
        key: torch.where(slot_mask(want, diffs),
                         update_diff_stack(diffs, ys, dim=1), diffs),
        "n_valid": torch.where(m, n_valid + 1, n_valid),
        "last_step": torch.where(m, steps_t, last),
    }


class PredictivePolicy(CachePolicy):
    """TaylorSeer / NewtonSeer / HiCache / AB-Cache / FoCa under one roof."""

    is_predictive = True

    def __init__(self, interval: int, order: int = 2, basis: str = "taylor",
                 sigma: float = 0.5):
        if basis not in BASES:
            raise ValueError(f"unknown forecast basis '{basis}' (one of "
                             f"{BASES})")
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.interval = interval
        self.order = order
        self.basis = basis
        self.sigma = sigma
        self.name = {"taylor": "taylorseer", "newton": "newtonseer",
                     "hermite": "hicache", "ab": "abcache",
                     "foca": "foca"}[basis]

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {
            "diffs": torch.zeros((self.order + 1, *shape), dtype=dtype,
                                 device=device),
            "n_valid": torch.zeros((), dtype=torch.int32, device=device),
            "last_step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(self, state, step, x, compute_fn, **signals):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {
                "diffs": update_diff_stack(state["diffs"], y),
                "n_valid": state["n_valid"] + 1,
                "last_step": torch.full_like(state["last_step"], step),
            }
        y = spmd.forecast(forecast_basis, state["diffs"], step,
                          state["last_step"], state["n_valid"],
                          self.interval, self.basis, self.sigma)
        return y.to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        return forecast_slots(states, steps, ys, want, self.interval,
                              self.basis, self.sigma, xs.dtype)

    def want_compute(self, state, step, x=None, **signals):
        return interval_pred(step, self.interval)

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]


class FreqCaPolicy(PredictivePolicy):
    """FreqCa (Eq. 49-51): split the feature along the token axis into low
    and high frequency bands (rfft); the low band is reused verbatim, the
    high band forecast with the 2nd-order Hermite basis."""

    name = "freqca"

    def __init__(self, interval: int, cutoff: float = 0.25,
                 sigma: float = 0.5, axis: int = -2):
        super().__init__(interval, 2, "hermite", sigma)
        self.name = "freqca"
        self.cutoff = cutoff
        self.axis = axis

    def _split(self, y):
        low = lowpass(y, self.cutoff, self.axis)
        return low, y.float() - low

    def init_state(self, shape, dtype=torch.float32, *, device):
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "low": torch.zeros(shape, **f32),
            "high_diffs": torch.zeros((3, *shape), **f32),
            "n_valid": torch.zeros((), dtype=torch.int32, device=device),
            "last_step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(self, state, step, x, compute_fn, **signals):
        return self._apply_as_slot(state, step, x, compute_fn)

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        low = states["low"]
        new = dict(states)
        if want.any():
            # the split of the fresh rows (zero rows of other slots are
            # discarded by the select)
            low_c, high_c = self._split(ys)
            low = torch.where(slot_mask(want, low), low_c, low)
            fresh = high_c
        else:
            fresh = ys
        high, upd = forecast_slots(states, steps, fresh, want,
                                   self.interval, "hermite", self.sigma,
                                   torch.float32, key="high_diffs")
        new.update(upd, low=low)
        if want.all():
            return ys, new
        fc = (states["low"] + high).to(xs.dtype)
        y = fc if not want.any() else torch.where(slot_mask(want, fc), ys, fc)
        return y, new
