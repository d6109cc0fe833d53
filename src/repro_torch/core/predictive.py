"""Predictive ("Cache-Then-Forecast") policies — survey §III-D3, the port
of the JAX `core/predictive.py` for the taylor (TaylorSeer), newton,
hermite (HiCache) and ab (AB-Cache) bases.  FoCa and FreqCa are not ported
yet (ROADMAP.md §A).

The state is a finite-difference stack over the features computed at the
last full steps (d[0] <- F, d[i] <- d[i-1] - d_old[i-1]), plus `n_valid`
(computes seen, masking unwarmed orders) and `last_step`.  A forecast
evaluates sum_i c_i(u) d[i] at u = (step - last_step) / interval through
the forecast kernel's fused entry `forecast_basis`, which computes each
slot's weights (its own u and n_valid) in the kernel: under serving a skip
tick's forecast is ONE launch over every slot, as XLA fuses JAX's
`forecast_from_diffs` under jit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.forecast import (basis_coeffs, forecast,
                                          forecast_basis)

from .policy import CachePolicy, interval_pred, slot_mask

BASES = ("taylor", "newton", "hermite", "ab")


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
    u = torch.as_tensor(u, dtype=torch.float32, device=diffs.device)
    order = diffs.shape[u.dim()] - 1
    coeffs = basis_coeffs(order, u, basis, sigma, n_valid)
    return forecast(diffs.contiguous(), coeffs.contiguous()).float()


class PredictivePolicy(CachePolicy):
    """TaylorSeer / NewtonSeer / HiCache / AB-Cache under one roof."""

    is_predictive = True

    def __init__(self, interval: int, order: int = 2, basis: str = "taylor",
                 sigma: float = 0.5):
        if basis not in BASES:
            raise KeyError(f"forecast basis '{basis}' is not ported to "
                           f"repro_torch yet (ported: {BASES}); see "
                           f"ROADMAP.md §A")
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.interval = interval
        self.order = order
        self.basis = basis
        self.sigma = sigma
        self.name = {"taylor": "taylorseer", "newton": "newtonseer",
                     "hermite": "hicache", "ab": "abcache"}[basis]

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {
            "diffs": torch.zeros((self.order + 1, *shape), dtype=dtype,
                                 device=device),
            "n_valid": torch.zeros((), dtype=torch.int32, device=device),
            "last_step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(self, state, step, x, compute_fn):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {
                "diffs": update_diff_stack(state["diffs"], y),
                "n_valid": state["n_valid"] + 1,
                "last_step": torch.full_like(state["last_step"], step),
            }
        y = forecast_basis(state["diffs"], step, state["last_step"],
                           state["n_valid"], self.interval, self.basis,
                           self.sigma)
        return y.to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys):
        want = interval_pred(steps, self.interval)
        diffs, n_valid, last = (states["diffs"], states["n_valid"],
                                states["last_step"])
        y = ys
        if not want.all():
            fc = forecast_basis(diffs, steps, last, n_valid, self.interval,
                                self.basis, self.sigma).to(xs.dtype)
            y = fc if not want.any() else torch.where(slot_mask(want, fc),
                                                      ys, fc)
        if not want.any():
            return y, states
        steps_t = torch.as_tensor(steps, dtype=torch.int32, device=diffs.device)
        m = slot_mask(want, n_valid)
        return y, {
            "diffs": torch.where(slot_mask(want, diffs),
                                 update_diff_stack(diffs, ys, dim=1), diffs),
            "n_valid": torch.where(m, n_valid + 1, n_valid),
            "last_step": torch.where(m, steps_t, last),
        }

    def want_compute(self, state, step, x=None):
        return interval_pred(step, self.interval)

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]
