"""Hybrid caching policies (survey §III-D4), the port of the JAX
`core/hybrid.py`.

  * ClusCaPolicy — on refresh steps every token is computed and k-means
    clustered; on cached steps one representative token per cluster is
    computed through `subset_fn` and its fresh value propagated to its
    cluster by the gamma blend of Eq. 53-54.  Without a `subset_fn` (as
    under serving) the cached step is plain reuse.
  * SpeCaPolicy  — speculative Forecast-Then-Verify: a TaylorSeer draft
    (Eq. 55) checked by a verifier on a token probe (Eq. 56); a rejected
    draft rolls back to a full compute.  Without a verifier (as under
    serving) every draft is accepted: TaylorSeer with two more counters.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.forecast import forecast_basis

from .metrics import rel_l2
from .policy import CachePolicy, interval_pred, slot_mask
from .predictive import forecast_slots, update_diff_stack


def kmeans(tokens, k: int, iters: int = 5):
    """Deterministic fixed-iteration k-means over (..., T, D) tokens, each
    leading index clustered on its own.

    Returns (assign (..., T), centroids (..., k, D), reps (..., k)) where
    reps[i] is the token closest to centroid i; argmin takes the first
    minimum.  `k` is clamped to the token count."""
    T = tokens.shape[-2]
    k = min(k, T)
    idx0 = (torch.arange(k, device=tokens.device) * max(T // k, 1)) % T
    cent = tokens[..., idx0, :]

    def dist2(cent):
        return ((tokens[..., :, None, :] - cent[..., None, :, :]) ** 2).sum(-1)

    for _ in range(iters):
        onehot = F.one_hot(dist2(cent).argmin(-1), k).to(tokens.dtype)
        counts = onehot.sum(-2).clamp(min=1.0)
        cent = (onehot.transpose(-1, -2) @ tokens) / counts[..., None]
    d2 = dist2(cent)
    return d2.argmin(-1), cent, d2.argmin(-2)


class ClusCaPolicy(CachePolicy):
    """Cluster-driven feature caching over (..., T, D) token features."""

    name = "clusca"
    is_predictive = True

    def __init__(self, interval: int, k: int = 16, gamma: float = 0.7,
                 kmeans_iters: int = 5):
        self.interval = interval
        self.k = k
        self.gamma = float(gamma)
        self.kmeans_iters = kmeans_iters

    def _k(self, T: int) -> int:
        return min(self.k, T)

    def init_state(self, shape, dtype=torch.float32, *, device):
        T = shape[-2]
        i32 = dict(dtype=torch.int32, device=device)
        return {"cache": torch.zeros(shape, dtype=dtype, device=device),
                "assign": torch.zeros((*shape[:-2], T), **i32),
                "reps": torch.zeros((*shape[:-2], self._k(T)), **i32)}

    def _cluster(self, y):
        assign, _, reps = kmeans(y.float(), self._k(y.shape[-2]),
                                 self.kmeans_iters)
        return assign.to(torch.int32), reps.to(torch.int32)

    def apply(self, state, step, x, compute_fn,
              subset_fn: Optional[Callable] = None, **signals):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            assign, reps = self._cluster(y)
            return y, {"cache": y.to(state["cache"].dtype), "assign": assign,
                       "reps": reps}
        if subset_fn is None:
            return state["cache"].to(x.dtype), state
        T, D = x.shape[-2:]
        flat = zip(x.reshape(-1, T, D), state["cache"].reshape(-1, T, D),
                   state["assign"].reshape(-1, T).long(),
                   state["reps"].reshape(-1, state["reps"].shape[-1]).long())
        ys = []
        for x2, cache2, assign, reps in flat:
            y_reps = subset_fn(x2[reps])                      # (k, D)
            mu = y_reps[assign]                               # (T, D)
            y = self.gamma * mu + (1.0 - self.gamma) * cache2.to(mu.dtype)
            # freshly computed representatives are exact (one-hot blend)
            onehot = F.one_hot(reps, T).to(y.dtype)           # (k, T)
            is_rep = onehot.sum(0).clamp(0.0, 1.0)[:, None]
            ys.append(y * (1.0 - is_rep) + (onehot.T @ y_reps) * is_rep)
        y = torch.stack(ys).reshape(x.shape[:-2] + ys[0].shape)
        return y.to(x.dtype), {**state, "cache": y.to(state["cache"].dtype)}

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        cache = states["cache"]
        if not want.any():
            return cache.to(xs.dtype), states
        assign, reps = self._cluster(ys)
        m = slot_mask(want, cache)
        return torch.where(m, ys, cache.to(xs.dtype)), {
            "cache": torch.where(m, ys.to(cache.dtype), cache),
            "assign": torch.where(slot_mask(want, assign), assign,
                                  states["assign"]),
            "reps": torch.where(slot_mask(want, reps), reps, states["reps"])}

    def want_compute(self, state, step, x=None, **signals):
        # the partial branch never calls compute_fn (it uses subset_fn when
        # given), so the interval predicate is exact for serving
        return interval_pred(step, self.interval)

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]


class SpeCaPolicy(CachePolicy):
    """Speculative feature caching: TaylorSeer draft + probe verification.

    `subset_fn` maps a (P, D) probe-token subset through the module (the
    probe is a fixed stride of tokens); `signals["verify_fn"](x, y_hat)`
    is an external verifier returning the error.  With neither, every
    draft is accepted (pure TaylorSeer)."""

    name = "speca"
    is_predictive = True

    def __init__(self, interval: int, order: int = 2, tau: float = 0.1,
                 probe: int = 16):
        self.interval = interval
        self.order = order
        self.tau = float(tau)
        self.probe = probe

    def init_state(self, shape, dtype=torch.float32, *, device):
        i32 = dict(dtype=torch.int32, device=device)
        return {
            "diffs": torch.zeros((self.order + 1, *shape),
                                 dtype=torch.float32, device=device),
            "n_valid": torch.zeros((), **i32),
            "last_step": torch.zeros((), **i32),
            "accepts": torch.zeros((), **i32),
            "rejects": torch.zeros((), **i32),
        }

    def _probe_idx(self, T: int, device):
        stride = max(T // self.probe, 1)
        return torch.arange(self.probe, device=device) * stride % T

    def _verify_err(self, x, y_hat, subset_fn, verify_fn):
        if verify_fn is not None:
            return verify_fn(x, y_hat.to(x.dtype))
        T, D = x.shape[-2:]
        idx = self._probe_idx(T, x.device)
        errs = [rel_l2(yh2[idx], subset_fn(x2[idx]))
                for x2, yh2 in zip(x.reshape(-1, T, D),
                                   y_hat.reshape(-1, T, D))]
        return torch.stack(errs).max()

    def apply(self, state, step, x, compute_fn,
              subset_fn: Optional[Callable] = None, **signals):
        def full():
            y = compute_fn(x)
            return y, {**state,
                       "diffs": update_diff_stack(state["diffs"], y),
                       "n_valid": state["n_valid"] + 1,
                       "last_step": torch.full_like(state["last_step"], step)}

        if interval_pred(step, self.interval):
            return full()
        y_hat = forecast_basis(state["diffs"], step, state["last_step"],
                               state["n_valid"], self.interval, "taylor")
        verify_fn = signals.get("verify_fn")
        if subset_fn is None and verify_fn is None:
            return y_hat.to(x.dtype), state
        if bool(self._verify_err(x, y_hat, subset_fn, verify_fn) <= self.tau):
            return y_hat.to(x.dtype), {**state,
                                       "accepts": state["accepts"] + 1}
        y, new = full()
        return y, {**new, "rejects": state["rejects"] + 1}

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        y, upd = forecast_slots(states, steps, ys, want, self.interval,
                                "taylor", 0.5, xs.dtype)
        return y, {**states, **upd}

    def want_compute(self, state, step, x=None, subset_fn=None, **signals):
        if subset_fn is None and signals.get("verify_fn") is None:
            # accept-always: a draft never calls compute_fn
            return interval_pred(step, self.interval)
        # a rejected draft rolls back to a full compute at any step
        return True

    def static_schedule(self, num_steps: int):
        return [s % self.interval == 0 for s in range(num_steps)]
