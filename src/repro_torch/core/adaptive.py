"""Timestep-adaptive and layer-adaptive caching policies (survey
§III-D1/D2) — the port of the JAX `core/adaptive.py`.

  * TeaCachePolicy   — rel-L1 of the timestep-modulated input, polynomial
    corrected, accumulated until threshold delta (Eq. 22-24).
  * MagCachePolicy   — accumulated magnitude-decay error 1 - prod(gamma_i)
    against an analytic (or given) gamma curve (Eq. 29-30).
  * EasyCachePolicy  — online transformation-rate gate (Eq. 31-33).
  * BlockCachePolicy — a static schedule from a calibration profile of
    rel-L1 changes (Eq. 34-35), recomputing past the profile's end.
  * ForesightPolicy  — warm-up-estimated threshold, then online input-change
    gating (Eq. 40-41).

All but BlockCache decide from their state: each computes a `gate` per slot
(a forced compute, the value it thresholds, the threshold), from which
`want_slots` forms the decision on the device.  The state layout and dtypes
are JAX's leaf for leaf, so `cache_state_bytes` agrees.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.device import to_device

from .metrics import l2_slots, rel_l1_block_slots, rel_l1_slots
from .policy import (CachePolicy, SlotWant, slot_mask, table_at,
                     unsqueeze_state)


def _zeros(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


def _full(like, value):
    return torch.full(like.shape, value, dtype=torch.float32,
                      device=like.device)


class GatedPolicy(CachePolicy):
    """A policy that computes when its state forces it or when a value
    crosses a threshold: want = force | (value cmp threshold)."""

    def gate_slots(self, states, steps, xs, signal=None):
        """(force, value, threshold), each (S,) on xs' device."""
        raise NotImplementedError

    def _cmp(self, value, threshold):
        return value >= threshold

    def _metric(self, value):
        """JAX's `want_metric` from the gate's value."""
        return value

    def want_slots(self, states, steps, xs, signal=None) -> SlotWant:
        force, value, thr = self.gate_slots(states, steps, xs, signal)
        want = torch.logical_or(force, self._cmp(value, thr))
        return SlotWant(want, self._metric(value), value, thr, force)

    def _one(self, state, step, x, signals):
        sig = signals.get("signal")
        return self.want_slots(unsqueeze_state(state), np.array([step]),
                               x[None], None if sig is None else sig[None])

    def want_compute(self, state, step, x=None, **signals):
        """0-d bool tensor: would `apply` take its compute branch?"""
        return self._one(state, step, x, signals).want[0]

    def want_metric(self, state, step, x=None, **signals):
        return self._one(state, step, x, signals).metric[0]

    def apply(self, state, step, x, compute_fn, **signals):
        return self._apply_as_slot(state, step, x, compute_fn,
                                   signals.get("signal"))

    @staticmethod
    def _masks(want, states):
        """The host decision as an (S,) device mask and its int32 form."""
        m = to_device(want, states["n"].device, torch.bool)
        return m, m.to(torch.int32)

    @staticmethod
    def _cached(want, m, cache, xs, ys):
        """(output, new cache): the fresh rows where a slot computes, the
        cache elsewhere."""
        y = cache.to(xs.dtype)
        if not want.any():
            return y, cache
        m = slot_mask(m, cache)
        return torch.where(m, ys, y), torch.where(m, ys.to(cache.dtype), cache)


class TeaCachePolicy(GatedPolicy):
    """TeaCache: accumulate the corrected input-side change until it
    crosses delta.  The signal is the timestep-embedding-modulated input
    (AdaLN of the first block); without one, x itself.  `poly` are the
    correction-polynomial coefficients (Eq. 23), lowest order first."""

    name = "teacache"
    uses_signal = True

    def __init__(self, delta: float, poly: Sequence[float] = (0.0, 1.0)):
        self.delta = float(delta)
        self.poly = tuple(float(p) for p in poly)

    def init_state(self, shape, dtype=torch.float32, *, device,
                   signal_shape=None):
        return {
            "cache": _zeros(shape, device, dtype),
            "prev_signal": _zeros(signal_shape or shape, device),
            "acc": _zeros((), device),
            "n": _zeros((), device, torch.int32),
            "n_compute": _zeros((), device, torch.int32),
        }

    def _correct(self, d):
        out = torch.zeros_like(d)
        for i, a in enumerate(self.poly):
            out = out + a * d**i
        return out

    def _signal_distance(self, sig, prev):
        """(S,) input-side change per slot (Eq. 22); temporal subclasses
        override it."""
        return rel_l1_slots(sig, prev)

    def _acc(self, states, xs, signal):
        sig = (xs if signal is None else signal).float()
        d = self._correct(self._signal_distance(sig, states["prev_signal"]))
        return sig, states["acc"] + d

    def gate_slots(self, states, steps, xs, signal=None):
        _, acc = self._acc(states, xs, signal)
        return states["n"] == 0, acc, _full(acc, self.delta)

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        sig, acc = self._acc(states, xs, signal)
        cache = states["cache"]
        m, mi = self._masks(want, states)
        new = {"prev_signal": sig, "n": states["n"] + 1,
               "n_compute": states["n_compute"] + mi,
               "acc": torch.where(m, torch.zeros_like(acc), acc)}
        y, new["cache"] = self._cached(want, m, cache, xs, ys)
        return y, new


class MagCachePolicy(GatedPolicy):
    """MagCache: accumulated error eps(t) = 1 - prod(gamma_i) since the
    last refresh (Eq. 30); gamma is the per-step residual-magnitude ratio
    curve, the analytic default unless one is given."""

    name = "magcache"

    def __init__(self, delta: float, gammas: Sequence[float] | None = None,
                 num_steps: int = 50):
        self.delta = float(delta)
        if gammas is None:
            # magnitude ratio decays towards 1 late in sampling (unified
            # amplitude decay law, survey Eq. 29-30)
            t = np.arange(num_steps)
            gammas = 1.0 - 0.05 * np.exp(-3.0 * t / max(num_steps - 1, 1))
        self.gammas = np.asarray(gammas, np.float32)
        self._gammas_on = {}

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {
            "cache": _zeros(shape, device, dtype),
            "prod": torch.ones((), dtype=torch.float32, device=device),
            "n": _zeros((), device, torch.int32),
            "n_compute": _zeros((), device, torch.int32),
        }

    def _prod(self, states, steps):
        g = table_at(self.gammas, steps, states["prod"].device,
                     self._gammas_on)
        return states["prod"] * g

    def gate_slots(self, states, steps, xs, signal=None):
        err = 1.0 - self._prod(states, steps)
        return states["n"] == 0, err, _full(err, self.delta)

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        prod = self._prod(states, steps)
        cache = states["cache"]
        m, mi = self._masks(want, states)
        new = {"n": states["n"] + 1,
               "prod": torch.where(m, torch.ones_like(prod), prod),
               "n_compute": states["n_compute"] + mi}
        y, new["cache"] = self._cached(want, m, cache, xs, ys)
        return y, new


class EasyCachePolicy(GatedPolicy):
    """EasyCache: local-linearity gate.  On refresh, store the
    transformation vector Delta = v - x (Eq. 32) and rate k (Eq. 31); on
    skipped steps approximate v = x + Delta and accumulate the deviation
    estimate eps_n = k ||x_n - x_n-1|| / ||v_n-1|| (Eq. 33) until tau."""

    name = "easycache"

    def __init__(self, tau: float, warmup: int = 2):
        self.tau = float(tau)
        self.warmup = warmup

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {
            "delta": _zeros(shape, device),
            "k": _zeros((), device),
            "prev_x": _zeros(shape, device),
            "prev_v": _zeros(shape, device),
            "acc": _zeros((), device),
            "n": _zeros((), device, torch.int32),
            "n_compute": _zeros((), device, torch.int32),
        }

    def _acc(self, states, xs):
        xf = xs.float()
        dx = l2_slots(xf - states["prev_x"])
        v_norm = l2_slots(states["prev_v"]) + 1e-8
        return xf, dx, states["acc"] + states["k"] * dx / v_norm * 100.0

    def gate_slots(self, states, steps, xs, signal=None):
        _, _, acc = self._acc(states, xs)
        return states["n"] < self.warmup, acc, _full(acc, self.tau)

    def _metric(self, value):
        return torch.zeros_like(value)     # JAX's base want_metric

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        xf, dx, acc = self._acc(states, xs)
        m, mi = self._masks(want, states)
        v_hat = xf + states["delta"]
        new = {"delta": states["delta"], "k": states["k"], "prev_x": xf,
               "prev_v": v_hat, "n": states["n"] + 1,
               "acc": torch.where(m, torch.zeros_like(acc), acc),
               "n_compute": states["n_compute"] + mi}
        y = v_hat.to(xs.dtype)
        if want.any():
            m3 = slot_mask(m, xf)
            yf = ys.float()
            k = l2_slots(yf - states["prev_v"]) / (dx + 1e-8)
            y = torch.where(m3, ys, y)
            new.update(delta=torch.where(m3, yf - xf, states["delta"]),
                       k=torch.where(m, k, states["k"]),
                       prev_v=torch.where(m3, yf, v_hat))
        return y, new


class BlockCachePolicy(CachePolicy):
    """Layer-adaptive static scheduling from a calibration profile.

    `profile[t]` is the measured rel-L1 change between steps t-1 and t
    (Eq. 34); the schedule recomputes whenever the cumulative change since
    the last refresh exceeds delta (Eq. 35).  Steps beyond the profile
    recompute (recompute-on-overflow).  The schedule is a host table: the
    serving engine plans it with no device round trip."""

    name = "blockcache"

    def __init__(self, profile: Sequence[float], delta: float):
        self.profile = [float(p) for p in profile]
        self.delta = float(delta)
        self._schedule = self._build_schedule()

    def _build_schedule(self) -> List[bool]:
        sched, acc = [], 0.0
        for t, change in enumerate(self.profile):
            if t == 0:
                sched.append(True)
                acc = 0.0
                continue
            acc += change
            if acc > self.delta:
                sched.append(True)
                acc = 0.0
            else:
                sched.append(False)
        return sched

    def _sched_at(self, step: int) -> bool:
        return self._schedule[step] if step < len(self._schedule) else True

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {"cache": _zeros(shape, device, dtype),
                "sched": torch.as_tensor(self._schedule, dtype=torch.bool,
                                         device=device)}

    def apply(self, state, step, x, compute_fn, **signals):
        if self._sched_at(int(step)):
            y = compute_fn(x)
            return y, {**state, "cache": y.to(state["cache"].dtype)}
        return state["cache"].to(x.dtype), state

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        cache = states["cache"]
        if not want.any():
            return cache.to(xs.dtype), states
        m = slot_mask(want, cache)
        return torch.where(m, ys, cache.to(xs.dtype)), {
            **states, "cache": torch.where(m, ys.to(cache.dtype), cache)}

    def want_compute(self, state, step, x=None, **signals):
        return self._sched_at(int(step))

    def static_schedule(self, num_steps: int):
        if num_steps <= len(self._schedule):
            return self._schedule[:num_steps]
        return self._schedule + [True] * (num_steps - len(self._schedule))


class ForesightPolicy(GatedPolicy):
    """Foresight: always compute during the first `warmup` steps, keeping
    an exponentially weighted estimate lambda of the input change (Eq. 40);
    afterwards reuse while the input change stays at or below gamma *
    lambda (Eq. 41)."""

    name = "foresight"

    def __init__(self, gamma: float = 1.0, warmup: int = 3):
        self.gamma = float(gamma)
        self.warmup = warmup

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {
            "cache": _zeros(shape, device, dtype),
            "prev_in": _zeros(shape, device),
            "lam": _zeros((), device),
            "n": _zeros((), device, torch.int32),
            "n_compute": _zeros((), device, torch.int32),
        }

    def gate_slots(self, states, steps, xs, signal=None):
        delta = rel_l1_block_slots(xs.float(), states["prev_in"])
        return (states["n"] < self.warmup, delta,
                self.gamma * states["lam"])

    def _cmp(self, value, threshold):
        return value > threshold

    def _metric(self, value):
        return torch.zeros_like(value)     # JAX's base want_metric

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        xf = xs.float()
        delta = rel_l1_block_slots(xf, states["prev_in"])
        lam = torch.where(states["n"] == 0, delta,
                          0.9 * states["lam"] + 0.1 * delta)
        cache = states["cache"]
        m, mi = self._masks(want, states)
        new = {"prev_in": xf,
               "lam": torch.where(m, lam, states["lam"]),
               "n": states["n"] + 1, "n_compute": states["n_compute"] + mi}
        y, new["cache"] = self._cached(want, m, cache, xs, ys)
        return y, new

