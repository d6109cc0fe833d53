"""Learning-based caching (survey §III-D1/D2): LazyDiT inference — the
port of the JAX `core/learned.py`.

LazyDiT (Eq. 26-27) puts a linear predictor in front of the gated module:
it estimates the similarity between this step's output and the cached one
from the mean input token, and the module is skipped when the predicted
similarity clears a threshold.  Training the gate (`lazy_trajectory_loss`,
`train_lazy_gate`) is not ported yet (ROADMAP.md §A.5).
"""
from __future__ import annotations

import torch

from .adaptive import GatedPolicy, _full, _zeros


def init_gate(generator: torch.Generator, feat_dim: int, device=None):
    """Linear similarity predictor params:
    s = sigmoid(<w, mean_tokens(x)> + b), w drawn from `generator`."""
    w = torch.randn((feat_dim,), generator=generator,
                    device=device or generator.device) * 0.01
    return {"w": w, "b": torch.zeros((), device=w.device)}


def gate_score(gate, x):
    """Predicted cross-step similarity in [0, 1].  x: (..., T, D)."""
    z = x.float().reshape(-1, x.shape[-1]).mean(0)
    return torch.sigmoid(torch.dot(gate["w"].float(), z) + gate["b"].float())


def gate_score_slots(gate, xs):
    """(S,) gate scores: each slot's mean over every axis but the last."""
    z = xs.float().reshape(xs.shape[0], -1, xs.shape[-1]).mean(1)
    return torch.sigmoid(z @ gate["w"].float() + gate["b"].float())


class LazyDiTPolicy(GatedPolicy):
    """Skip the module when the learned gate predicts similarity above the
    threshold (compute when it is at or below it)."""

    name = "lazydit"

    def __init__(self, gate, threshold: float = 0.5):
        self.gate = gate
        self.threshold = float(threshold)
        self._on = {}

    def _gate(self, device):
        """The gate's tensors on `device`, copied there once."""
        if device not in self._on:
            self._on[device] = {k: torch.as_tensor(v).to(device)
                                for k, v in self.gate.items()}
        return self._on[device]

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {"cache": _zeros(shape, device, dtype),
                "n": _zeros((), device, torch.int32),
                "n_compute": _zeros((), device, torch.int32)}

    def gate_slots(self, states, steps, xs, signal=None):
        sim = gate_score_slots(self._gate(xs.device), xs)
        return states["n"] == 0, sim, _full(sim, self.threshold)

    def _cmp(self, value, threshold):
        return value <= threshold

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        want = self._slot_want(states, steps, xs, signal, want)
        cache = states["cache"]
        m, mi = self._masks(want, states)
        new = {"n": states["n"] + 1,
               "n_compute": states["n_compute"] + mi}
        y, new["cache"] = self._cached(want, m, cache, xs, ys)
        return y, new
