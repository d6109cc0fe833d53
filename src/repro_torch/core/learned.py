"""Learning-based caching (survey §III-D1/D2): LazyDiT and HarmoniCa-style
stepwise training — the port of the JAX `core/learned.py`.

LazyDiT (Eq. 26-27) puts a linear predictor in front of the gated module:
it estimates the similarity between this step's output and the cached one
from the mean input token, and the module is skipped when the predicted
similarity clears a threshold.

`train_lazy_gate` trains the gate on FULL trajectories against the exact
teacher trajectory (HarmoniCa's insight: sampling random single steps hides
the error accumulation the gate faces at inference), with the lazy loss's
balance between output match and skip reward.  The rollout is a Python loop
under torch autograd and the update is plain SGD, `p <- p - lr * g`, as in
JAX; the returned gate is detached, so serving it records no graph.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import to_device

from .adaptive import GatedPolicy, _full, _zeros


def init_gate(generator: torch.Generator, feat_dim: int, device=None):
    """Linear similarity predictor params:
    s = sigmoid(<w, mean_tokens(x)> + b), w drawn from `generator` on its
    own device and moved to `device` (default: the generator's), so one
    generator gives the same gate on every device."""
    w = torch.randn((feat_dim,), generator=generator,
                    device=generator.device) * 0.01
    w = w.to(device if device is not None else generator.device)
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
            self._on[device] = {k: to_device(v, device)
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


def lazy_trajectory_loss(gate, inputs: torch.Tensor, outputs: torch.Tensor,
                         *, rho: float = 0.1, threshold: float = 0.5):
    """HarmoniCa-style full-trajectory objective.

    inputs/outputs: (T, ..., D) module inputs and exact outputs along one
    denoising trajectory.  Simulates the gated rollout with a *soft* skip
    decision (the sigmoid score, differentiable), carrying the cache
    exactly as inference would, and returns
        L = mean_t || y_hat_t - y_t ||^2  -  rho * mean_t s_t      (Eq. 27)
    where y_hat_t = s_t * cache + (1 - s_t) * y_t and the cache carried to
    the next step is y_hat_t.  `threshold` is unused, as in JAX."""
    del threshold
    cache = outputs[0].float()
    errs, skips = [], []
    for t in range(1, inputs.shape[0]):
        y_t = outputs[t].float()
        s = gate_score(gate, inputs[t])
        y_hat = s * cache + (1.0 - s) * y_t
        cache = y_hat
        errs.append(torch.mean((y_hat - y_t) ** 2))
        skips.append(s)
    return torch.stack(errs).mean() - rho * torch.stack(skips).mean()


def _sgd(gate, loss_fn, steps: int, lr: float) -> Tuple[Dict, List[float]]:
    """`steps` plain SGD updates of the gate's leaves on loss_fn(gate):
    (detached gate, loss history).  The history is read back once, at the
    end."""
    g = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in gate.items()}
    losses = []
    for _ in range(steps):
        loss = loss_fn(g)
        grads = torch.autograd.grad(loss, list(g.values()))
        with torch.no_grad():
            for p, gr in zip(g.values(), grads):
                p -= lr * gr
        losses.append(loss.detach())
    # repro-lint: disable-next-line=host-sync-in-hot-path -- gate training, once after the loop: the loss history in one copy
    hist = (torch.stack(losses).cpu().tolist() if losses else [])
    return {k: v.detach() for k, v in g.items()}, hist


def train_lazy_gate(generator: torch.Generator, inputs, outputs, *,
                    steps: int = 200, lr: float = 0.05, rho: float = 0.1):
    """Fit the gate on one exact trajectory (inputs/outputs (T, ..., D)),
    from `init_gate(generator, D)`.  Returns (gate, loss_history)."""
    gate = init_gate(generator, inputs.shape[-1], device=inputs.device)
    return _sgd(gate, lambda g: lazy_trajectory_loss(g, inputs, outputs,
                                                     rho=rho), steps, lr)
