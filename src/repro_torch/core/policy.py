"""Cache policy protocol (survey Eq. 14-15), the port of the JAX
`core/policy.py`.

A policy is a stateless object holding static hyper-parameters; the cache
lives in a dict of tensors `state` threaded through the calls.  Two ways
to drive it:

    y, state = policy.apply(state, step, x, compute_fn)
        one trajectory at a Python-int `step`: only the chosen branch runs
        (the JAX package's static scheduling).
    ys, states = policy.apply_slots(states, steps, xs, ys_computed)
        many serving slots at once: every state leaf carries a leading slot
        axis, `steps` is a host (S,) int array, and `ys_computed` holds each
        slot's fresh backbone output (zeros where none was gathered).  Each
        slot keeps its own branch's output and state, selected by masks over
        the slot axis — what `lax.cond` under `vmap` does in JAX, where both
        branches are evaluated.  A branch that no slot takes is not run.

The ported policies decide from the step alone, so `want_compute` is a
host-side predicate and needs no device round trip.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

ComputeFn = Callable[[torch.Tensor], torch.Tensor]


def interval_pred(step, interval: int):
    """The shared `step % interval == 0` compute predicate: a bool for an
    int step, a bool array for an array of steps."""
    if isinstance(step, (int, np.integer)):
        return int(step) % interval == 0
    return np.asarray(step) % interval == 0


def slot_mask(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """(S,) host bool mask -> device bool tensor broadcastable to `like`."""
    m = torch.as_tensor(np.asarray(mask, bool), device=like.device)
    return m.view((-1,) + (1,) * (like.dim() - 1))


class CachePolicy:
    """Base class; subclasses implement init_state/apply/apply_slots."""

    name: str = "base"
    is_predictive: bool = False
    #: does apply() threshold on a TeaCache-style input signal?
    uses_signal: bool = False

    def init_state(self, shape, dtype=torch.float32, *,
                   device) -> Dict[str, Any]:
        raise NotImplementedError

    def apply(self, state, step: int, x, compute_fn: ComputeFn):
        raise NotImplementedError

    def apply_slots(self, states, steps: np.ndarray, xs, ys):
        raise NotImplementedError

    def want_compute(self, state, step, x=None):
        """Would `apply` take its compute branch at `step`?"""
        return True

    def want_metric(self, state, step, x=None) -> float:
        """The signal the refresh decision thresholds on (0 for
        schedule-only policies)."""
        return 0.0

    def static_schedule(self, num_steps: int):
        """list[bool] (compute?) if statically schedulable, else None."""
        return None

    def __repr__(self):  # pragma: no cover - debug aid
        return f"{type(self).__name__}()"


class NoCachePolicy(CachePolicy):
    """Always compute — the exact baseline."""

    name = "none"

    def init_state(self, shape, dtype=torch.float32, *, device):
        return {}

    def apply(self, state, step, x, compute_fn):
        return compute_fn(x), state

    def apply_slots(self, states, steps, xs, ys):
        return ys, states

    def static_schedule(self, num_steps: int):
        return [True] * num_steps
