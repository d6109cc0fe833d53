"""Cache engine of the port: binds policies to modules and to serving slots
(the JAX `core/engine.py`).  Block-granularity stacks (CachedStack,
DBCacheStack) are not ported yet (ROADMAP.md §A)."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .policy import CachePolicy

State = Dict[str, Any]


class CachedModule:
    """A module fn wrapped with a cache policy; fn: (x, *args) -> y."""

    def __init__(self, fn: Callable, policy: CachePolicy):
        self.fn = fn
        self.policy = policy

    def init(self, shape, dtype=torch.float32, *, device):
        return self.policy.init_state(shape, dtype, device=device)

    def __call__(self, state, step: int, x, *args):
        return self.policy.apply(state, step, x, lambda xx: self.fn(xx, *args))


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class SlotBatchedPolicy:
    """A cache policy whose state carries a leading *slot* axis.

    The serving engine runs many requests, each at its own denoising step,
    through one batched pass; each slot keeps its own cache state (the
    policy's `apply_slots` steps every slot at once).  This wrapper makes
    the fresh per-slot state (`stack_slots` broadcasts it to the pool) and
    resets a single slot in place when the scheduler refills it — slot
    reuse must never leak cache state between requests."""

    def __init__(self, policy: CachePolicy, slots: int):
        self.policy = policy
        self.slots = slots

    def init_slot_state(self, shape, dtype=torch.float32, *,
                        signal_shape=None, device) -> State:
        """One slot's fresh state (also the reset target); a policy that
        tracks an input signal (TeaCache) keeps it at `signal_shape`."""
        if self.policy.uses_signal:
            return self.policy.init_state(shape, dtype, device=device,
                                          signal_shape=signal_shape)
        return self.policy.init_state(shape, dtype, device=device)

    def want_compute(self, states: State, steps, xs, signal=None):
        """Every slot's decision on the device (`SlotWant`: (S,) want and
        metric, the thresholded value, its threshold, forced)."""
        return self.policy.want_slots(states, steps, xs, signal)

    @staticmethod
    def reset_slot(states: State, slot: int, fresh: State) -> None:
        """Overwrite slot `slot`'s state with `fresh`, in place."""
        for k, v in states.items():
            if isinstance(v, dict):
                SlotBatchedPolicy.reset_slot(v, slot, fresh[k])
            else:
                v[slot].copy_(fresh[k])


def stack_slots(one: State, slots: int) -> State:
    """A per-slot state broadcast to `slots` independent copies."""
    return _map(lambda a: a[None].expand((slots,) + tuple(a.shape)).clone(),
                one)


def cache_state_bytes(state: State) -> int:
    """Total bytes held by a cache state tree."""
    total = 0
    for v in state.values():
        total += (cache_state_bytes(v) if isinstance(v, dict)
                  else v.numel() * v.element_size())
    return int(total)
