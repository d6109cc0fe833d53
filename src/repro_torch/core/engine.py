"""Cache engine of the port: binds policies to modules, to layer stacks
and to serving slots (the JAX `core/engine.py`).

Granularities (survey Fig. 2 "reuse granularity" axis):

  * MODEL  — one policy gates the whole backbone forward (CachedModule;
    the diffusion pipeline's default).
  * BLOCK  — one policy state per transformer block, threaded through a
    Python loop over the layers (CachedStack).
  * MODULE — separate policies per module type (PAB's ranges; the
    factorized video stack is repro_torch.core.temporal.TemporalPABStack).

DeepCache is a structural composition at this level (the shallow blocks
always compute, the deep section is gated as one unit: see
repro_torch.diffusion.pipeline), and DBCacheStack below owns the layer
loop itself (probe -> decide -> correct).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from .metrics import rel_l1_block
from .policy import CachePolicy

State = Dict[str, Any]


def layer_params(stacked: State, i: int) -> State:
    """Layer i's params out of a tree whose leaves carry a leading layer
    axis (the JAX layout of `blocks`)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def layer_list(stacked: State) -> List[State]:
    """Every layer's params (`layer_params` for each i), from one unbind
    per leaf: the same views, but under autograd each stacked leaf gets one
    stack of its layers' gradients, where a select per layer adds a
    zero-filled full-size gradient per layer."""
    per_leaf = {k: layer_list(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in stacked.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


class CachedModule:
    """A module fn wrapped with a cache policy; fn: (x, *args) -> y."""

    def __init__(self, fn: Callable, policy: CachePolicy):
        self.fn = fn
        self.policy = policy

    def init(self, shape, dtype=torch.float32, *, device):
        return self.policy.init_state(shape, dtype, device=device)

    def __call__(self, state, step: int, x, *args):
        return self.policy.apply(state, step, x, lambda xx: self.fn(xx, *args))


class CachedStack:
    """A Python loop over L blocks, each block's output gated by `policy`
    with a state of its own.

    block_fn: (layer_params, x, *args) -> y (same shape as x); params are
    stacked on a leading layer axis.  States are a list with one policy
    state per layer.  A state-dependent policy decides through its scalar
    `apply`, which reads its decision back: one sync per layer per step
    (acceptable on the denoiser path; the serving engine never takes it)."""

    def __init__(self, block_fn: Callable, policy: CachePolicy,
                 num_layers: int):
        self.block_fn = block_fn
        self.policy = policy
        self.num_layers = num_layers

    def init(self, shape, dtype=torch.float32, *, device) -> List[State]:
        return [self.policy.init_state(shape, dtype, device=device)
                for _ in range(self.num_layers)]

    def __call__(self, states: Sequence[State], step: int, x, stacked_params,
                 *args):
        new_states = []
        for i, state in enumerate(states):
            p = layer_params(stacked_params, i)
            x, state = self.policy.apply(
                state, step, x, lambda xx, p=p: self.block_fn(p, xx, *args))
            new_states.append(state)
        return x, new_states


class DBCacheStack:
    """DBCache (survey §III-D2): probe -> decide -> correct.

    The first `front_n` blocks always compute and act as the probe: the
    rel-L1 between the probe output and the previous step's probe output
    decides whether the middle section reuses its cached output.  The last
    `back_n` blocks always compute (the corrector).  Where JAX branches
    with `lax.cond` on the device, the port reads the refresh flag back to
    the host, once a step, and runs only the branch taken."""

    def __init__(self, block_fn: Callable, num_layers: int, front_n: int = 2,
                 back_n: int = 2, threshold: float = 0.05):
        if front_n + back_n >= num_layers:
            raise ValueError(f"front_n + back_n = {front_n + back_n} leaves no "
                             f"middle section of {num_layers} layers")
        self.block_fn = block_fn
        self.num_layers = num_layers
        self.front_n = front_n
        self.back_n = back_n
        self.threshold = float(threshold)

    def init(self, shape, dtype=torch.float32, *, device) -> State:
        return {
            "mid_cache": torch.zeros(shape, dtype=dtype, device=device),
            "prev_probe": torch.zeros(shape, dtype=torch.float32,
                                      device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _run_range(self, x, stacked_params, lo, hi, *args):
        for i in range(lo, hi):
            x = self.block_fn(layer_params(stacked_params, i), x, *args)
        return x

    def __call__(self, state: State, step: int, x, stacked_params, *args):
        L, F, B = self.num_layers, self.front_n, self.back_n
        probe = self._run_range(x, stacked_params, 0, F, *args)
        probe_f = probe.float()
        change = rel_l1_block(probe_f, state["prev_probe"])
        # the step's one host read
        # repro-lint: disable-next-line=host-sync-in-hot-path -- priced: DBCache's one read a step (single-trajectory path, not a serving tick)
        refresh = bool(torch.logical_or(state["n"] == 0,
                                        change > self.threshold))
        cache = state["mid_cache"]
        if refresh:
            mid = self._run_range(probe, stacked_params, F, L - B, *args)
            cache = mid.to(cache.dtype)
        else:
            mid = cache.to(probe.dtype)
        y = self._run_range(mid, stacked_params, L - B, L, *args)
        return y, {"mid_cache": cache, "prev_probe": probe_f,
                   "n": state["n"] + 1}


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


def compute_fraction(schedule: Sequence[bool]) -> float:
    """Fraction of steps doing full computation; the survey's acceleration
    factor is ~ 1/compute_fraction (its O(T/m) claim, §III-B)."""
    schedule = list(schedule)
    return sum(map(bool, schedule)) / max(len(schedule), 1)
