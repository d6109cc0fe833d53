"""Cache policy protocol (survey Eq. 14-15), the port of the JAX
`core/policy.py`.

A policy is a stateless object holding static hyper-parameters; the cache
lives in a dict of tensors `state` threaded through the calls.  Two ways
to drive it:

    y, state = policy.apply(state, step, x, compute_fn, **signals)
        one trajectory at a Python-int `step`: only the chosen branch runs
        (the JAX package's static scheduling).  `signals` ride along as in
        JAX: `signal` (TeaCache's modulated input), `subset_fn`,
        `verify_fn` (ClusCa / ToCa / SpeCa token paths).
    ys, states = policy.apply_slots(states, steps, xs, ys_computed, *,
                                    want=None, signal=None)
        many serving slots at once: every state leaf carries a leading slot
        axis, `steps` is a host (S,) int array, and `ys_computed` holds each
        slot's fresh backbone output (zeros where none was gathered).
        `want` is the plan's host (S,) compute decision per slot and
        `signal` the (S, ...) signal the plan computed.  Under the serving
        engine `steps` and `want` arrive as `repro_torch.device.Staged`
        values (host array + static device buffer): device code reads the
        buffer, so a captured tick replays on the inputs of the tick that
        replays it, and the host branches (`want.any()`, `want.all()`)
        are the engine's program key.  Each slot keeps its
        own branch's output and state, selected by masks over the slot
        axis — what `lax.cond` under `vmap` does in JAX, where both branches
        are evaluated.  A branch that no slot takes is not run; that is
        decided from the host `want`, so it costs no device round trip.

Planning.  A policy whose `want_compute(None, step, None)` answers for
every step decides from the step alone: the engine plans it on the host.
The others (TeaCache, MagCache, EasyCache, Foresight, LazyDiT) threshold a
quantity of their state; `want_slots` computes every slot's decision and
metric on the device, and the engine reads them back once a tick.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import Staged, to_device

ComputeFn = Callable[[torch.Tensor], torch.Tensor]


class SlotWant(NamedTuple):
    """Every slot's decision, as (S,) tensors on the slots' device."""
    want: torch.Tensor       # bool: take the compute branch
    metric: torch.Tensor     # f32: the JAX `want_metric`
    value: torch.Tensor      # f32: the quantity the decision thresholds
    threshold: torch.Tensor  # f32: its threshold
    forced: torch.Tensor     # bool: decided without the threshold


def interval_pred(step, interval: int):
    """The shared `step % interval == 0` compute predicate: a bool for an
    int step, a bool array for an array of steps, a Staged mask (host and
    device) for Staged steps."""
    if isinstance(step, (int, np.integer)):
        return int(step) % interval == 0
    if isinstance(step, Staged):
        return step.derive(step.host % interval == 0,
                           step.dev % interval == 0, interval)
    return np.asarray(step) % interval == 0


def table_at(table: np.ndarray, steps, device, cache: Dict) -> torch.Tensor:
    """table[clip(steps)] on `device`: a host gather for host steps; for
    Staged steps a device gather from the table's device copy (kept in
    `cache`, made on first use), so a captured program reads the steps of
    the tick that replays it."""
    n = len(table)
    if not isinstance(steps, Staged):
        return to_device(table[np.clip(np.asarray(steps), 0, n - 1)], device)
    dev = cache.get(device)
    if dev is None:
        dev = cache[device] = to_device(table, device)
    return dev[steps.dev.long().clamp(0, n - 1)]


def static_plan(policy, num_steps: int) -> Optional[np.ndarray]:
    """`want_compute(None, s, None)` for every step s < num_steps, or None
    when the policy cannot answer without its state or x (any exception
    counts, as in JAX): the probe rule by which the serving engine plans a
    policy on the host, with no device round trip."""
    try:
        return np.asarray([bool(policy.want_compute(None, s, None))
                           for s in range(num_steps)], bool)
    except Exception:
        return None


def slot_mask(mask, like: torch.Tensor) -> torch.Tensor:
    """(S,) host bool mask (or device bool tensor) -> device bool tensor
    broadcastable to `like`."""
    if isinstance(mask, Staged):
        m = mask.dev
    elif torch.is_tensor(mask):
        m = mask.to(like.device)
    else:
        m = to_device(np.asarray(mask, bool), like.device)
    return m.view((-1,) + (1,) * (like.dim() - 1))


def unsqueeze_state(state):
    """One trajectory's state as a 1-slot batch."""
    return {k: unsqueeze_state(v) if isinstance(v, dict) else v[None]
            for k, v in state.items()}


def squeeze_state(states):
    return {k: squeeze_state(v) if isinstance(v, dict) else v[0]
            for k, v in states.items()}


class CachePolicy:
    """Base class; subclasses implement init_state/apply/apply_slots."""

    name: str = "base"
    is_predictive: bool = False
    #: does apply() threshold on a TeaCache-style input signal?
    uses_signal: bool = False

    def init_state(self, shape, dtype=torch.float32, *,
                   device) -> Dict[str, Any]:
        raise NotImplementedError

    def apply(self, state, step: int, x, compute_fn: ComputeFn, **signals):
        raise NotImplementedError

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        raise NotImplementedError

    def want_compute(self, state, step, x=None, **signals):
        """Would `apply` take its compute branch at `step`?"""
        return True

    def want_metric(self, state, step, x=None, **signals):
        """The signal the refresh decision thresholds on (0 for
        schedule-only policies)."""
        return 0.0

    def step_want(self, steps) -> np.ndarray:
        """(S,) host compute decisions of a policy that decides from the
        step alone (raises for one that needs its state)."""
        return np.asarray([bool(self.want_compute(None, int(s), None))
                           for s in np.asarray(steps).reshape(-1)], bool)

    def want_slots(self, states, steps, xs, signal=None) -> SlotWant:
        """Every slot's decision on xs' device; a schedule-only policy's
        are all forced (no threshold: zeros)."""
        want = to_device(self.step_want(steps), xs.device)
        z = torch.zeros(want.shape, dtype=torch.float32, device=xs.device)
        return SlotWant(want, z, z, z, torch.ones_like(want))

    def _slot_want(self, states, steps, xs, signal, want) -> np.ndarray:
        """The plan's host decision (a Staged one passes through), or,
        called without one, this policy's own (one device read for a
        state-dependent policy)."""
        if isinstance(want, Staged):
            return want
        if want is not None:
            return np.asarray(want, bool).reshape(-1)
        w = self.want_slots(states, steps, xs, signal).want
        return w.cpu().numpy().astype(bool)

    def _apply_as_slot(self, state, step, x, compute_fn, signal=None):
        """`apply` through `apply_slots` on a batch of one slot: the branch
        is decided first (a device read for a state-dependent policy), and
        compute_fn runs only on the compute branch."""
        st = unsqueeze_state(state)
        sig = None if signal is None else signal[None]
        want = self._slot_want(st, np.array([step]), x[None], sig, None)
        y = compute_fn(x)[None] if want[0] else None
        ys, st = self.apply_slots(st, np.array([step]), x[None], y,
                                  want=want, signal=sig)
        return ys[0], squeeze_state(st)

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

    def apply(self, state, step, x, compute_fn, **signals):
        return compute_fn(x), state

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        return ys, states

    def static_schedule(self, num_steps: int):
        return [True] * num_steps
