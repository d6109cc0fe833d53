"""Generic training loop: periodic logging and checkpointing, the port of
the JAX package's `train/loop.py`.

The step runs eagerly.  Its metrics stay on the device and are read back
only on logging steps (the first and every `log_every`-th), in one copy:
the steps in between never wait on the device.  `jit` and `donate` have no
eager meaning and are accepted and ignored (the port's optimizer updates
the state in place).  `verify_donation=True` checks that promise, the
eager form of JAX's donation check: the first step runs under the
operator recorder (`repro_torch.analysis.ir.op_checks`), and the loop
raises `DonationError` unless every leaf of the state it returns is the
leaf it took, written in place."""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch import checkpoint as ckpt_lib


def train_loop(step_fn: Callable, state, batches: Iterator, num_steps: int, *,
               log_every: int = 10, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 500, log_fn=print, jit: bool = True,
               donate: bool = True, verify_donation: bool = False):
    """Run `num_steps` of `step_fn(state, batch) -> (state, metrics)`.

    Returns (final state, list of metric dicts of the logging steps, each
    with "step" and "steps_per_s")."""
    del jit, donate
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= num_steps:
            break
        if verify_donation and i == 0:
            state, metrics = _verified_step(step_fn, state, batch)
        else:
            state, metrics = step_fn(state, batch)
        if (i + 1) % log_every == 0 or i == 0:
            names = list(metrics)          # one device-to-host copy
            values = torch.stack([torch.as_tensor(metrics[k]).float()
                                  for k in names]).tolist()
            metrics = dict(zip(names, values))
            metrics["steps_per_s"] = (i + 1) / (time.perf_counter() - t0)
            history.append({"step": i + 1, **metrics})
            log_fn(f"step {i+1:5d}  " + "  ".join(
                f"{k}={v:.4g}" for k, v in metrics.items()))
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, i + 1, state)
    return state, history


def _verified_step(step_fn: Callable, state, batch):
    """One step under the operator recorder; DonationError unless every
    state leaf was updated in place."""
    from repro_torch.analysis.ir.op_checks import (DonationError,
                                                   check_donation,
                                                   record_program)
    (new_state, metrics), rec = record_program(
        "train_step", lambda: step_fn(state, batch), sync_debug=False)
    issue = check_donation(rec, state, new_state,
                           label="train_loop step_fn")
    if issue is not None:
        raise DonationError(issue)
    return new_state, metrics
