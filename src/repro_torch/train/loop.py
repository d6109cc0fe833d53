"""Generic training loop: periodic logging and checkpointing, the port of
the JAX package's `train/loop.py`.

The step runs eagerly.  Its metrics stay on the device and are read back
only on logging steps (the first and every `log_every`-th), in one copy:
the steps in between never wait on the device.  `jit` and `donate` have no
eager meaning and are accepted and ignored (the port's optimizer already
updates the state in place); `verify_donation=True` asks for JAX's
compiled-IR donation check, which the port does not have (ROADMAP.md
§A.8), and raises."""
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
    if verify_donation:
        raise NotImplementedError(
            "train_loop(verify_donation=True) runs the JAX package's "
            "compiled-IR donation check (XLA only); the port's counterparts "
            "are ROADMAP.md §A.8")
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= num_steps:
            break
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
