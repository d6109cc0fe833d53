"""Generic training loop: periodic logging and checkpointing, the port of
the JAX package's `train/loop.py`.

`jit=True` (JAX's default, which jits the step with its state donated)
compiles the step into one program: step 1 runs eagerly (it builds the
kernels; it is also the `verify_donation` step), then the whole step —
forward, backward through the kernels' autograd Functions, clipping and
the optimizer's in-place update — is captured once
(`repro_torch.obs.profiling.compile_program`: a CUDA graph on the card;
on the CPU nothing is captured and the same function runs) and replayed
for every later step.  The program reads the batch from static buffers
that each step refills, and updates the state in place: the state the
loop returns is the state it was given.  A batch that carries a
`torch.Generator` needs the step's `prepare_batch` (the diffusion step
has one), which makes the step's draws from it outside the program, so a
resumed run draws what the uninterrupted one drew.  `jit=False` runs
every step eagerly; `donate` has no separate meaning (the port's
optimizer updates the state in place either way).

The metrics stay on the device and are read back only on logging steps
(the first and every `log_every`-th), in one copy: the steps in between
never wait on the device.  `verify_donation=True` checks the in-place
promise, the eager form of JAX's donation check: the first step runs
under the operator recorder (`repro_torch.analysis.ir.op_checks`), and
the loop raises `DonationError` unless every leaf of the state it returns
is the leaf it took, written in place."""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.device import tree_copy_
from repro_torch.obs.profiling import compile_program
from repro_torch.tree import tree_leaves, tree_map


def train_loop(step_fn: Callable, state, batches: Iterator, num_steps: int, *,
               log_every: int = 10, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 500, log_fn=print, jit: bool = True,
               donate: bool = True, verify_donation: bool = False):
    """Run `num_steps` of `step_fn(state, batch) -> (state, metrics)`.

    Returns (final state, list of metric dicts of the logging steps, each
    with "step" and "steps_per_s")."""
    del donate
    history = []
    prepare = getattr(step_fn, "prepare_batch", None)
    program = None
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= num_steps:
            break
        if jit and prepare is not None:
            batch = prepare(batch)
        if verify_donation and i == 0:
            state, metrics = _verified_step(step_fn, state, batch)
        elif not jit or i == 0:
            state, metrics = step_fn(state, batch)
        else:
            if program is None:
                program = StepProgram(step_fn, state, batch, first)
            metrics = program(batch)
        if i == 0:
            first = metrics             # the device metrics of the step
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


class StepProgram:
    """The train step compiled over static buffers: the batch's tensors
    (refilled each step), the state (updated in place; a leaf the step
    returns anew is copied back into it) and the metrics.  Made after an
    eager first step, which warmed every kernel, so the capture runs no
    extra step."""

    def __init__(self, step_fn: Callable, state, batch, metrics):
        for leaf in tree_leaves(batch):
            if not isinstance(leaf, torch.Tensor) and leaf is not None:
                raise ValueError(
                    f"train_loop(jit=True): a batch leaf of type "
                    f"{type(leaf).__name__} cannot be read by a captured "
                    f"step; give the step a prepare_batch (the diffusion "
                    f"step's makes its draws from the generator)")
        self.batch = static_batch = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, batch)
        self.metrics = static_metrics = {
            k: torch.as_tensor(v).clone() for k, v in metrics.items()}

        def run():      # holds the buffers, not self: no reference cycle
            new_state, m = step_fn(state, static_batch)
            tree_copy_(state, new_state)
            tree_copy_(static_metrics, {k: m[k] for k in static_metrics})

        leaves = tree_leaves(state)
        device = leaves[0].device if leaves else torch.device("cpu")
        self.program, self.profile = compile_program(
            run, key="train_step", device=device, eager=False,
            pool=torch.cuda.graph_pool_handle()
            if device.type == "cuda" else None)

    def __call__(self, batch):
        for d, b in zip(tree_leaves(self.batch), tree_leaves(batch)):
            if isinstance(d, torch.Tensor) and d.shape != b.shape:
                raise ValueError(f"train_loop(jit=True): a batch leaf of "
                                 f"shape {tuple(b.shape)} for the captured "
                                 f"step's {tuple(d.shape)}")
        tree_copy_(self.batch, batch)
        self.program.run()
        return dict(self.metrics)


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
