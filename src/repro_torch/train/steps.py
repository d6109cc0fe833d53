"""Loss functions and train steps for both workload kinds: the port of the
JAX package's `train/steps.py`.

`make_*_train_step` returns a (state, batch) -> (state, metrics) function
that runs eagerly on the params' device and never reads a value back to
the host; the metrics are 0-d tensors.  Gradient accumulation splits the
batch into microbatches inside one step and sums their f32 gradients.

Held differences from JAX, same function:
- Randomness.  `diffusion_loss` draws t, eps and the 10 % label drop from a
  `torch.Generator` (JAX: `split(key, 3)`), or takes them injected as
  `draws`, which is how the tests feed JAX's draws.  A diffusion batch
  carries a `generator` (JAX: a `key`) or `draws`.
- Accumulation.  The diffusion step draws for the whole batch once and
  splits the draws with the microbatches.  JAX's `accum > 1` diffusion
  step fails: it reshapes the batch's PRNG key with the other leaves.
- The optimizer updates the state in place (`repro_torch.optim`).

The forward, the backward and the optimizer run under the profiler
ranges "train.forward", "train.backward" and "train.optimizer" (the
backward's operators run on autograd's own thread on the card).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.data import latent_batches
from repro_torch.models import dit, init_params, transformer
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_scale, cosine_warmup_schedule)
from repro_torch.tree import tree_leaves, tree_unflatten_like

Tree = Any
LABEL_DROP = 0.1     # classifier-free guidance training drops labels so often


class TrainState(NamedTuple):
    params: Tree
    opt: AdamWState


def init_train_state(generator: torch.Generator, cfg, dtype=None,
                     device=None) -> TrainState:
    """Random params from `generator` (on `device`: the GPU unless the
    caller passes device="cpu") and zero AdamW moments."""
    params = init_params(generator, cfg, dtype, device=device)
    return TrainState(params=params, opt=adamw_init(params))


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def lm_loss(params, tokens, targets, cfg, *, vision_embeds=None,
            aux_weight: float = 0.01, z_weight: float = 1e-3):
    """Causal-LM cross-entropy plus `aux_weight` times the MoE
    load-balance loss and `z_weight` times the router-z loss (both 0 for
    the families without experts, as JAX's are); a vlm takes
    `vision_embeds`, and its vision positions carry no targets (their
    logits are dropped).  The losses' gradients flow through the gates and
    the router probabilities, not through the top-k selection."""
    logits, aux = transformer.forward(params, tokens, cfg,
                                      vision_embeds=vision_embeds,
                                      with_aux=True)
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_vision_tokens:]
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    lb, z = aux["load_balance_loss"], aux["router_z_loss"]
    total = loss + aux_weight * lb + z_weight * z
    return total, {"loss": loss, "lb_loss": lb, "z_loss": z}


def diffusion_draws(generator: torch.Generator, latents, T: int):
    """(t (B,) int64 in [0, T), eps like latents, drop (B,) bool at
    LABEL_DROP) drawn from `generator` on its device, in that order."""
    B, dev = latents.shape[0], generator.device
    t = torch.randint(0, T, (B,), generator=generator, device=dev)
    eps = torch.randn(latents.shape, generator=generator, device=dev,
                      dtype=latents.dtype)
    drop = torch.rand((B,), generator=generator, device=dev) < LABEL_DROP
    return t, eps, drop


def diffusion_loss(params, latents, labels, cfg, sched, generator=None, *,
                   draws=None):
    """DDPM eps-prediction MSE (survey Eq. 8).  `draws` = (t, eps, drop)
    replaces the draws from `generator`."""
    if draws is None:
        draws = diffusion_draws(generator, latents, sched.T)
    t, eps, drop = draws
    x_t = sched.q_sample(latents, t, eps)
    # classifier-free guidance training: the dropped labels take the null
    # class
    y = torch.where(drop, torch.full_like(labels, cfg.dit_num_classes), labels)
    eps_hat = dit.forward(params, x_t.to(getattr(torch, cfg.dtype)),
                          t.float(), y, cfg)
    loss = torch.mean(torch.square(eps_hat.float() - eps))
    return loss, {"loss": loss}


# ----------------------------------------------------------------------
# train steps (with optional gradient accumulation)
# ----------------------------------------------------------------------

def _value_and_grad(loss_fn: Callable, params, batch):
    """(grads in the params' tree and dtypes, detached metrics) of
    loss_fn(params, batch) -> (loss, metrics).  The params get gradient-
    tracking aliases; a leaf the loss does not reach gets zeros, as JAX
    gives."""
    leaves = [p.detach().requires_grad_(p.is_floating_point())
              for p in tree_leaves(params)]
    with torch.enable_grad():
        with record_function("train.forward"):
            loss, metrics = loss_fn(tree_unflatten_like(params, leaves), batch)
        wrt = [p for p in leaves if p.requires_grad]
        with record_function("train.backward"):
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (tree_unflatten_like(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def _accumulated_grads(loss_fn: Callable, params, batch: dict, accum: int):
    """Mean grads and metrics over `accum` microbatches (every batch tensor
    split along its first axis).  With accum > 1 the gradients accumulate
    in f32 from zeros, as JAX's scan does."""
    if accum <= 1:
        return _value_and_grad(loss_fn, params, batch)
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"batch {n} does not split into {accum} microbatches")
    size = n // accum
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    m_acc = None
    for i in range(accum):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        grads, metrics = _value_and_grad(loss_fn, params, mb)
        g_acc = [a + g for a, g in zip(g_acc, tree_leaves(grads))]
        if m_acc is None:
            m_acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
        m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
    inv = 1.0 / accum
    return (tree_unflatten_like(params, [a * inv for a in g_acc]),
            {k: v * inv for k, v in m_acc.items()})


def _optimize(state: TrainState, grads, metrics, *, peak_lr, warmup,
              total_steps, max_grad_norm, weight_decay):
    with record_function("train.optimizer"):
        # clip_by_global_norm's scale, applied slice by slice in the update
        scale, gnorm = clip_scale(grads, max_grad_norm)
        lr = cosine_warmup_schedule(state.opt.step, peak_lr=peak_lr,
                                    warmup_steps=warmup,
                                    total_steps=total_steps)
        params, opt = adamw_update(grads, state.opt, state.params, lr=lr,
                                   weight_decay=weight_decay,
                                   grad_scale=scale)
    return TrainState(params, opt), dict(metrics, grad_norm=gnorm, lr=lr)


def make_lm_train_step(cfg, *, peak_lr=3e-4, warmup=100, total_steps=10_000,
                       accum: int = 1, max_grad_norm: float = 1.0,
                       weight_decay: float = 0.1):
    """batch: {"tokens", "targets"} (B, S) integer tensors, and a vlm's
    "vision_embeds" (B, num_vision_tokens, vision_dim)."""
    def loss_fn(params, b):
        return lm_loss(params, b["tokens"], b["targets"], cfg,
                       vision_embeds=b.get("vision_embeds"))

    def step(state: TrainState, batch):
        mb = {k: batch[k] for k in ("tokens", "targets", "vision_embeds")
              if batch.get(k) is not None}
        grads, metrics = _accumulated_grads(loss_fn, state.params, mb, accum)
        return _optimize(state, grads, metrics, peak_lr=peak_lr,
                         warmup=warmup, total_steps=total_steps,
                         max_grad_norm=max_grad_norm,
                         weight_decay=weight_decay)

    return step


def make_diffusion_train_step(cfg, sched, *, peak_lr=1e-4, warmup=100,
                              total_steps=10_000, accum: int = 1,
                              max_grad_norm: float = 1.0):
    """batch: {"latents" (B, T, in_dim), "labels" (B,), and "generator" (a
    torch.Generator on the params' device) or "draws" (t, eps, drop)}.
    The step's `prepare_batch(batch)` makes the draws ahead of it."""
    def loss_fn(params, b):
        return diffusion_loss(params, b["latents"], b["labels"], cfg, sched,
                              draws=(b["t"], b["eps"], b["drop"]))

    def step(state: TrainState, batch):
        latents, labels = batch["latents"], batch["labels"]
        draws = batch.get("draws")
        if draws is None:
            draws = diffusion_draws(batch["generator"], latents, sched.T)
        t, eps, drop = draws
        mb = {"latents": latents, "labels": labels, "t": t, "eps": eps,
              "drop": drop}
        grads, metrics = _accumulated_grads(loss_fn, state.params, mb, accum)
        return _optimize(state, grads, metrics, peak_lr=peak_lr,
                         warmup=warmup, total_steps=total_steps,
                         max_grad_norm=max_grad_norm, weight_decay=0.0)

    def prepare_batch(batch):
        """The batch with its draws made from its generator, outside any
        captured step (train_loop(jit=True) calls it on every batch): the
        same draws, in the same order, as the step would make."""
        if batch.get("draws") is not None:
            return batch
        return {"latents": batch["latents"], "labels": batch["labels"],
                "draws": diffusion_draws(batch["generator"],
                                         batch["latents"], sched.T)}

    step.prepare_batch = prepare_batch
    return step


# ----------------------------------------------------------------------
# batches on the device
# ----------------------------------------------------------------------

def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s draw generator: a function of (seed, step)
    alone, as the data is, so a run resumed at a step draws what the
    uninterrupted run drew there."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def diffusion_batches(seed: int, batch: int, cfg, device,
                      start_step: int = 0, draw_seed: Optional[int] = None):
    """Infinite iterator of diffusion train batches on `device`: the
    synthetic class-conditional latents of `latent_batches(seed, ...)` and
    a draw generator seeded from (draw_seed, step) (draw_seed defaults to
    seed + 1, as JAX's launcher keys its draws with PRNGKey(seed + 1))."""
    draw_seed = seed + 1 if draw_seed is None else draw_seed
    device = torch.device(device)
    lat = latent_batches(seed, batch, cfg.dit_patch_tokens, cfg.dit_in_dim,
                         cfg.dit_num_classes, start_step=start_step)
    for step, (x, y) in enumerate(lat, start=start_step):
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed(draw_seed, step))
        yield {"latents": torch.from_numpy(x).to(device),
               "labels": torch.from_numpy(y).to(device), "generator": gen}


__all__ = ["TrainState", "init_train_state", "lm_loss", "diffusion_loss",
           "diffusion_draws", "make_lm_train_step",
           "make_diffusion_train_step", "diffusion_batches", "step_seed"]
