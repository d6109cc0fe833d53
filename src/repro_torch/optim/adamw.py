"""AdamW with decoupled weight decay, global-norm clipping and the cosine
warmup schedule: the port of the JAX package's `optim/adamw.py`.

Trees are the params' nested dicts; the moments mirror them in f32.  Every
function stays on the params' device: the step count, the norm, the scale
and the learning rate are 0-d tensors, never read back to the host.

Held differences from JAX, same function:
- `adamw_update` updates the moments and the params in place, one slice
  of at most `CHUNK` elements of a leaf at a time (a stacked leaf along
  its layer axis), so that a step holds one slice's f32 temporaries
  rather than a second copy of the moments, and a captured step, which
  cannot release its pool's segments to fit a larger block, never asks
  for a leaf-sized one.  It returns the same tensors (JAX returns new
  arrays).  With `grad_scale` it also applies the clipping scale slice by
  slice (`clip_by_global_norm`'s product, element for element), so the
  train step never holds the clipped f32 gradients of the whole tree.
- `clip_by_global_norm` scales in f32 and returns f32 gradients, as JAX's
  promotion of a bf16 array times an f32 0-d array does (torch would keep
  bf16)."""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, on the params' device
    mu: Tree                 # first moment, f32
    nu: Tree                 # second moment, f32


def _device(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params: Tree, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


#: elements of the slice of a leaf that the optimizer reads at a time
CHUNK = 1 << 26


def _slices(t: torch.Tensor):
    """Views of t of at most CHUNK elements along its first axis (t
    itself when it is that small)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // max(t[0].numel(), 1))
    return [t[i:i + rows] for i in range(0, t.shape[0], rows)]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in JAX's flattening order.  A leaf above CHUNK elements is summed
    slice by slice into its own partial first, so no leaf-sized f32 copy
    is made: its sum is that of its slices' sums, another order of the
    same terms than one reduction over the leaf."""
    total = 0
    for leaf in tree_leaves(tree):
        leaf_sum = 0
        for part in _slices(leaf):
            leaf_sum = leaf_sum + torch.sum(torch.square(part.float()))
        total = total + leaf_sum
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(grads: Tree, max_norm: float):
    """(min(1, max_norm / (norm + 1e-8)), norm): the clipping scale."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-8), max=1.0), norm


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-8)) in f32, norm)."""
    scale, norm = clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_scale=None):
    """One AdamW step in f32, each param cast back to its own dtype.  `lr`
    is a float or a 0-d tensor (a schedule's value); `grad_scale` (a 0-d
    f32 tensor, `clip_scale`'s) multiplies each f32 gradient first.
    Updates every leaf in place, slice by slice — the params, both moments
    and the step counter, so a train step holds no second copy of any
    (train_loop(verify_donation=True) checks it); returns (params,
    AdamWState(step, mu, nu)) over the same tensors."""
    step = state.step.add_(1)
    stepf = step.float()
    # the betas as device fills, not host copies: a captured step holds
    # no host-to-device copy
    b1t = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                     device=step.device), stepf)
    b2t = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                     device=step.device), stepf)
    for leaves in zip(tree_leaves(grads), tree_leaves(state.mu),
                      tree_leaves(state.nu), tree_leaves(params)):
        for g, m, v, p in zip(*map(_slices, leaves)):
            gf = g.float() if grad_scale is None else g.float() * grad_scale
            m.copy_(b1 * m + (1.0 - b1) * gf)
            v.copy_(b2 * v + (1.0 - b2) * torch.square(gf))
            pf = p.float()
            delta = (m / b1t) / (torch.sqrt(v / b2t) + eps) \
                + weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def cosine_warmup_schedule(step, *, peak_lr: float, warmup_steps: int,
                           total_steps: int, min_ratio: float = 0.1):
    """Linear warmup, then cosine decay to min_ratio * peak; a 0-d f32
    tensor on `step`'s device (a Python int gives a CPU tensor)."""
    step = torch.as_tensor(step).float()
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)
