"""Temporal-aware caching for latents with a frame axis (survey §IV, the
video-generation scenarios) — the port of the JAX `core/temporal.py`.

A video clip's tokens carry a (frames, patches) factorization, and the two
axes age differently across denoising steps: motion concentrates change in
a few frames while the background barely moves.  Two temporal
specializations:

  * TemporalTeaCachePolicy — TeaCache whose input-side signal distance is
    computed PER FRAME and reduced across the frame axis (default: max), so
    a change concentrated in one frame refreshes the cache that a clip-mean
    rel-L1 would average away.  Model granularity, planned by the serving
    engine's device want pass like TeaCache (registered as
    "teacache_video").
  * TemporalPABStack — Pyramid Attention Broadcast over a factorized
    spatio-temporal block stack: each block's spatial-attention,
    temporal-attention and MLP branch outputs are cached and broadcast over
    per-module-type ranges (PABPolicy.RANGES: spatial 2, temporal 4, mlp
    4).  Stack-structural (owns the layer loop, like DBCacheStack), listed
    in STRUCTURAL_POLICIES as "pab_video".
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from .adaptive import TeaCachePolicy
from .engine import layer_params
from .policy import interval_pred
from .static_policies import PABPolicy

_EPS = 1e-8


class TemporalTeaCachePolicy(TeaCachePolicy):
    """TeaCache with a per-frame signal reduction (frame-axis-aware Eq. 22).

    `frames` is the clip's frame count F.  A slot's signal (its rows of
    (..., F*P, d)) is viewed as (rows, F, P*d); the symmetric rel-L1 is
    taken per frame, pooled over the slot's rows (the batch of a scalar
    `apply`, as JAX sums over axis 0), then reduced across frames
    (`reduce`: "max" — any frame crossing the threshold refreshes — or
    "mean", a clip-level average).  One distance per slot."""

    name = "teacache_video"

    def __init__(self, delta: float, frames: int,
                 poly: Sequence[float] = (0.0, 1.0), reduce: str = "max"):
        if frames < 1:
            raise ValueError(f"frames must be >= 1, got {frames}")
        if reduce not in ("max", "mean"):
            raise ValueError(f"reduce must be 'max' or 'mean', got {reduce!r}")
        super().__init__(delta, poly)
        self.frames = frames
        self.reduce = reduce

    def _signal_distance(self, sig, prev):
        S, Fr = sig.shape[0], self.frames
        per = sig.shape[-2] * sig.shape[-1] // Fr
        s = sig.reshape(S, -1, Fr, per)
        p = prev.reshape(S, -1, Fr, per)
        num = (s - p).abs().sum(dim=(1, 3))
        den = s.abs().sum(dim=(1, 3)) + p.abs().sum(dim=(1, 3)) + _EPS
        per_frame = num / den                            # (S, F)
        if self.reduce == "max":
            return per_frame.amax(dim=-1)
        return per_frame.mean(dim=-1)


class TemporalPABStack:
    """PAB (survey §III-C) over a factorized spatio-temporal block stack.

    branch_fns: ordered mapping {module_type: fn} with
    fn(layer_params, x, *args) -> the block's gated residual BRANCH output
    (same shape as x); the block applies x += branch(x) in mapping order.
    Each branch output is cached per layer and recomputed only at its
    module-type broadcast range: `intervals[module_type]` steps
    (PABPolicy.RANGES by default, so temporal attention is broadcast over
    a longer range than spatial attention).  Step-indexed like every
    static policy: the Python-int step picks the branch on the host."""

    def __init__(self, branch_fns: Mapping[str, Callable], num_layers: int,
                 ranges: Optional[Mapping[str, int]] = None):
        if num_layers < 1 or not branch_fns:
            raise ValueError("TemporalPABStack needs layers and branches")
        self.branch_fns = dict(branch_fns)
        self.num_layers = num_layers
        src = dict(PABPolicy.RANGES if ranges is None else ranges)
        self.intervals = {k: int(src[k]) for k in self.branch_fns}

    def init(self, shape, dtype=torch.float32, *,
             device) -> List[Dict[str, torch.Tensor]]:
        """One cache per branch per layer (a list over the layers)."""
        return [{k: torch.zeros(shape, dtype=dtype, device=device)
                 for k in self.branch_fns} for _ in range(self.num_layers)]

    def __call__(self, states, step: int, x, stacked_params, *args):
        """states: per-layer per-branch caches; x: (B, T, d).  Returns
        (y, new_states)."""
        new_states = []
        for i, state in enumerate(states):
            p = layer_params(stacked_params, i)
            new = {}
            for name, fn in self.branch_fns.items():
                cache = state[name]
                if interval_pred(step, self.intervals[name]):
                    o = fn(p, x, *args)
                    new[name] = o.to(cache.dtype)
                else:
                    o, new[name] = cache.to(x.dtype), cache
                x = x + o
            new_states.append(new)
        return x, new_states

    def static_schedule(self, num_steps: int):
        """Per-step fraction of branches computing (roofline introspection)."""
        n = len(self.branch_fns)
        return [sum(s % iv == 0 for iv in self.intervals.values()) / n
                for s in range(num_steps)]

    def compute_fraction(self, num_steps: int) -> float:
        """Fraction of branch evaluations that actually run over a
        trajectory — PAB's analogue of the survey's 1/speedup."""
        sched = self.static_schedule(num_steps)
        return sum(sched) / max(num_steps, 1)
