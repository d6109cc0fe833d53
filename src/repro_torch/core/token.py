"""ToCa — token-wise feature caching (survey §III-C, Eq. 19-21), the port
of the JAX `core/token.py`.

Each skipped step recomputes only the top-R% most cache-sensitive tokens
and reuses the cache for the rest.  Score S(x_i) = sum_j lambda_j s_j(x_i)
(Eq. 19) over

  s1  temporal redundancy   |x_t - x_prev| per token
  s2  error propagation     the token's feature norm (attention-free proxy)
  s3  cache staleness       steps since the token was last recomputed
  s4  spatial prior         a uniform stride, so every region refreshes

The k-th largest score is the threshold (descending sort); tokens at or
above it recompute (ties included), merged back with a dense `where`.
Its skipped steps still run the module (the partial branch selects from a
full output unless a token-local `subset_fn` is given), so its want is
always True, as in JAX: a ToCa slot never gets a skip tick.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .policy import CachePolicy, interval_pred, slot_mask


class ToCaPolicy(CachePolicy):
    """Token-wise caching for (..., T, D) features: a full compute every
    `interval` steps, the `ratio` most cache-sensitive tokens in between."""

    name = "toca"

    def __init__(self, interval: int = 4, ratio: float = 0.25,
                 lambdas: Sequence[float] = (1.0, 0.5, 0.5, 0.25)):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio must lie in (0, 1], got {ratio}")
        self.interval = interval
        self.ratio = ratio
        self.lambdas = tuple(float(v) for v in lambdas)

    def init_state(self, shape, dtype=torch.float32, *, device):
        *lead, T, _ = shape
        return {
            "cache": torch.zeros(shape, dtype=dtype, device=device),
            "prev_in": torch.zeros(shape, dtype=torch.float32, device=device),
            "stale": torch.zeros((*lead, T), dtype=torch.float32,
                                 device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device),
        }

    def scores(self, state, x):
        """(..., T) composite cache-sensitivity score (higher = recompute)."""
        xf = x.float()
        T, D = x.shape[-2], x.shape[-1]
        s1 = (xf - state["prev_in"]).abs().mean(-1)
        s2 = torch.linalg.vector_norm(xf, dim=-1) / (D ** 0.5)
        stride = max(int(1.0 / self.ratio), 1)
        s4 = (torch.arange(T, device=x.device) % stride == 0).float()
        l1, l2, l3, l4 = self.lambdas
        return l1 * s1 + l2 * s2 + l3 * state["stale"] + l4 * s4

    def _recompute(self, state, x):
        """(..., T) bool: the tokens at or above the k-th largest score."""
        k = max(int(self.ratio * x.shape[-2]), 1)
        sc = self.scores(state, x)
        thresh = torch.sort(sc, dim=-1, descending=True).values[..., k - 1:k]
        return sc >= thresh

    def _partial(self, state, x, recompute, y_full):
        """The partial branch: recomputed tokens from y_full, the rest from
        the cache."""
        y = torch.where(recompute[..., None], y_full,
                        state["cache"].to(y_full.dtype))
        return y, {"cache": y.to(state["cache"].dtype), "prev_in": x.float(),
                   "stale": torch.where(recompute, 0.0, state["stale"] + 1.0),
                   "n": state["n"] + 1}

    def apply(self, state, step, x, compute_fn, subset_fn=None, **signals):
        if interval_pred(step, self.interval):
            y = compute_fn(x)
            return y, {"cache": y.to(state["cache"].dtype),
                       "prev_in": x.float(),
                       "stale": torch.zeros_like(state["stale"]),
                       "n": state["n"] + 1}
        recompute = self._recompute(state, x)
        y_full = (compute_fn(x) if subset_fn is None
                  else subset_fn(x, recompute))
        return self._partial(state, x, recompute, y_full)

    def apply_slots(self, states, steps, xs, ys, *, want=None, signal=None):
        full = interval_pred(steps, self.interval)
        xf = xs.float()
        n = states["n"] + 1
        if full.all():
            return ys, {"cache": ys.to(states["cache"].dtype), "prev_in": xf,
                        "stale": torch.zeros_like(states["stale"]), "n": n}
        y, new = self._partial(states, xs, self._recompute(states, xs), ys)
        if full.any():
            m = slot_mask(full, ys)
            y = torch.where(m, ys, y)
            new["cache"] = torch.where(m, ys.to(states["cache"].dtype),
                                       new["cache"])
            new["stale"] = torch.where(slot_mask(full, new["stale"]), 0.0,
                                       new["stale"])
        return y, new

    def static_schedule(self, num_steps: int):
        # fraction view: full steps + ratio-weighted partial steps
        return [s % self.interval == 0 for s in range(num_steps)]
