"""CachedDenoiser and the serving engine's slot functions — the port of the
JAX `diffusion/pipeline.py` for class-conditioned image DiTs at MODEL
granularity.  Block / deepcache / video granularity, FasterCacheCFG,
negative-prompt vectors and text are not ported yet (ROADMAP.md §A).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import CachePolicy, NoCachePolicy
from repro_torch.device import DeviceLike, resolve_device, tree_device
from repro_torch.models import dit


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet; "
                               f"see ROADMAP.md §A")


def backbone_fns(params, cfg):
    """(forward_fn, signal_fn) bound to params.

    forward_fn(xs, ts, labels, y_embed=None) -> eps for xs (B, T, D),
    ts (B,) timesteps, labels (B,) class ids; signal_fn(xs, ts, labels) ->
    TeaCache's modulated first-block input."""
    if cfg.dit_num_frames > 0 or cfg.dit_text_len > 0:
        raise _not_ported(f"the backbone of '{cfg.name}'")

    def forward_fn(xs, ts, labels, y_embed=None):
        return dit.forward(params, xs, ts.float(), labels.long(), cfg,
                           y_embed=y_embed)

    def signal_fn(xs, ts, labels):
        h, c = dit.embed_patches(params, xs, ts.float(), labels.long(), cfg)
        return dit.modulated_signal(params, h, c, cfg)

    return forward_fn, signal_fn


class CachedDenoiser:
    """eps_hat, state = denoiser(state, i, x, t); the cache policy gates the
    whole backbone forward (MODEL granularity).  Every policy is handed
    TeaCache's signal (the AdaLN-modulated first-block input, Eq. 22), as
    in JAX.  With cfg_scale > 0 the unconditional branch runs every step
    (naive two-branch CFG)."""

    def __init__(self, params, cfg, policy: Optional[CachePolicy] = None,
                 granularity: str = "model", cfg_scale: float = 0.0,
                 cfg_policy: Optional[CachePolicy] = None,
                 class_label: int = 0, device: DeviceLike = None):
        if granularity != "model":
            raise _not_ported(f"granularity '{granularity}'")
        if cfg_policy is not None:
            raise _not_ported("cfg_policy (FasterCacheCFG)")
        self.device = resolve_device(device)
        if tree_device(params) != self.device:
            raise ValueError(f"params live on {tree_device(params)}, the "
                             f"denoiser runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.policy = policy or NoCachePolicy()
        self.cfg_scale = float(cfg_scale)
        self.class_label = class_label
        self._forward, self._signal = backbone_fns(params, cfg)

    def init_state(self, batch: int):
        cfgm = self.cfg
        eps_shape = (batch, cfgm.dit_tokens, cfgm.dit_in_dim)
        kw = ({"signal_shape": (batch, cfgm.dit_tokens, cfgm.d_model)}
              if self.policy.uses_signal else {})
        return {"policy": self.policy.init_state(eps_shape, device=self.device,
                                                 **kw)}

    def __call__(self, state, step: int, x_lat, t_vec):
        B = x_lat.shape[0]
        state = state if state is not None else self.init_state(B)
        y_cond = torch.full((B,), self.class_label, dtype=torch.long,
                            device=self.device)
        eps_c, pol_state = self.policy.apply(
            state["policy"], step, x_lat,
            lambda lat: self._forward(lat, t_vec, y_cond),
            signal=self._signal(x_lat, t_vec, y_cond))
        if self.cfg_scale > 0.0:
            y_null = torch.full((B,), self.cfg.dit_num_classes,
                                dtype=torch.long, device=self.device)
            eps_u = self._forward(x_lat, t_vec, y_null)
            eps_c = eps_u + self.cfg_scale * (eps_c - eps_u)
        return eps_c, {"policy": pol_state}


def slot_compact_denoise_fns(params, cfg, policy: CachePolicy,
                             cfg_policy: Optional[CachePolicy] = None):
    """Row-compacted slot-parallel entry point for the serving engine.

      compact_backbone_fn(xs, tvals, labels, nulls, row_slot, row_uncond,
                          row_dest) -> (y_c, y_u)
          gathers the `bucket` wanted rows (row_slot picks the source slot,
          row_uncond the null label), runs the backbone over that batch
          only, and scatters each row into a (2S+1)-row buffer at row_dest
          (cond row i -> i, uncond row i -> S + i, padding -> the dump row
          2S), split back into S-row y_c / y_u.  Rows not gathered are
          zeros, which only reach branches the per-slot select discards.
      apply_fn(states, steps, xs, scales, y_c, y_u, want, signal)
          -> (eps, states)
          the per-slot policy step over the whole slot axis (explicit slot
          dimension in place of JAX's vmap), taking the plan's host `want`
          (before active masking) and its signal, so the branch each slot
          takes is exactly the decision the plan read back.  The uncond
          branch recomputes every step (naive two-branch CFG); a slot with
          scale <= 0 keeps its cond output, never blended.
    """
    if cfg_policy is not None:
        raise _not_ported("cfg_policy (FasterCacheCFG) in serving")
    forward_fn, _ = backbone_fns(params, cfg)

    def compact_backbone_fn(xs, tvals, labels, nulls, row_slot, row_uncond,
                            row_dest):
        S, T, D = xs.shape
        yb = torch.where(row_uncond, nulls[row_slot], labels[row_slot])
        eps = forward_fn(xs[row_slot], tvals[row_slot], yb)
        buf = torch.zeros((2 * S + 1, T, D), dtype=eps.dtype, device=eps.device)
        buf[row_dest] = eps
        return buf[:S], buf[S:2 * S]

    def apply_fn(states, steps, xs, scales, y_c, y_u, want=None,
                 signal=None):
        eps_c, pol_state = policy.apply_slots(states["policy"], steps, xs, y_c,
                                              want=want, signal=signal)
        sc = scales.view(-1, 1, 1)
        eps = torch.where(sc > 0.0, y_u + sc * (eps_c - y_u), eps_c)
        return eps, {"policy": pol_state, "cfg": states["cfg"]}

    return compact_backbone_fn, apply_fn


class WantPlan(NamedTuple):
    """One tick's plan, before active masking: host (S,) arrays (see
    `core.policy.SlotWant`), and the signal on the device (None when the
    policy does not use one)."""
    want_cond: np.ndarray
    want_uncond: np.ndarray
    metric: np.ndarray
    value: np.ndarray
    threshold: np.ndarray
    forced: np.ndarray
    signal: Optional[torch.Tensor]


def slot_want_fns(params, cfg, policy: CachePolicy,
                  cfg_policy: Optional[CachePolicy] = None):
    """The planner's fused slot-batched want/metric pass.

      want_all_fn(states, steps, xs, tvals, labels, guided) -> WantPlan

    TeaCache's signal is computed ONCE over the whole (S, T, D) slot batch
    (only for a policy that uses it), then every slot's decision
    (`SlotWant`: want, the JAX `want_metric`, the value the decision
    thresholds, that threshold, and whether it was forced) comes out of
    `policy.want_slots` on the device, packed into one tensor and read back
    in ONE device-to-host copy.  `want_uncond` is the guided flag (the
    uncond branch recomputes every step).  The signal stays on the device
    for the tick's `apply_fn`."""
    if cfg_policy is not None:
        raise _not_ported("cfg_policy (FasterCacheCFG) in serving")
    _, signal_fn = backbone_fns(params, cfg)

    def want_all_fn(states, steps, xs, tvals, labels, guided):
        dev = xs.device
        sig = None
        if policy.uses_signal:
            sig = signal_fn(xs, torch.as_tensor(tvals, device=dev),
                            torch.as_tensor(labels, device=dev))
        w = policy.want_slots(states["policy"], steps, xs, sig)
        packed = torch.stack([t.float() for t in w]).cpu().numpy()
        return WantPlan(packed[0] > 0.5, np.asarray(guided, bool).copy(),
                        packed[1], packed[2], packed[3], packed[4] > 0.5, sig)

    return want_all_fn


def cfg_denoise_fn(params, cfg, cfg_scale: float, class_label: int = 0):
    """Uncached CFG denoiser (the exact baseline): eps = e_u + s (e_c - e_u)."""
    forward_fn, _ = backbone_fns(params, cfg)

    def fn(state, step, x, t_vec):
        B = x.shape[0]
        y_c = torch.full((B,), class_label, dtype=torch.long, device=x.device)
        e_c = forward_fn(x, t_vec, y_c)
        if cfg_scale <= 0.0:
            return e_c, state
        y_u = torch.full((B,), cfg.dit_num_classes, dtype=torch.long,
                         device=x.device)
        e_u = forward_fn(x, t_vec, y_u)
        return e_u + cfg_scale * (e_c - e_u), state
    return fn
