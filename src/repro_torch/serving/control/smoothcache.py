"""SmoothCacheSchedule — calibrate-once static per-modality schedule; the
port of the JAX `serving/control/smoothcache.py`.

SmoothCache (PAPERS.md) is the strongest *static* point on the survey's
static->dynamic axis: profile the model ONCE per modality (the rel-L1
change of consecutive exact outputs along a calibration trajectory), derive
a layer-agnostic compute/reuse schedule by greedy error accumulation, then
serve that fixed schedule forever.  No runtime signals, no per-tick
decisions — which makes it both the cheapest possible planner (the serving
engine plans it from a host table: no device round trip) and the baseline
any *online* control loop must beat: wherever live telemetry buys nothing,
the calibrated static schedule is already optimal.

Mechanically this is repro_torch.core.adaptive.BlockCachePolicy (the
"Cache Me if You Can" greedy scheduler, Eq. 34-35) applied at MODEL
granularity with a calibration recorder attached — the survey's point that
SmoothCache and layer-adaptive calibration share one algorithm.

The calibration latent `xT` is drawn from a `torch.Generator` seeded with
`seed` on the params' device, as the autotuner's `calibration_reference`
draws it; JAX draws it from `jax.random.PRNGKey(seed)`."""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.adaptive import BlockCachePolicy
from repro_torch.core.metrics import rel_l1
from repro_torch.device import tree_device
from repro_torch.diffusion import ddim_step, linear_schedule, sample
from repro_torch.diffusion.pipeline import cfg_denoise_fn


def _profile_from(params, cfg, xT: torch.Tensor, num_steps: int,
                  class_label: int = 0, cfg_scale: float = 0.0,
                  noise_schedule=None) -> List[float]:
    """The calibration profile of the trajectory that starts at `xT`."""
    sched = noise_schedule or linear_schedule(1000)
    ts = sched.spaced(num_steps)
    base = cfg_denoise_fn(params, cfg, cfg_scale, class_label)
    outs = []

    def recorder(state, i, x, t_vec):
        eps, state = base(state, i, x, t_vec)
        outs.append(eps)
        return eps, state

    sample(recorder, xT, ts, sched, step_fn=ddim_step)
    profile = [0.0]
    for i in range(1, len(outs)):
        profile.append(float(rel_l1(outs[i], outs[i - 1])))
    return profile


def calibration_profile(params, cfg, num_steps: int, batch: int = 1,
                        seed: int = 0, class_label: int = 0,
                        cfg_scale: float = 0.0,
                        noise_schedule=None) -> Sequence[float]:
    """Per-step rel-L1 change of the exact model output along one
    calibration trajectory: profile[t] = relL1(eps_t, eps_{t-1}),
    profile[0] = 0 (the first step always computes)."""
    dev = tree_device(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xT = torch.randn((batch, cfg.dit_tokens, cfg.dit_in_dim), generator=gen,
                     device=dev)
    return _profile_from(params, cfg, xT, num_steps, class_label=class_label,
                         cfg_scale=cfg_scale, noise_schedule=noise_schedule)


class SmoothCacheSchedule(BlockCachePolicy):
    """Static calibrated schedule at model granularity.

    `alpha` is the accumulated-change threshold: larger alpha -> longer
    reuse runs -> cheaper serving at lower fidelity.  Its `want_compute`
    answers from the step alone, so the serving engine plans it from a
    host table and never pays a planning device round trip."""

    name = "smoothcache"

    def __init__(self, profile: Sequence[float], alpha: float = 0.1):
        super().__init__(profile, alpha)
        self.alpha = float(alpha)

    @classmethod
    def calibrate(cls, params, cfg, num_steps: int, alpha: float = 0.1,
                  batch: int = 1, seed: int = 0, class_label: int = 0,
                  cfg_scale: float = 0.0,
                  noise_schedule=None) -> "SmoothCacheSchedule":
        """Profile one exact trajectory on this modality's backbone and
        build the static schedule (the profile-once serve-forever flow)."""
        profile = calibration_profile(
            params, cfg, num_steps, batch=batch, seed=seed,
            class_label=class_label, cfg_scale=cfg_scale,
            noise_schedule=noise_schedule)
        return cls(profile, alpha)

    @property
    def compute_fraction(self) -> float:
        """Scheduled computes / calibrated steps."""
        return sum(map(bool, self._schedule)) / max(len(self._schedule), 1)

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"SmoothCacheSchedule(steps={len(self._schedule)}, "
                f"alpha={self.alpha}, cf={self.compute_fraction:.2f})")


def smoothcache_for_modality(workload, num_steps: int, alpha: float = 0.1,
                             cfg_scale: float = 0.0,
                             seed: int = 0) -> SmoothCacheSchedule:
    """Calibrate a SmoothCacheSchedule for one repro_torch.modalities
    workload (profile on that modality's backbone; serve statically)."""
    return SmoothCacheSchedule.calibrate(
        workload.params, workload.cfg, num_steps, alpha=alpha,
        cfg_scale=cfg_scale, seed=seed)
