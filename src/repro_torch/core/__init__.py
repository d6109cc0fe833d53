"""repro_torch.core — the cache-policy library of the port.

Taxonomy map (survey Fig. 2), as in the JAX `repro.core`:
  Static            : FixedIntervalPolicy (FORA), DeltaCachePolicy (Δ-DiT),
                      PABPolicy, FasterCacheCFG (CFG-branch reuse),
                      DeepCache (structural — see
                      repro_torch.diffusion.pipeline)
  Timestep-adaptive : TeaCachePolicy, MagCachePolicy, EasyCachePolicy,
                      TemporalTeaCachePolicy (per-frame, video)
  Layer-adaptive    : BlockCachePolicy, ForesightPolicy, DBCacheStack
  Predictive        : PredictivePolicy (taylor, newton, hermite, ab, foca),
                      FreqCaPolicy
  Hybrid            : ClusCaPolicy, SpeCaPolicy
  Token-wise        : ToCaPolicy
  Learned           : LazyDiTPolicy, lazy_trajectory_loss, train_lazy_gate
  Stack-structural  : CachedStack (block granularity), DBCacheStack,
                      TemporalPABStack (PAB over the video branches)

`make_policy` builds every name of the JAX registry; the stack-structural
methods own the layer loop and are built directly (STRUCTURAL_POLICIES).
"""
from .adaptive import (BlockCachePolicy, EasyCachePolicy, ForesightPolicy,
                       GatedPolicy, MagCachePolicy, TeaCachePolicy)
from .engine import (CachedModule, CachedStack, DBCacheStack,
                     SlotBatchedPolicy, cache_state_bytes, compute_fraction,
                     layer_params, stack_slots)
from .hybrid import ClusCaPolicy, SpeCaPolicy, kmeans
from .learned import (LazyDiTPolicy, gate_score, init_gate,
                      lazy_trajectory_loss, train_lazy_gate)
from .metrics import (cosine_sim, mag_ratio, psnr, rel_l1, rel_l1_block,
                      rel_l2, transform_rate)
from .policy import (CachePolicy, NoCachePolicy, SlotWant, interval_pred,
                     static_plan)
from .predictive import (BASES, FreqCaPolicy, PredictivePolicy,
                         forecast_from_diffs, update_diff_stack)
from .static_policies import (DeltaCachePolicy, FasterCacheCFG,
                              FixedIntervalPolicy, PABPolicy, lowpass)
from .temporal import TemporalPABStack, TemporalTeaCachePolicy
from .token import ToCaPolicy


def _require_gate(gate):
    if gate is None:
        raise ValueError(
            "make_policy('lazydit') needs trained gate params: pass "
            "gate={'w': ..., 'b': ...} (repro_torch.core.init_gate, or a "
            "trained gate)")
    return gate


def _require_profile(profile):
    if profile is None:
        raise ValueError(
            "make_policy('blockcache') needs a calibration profile: pass "
            "profile=[rel-L1 change per step]")
    return profile


POLICY_REGISTRY = {
    "none": lambda **kw: NoCachePolicy(),
    "fora": lambda interval=2, **kw: FixedIntervalPolicy(interval),
    "delta_dit": lambda interval=2, **kw: DeltaCachePolicy(interval),
    "teacache": lambda delta=0.1, **kw: TeaCachePolicy(delta),
    "magcache": lambda delta=0.1, num_steps=50, **kw:
        MagCachePolicy(delta, num_steps=num_steps),
    "easycache": lambda tau=5.0, **kw: EasyCachePolicy(tau),
    "foresight": lambda gamma=1.0, **kw: ForesightPolicy(gamma),
    "taylorseer": lambda interval=4, order=2, **kw: PredictivePolicy(interval, order, "taylor"),
    "newtonseer": lambda interval=4, order=2, **kw: PredictivePolicy(interval, order, "newton"),
    "hicache": lambda interval=4, order=2, sigma=0.5, **kw: PredictivePolicy(interval, order, "hermite", sigma),
    "abcache": lambda interval=4, **kw: PredictivePolicy(interval, 2, "ab"),
    "foca": lambda interval=4, **kw: PredictivePolicy(interval, 2, "foca"),
    "freqca": lambda interval=4, cutoff=0.25, **kw: FreqCaPolicy(interval, cutoff),
    "toca": lambda interval=4, ratio=0.25, **kw: ToCaPolicy(interval, ratio),
    "lazydit": lambda gate=None, threshold=0.5, **kw:
        LazyDiTPolicy(_require_gate(gate), threshold),
    "blockcache": lambda profile=None, delta=0.1, **kw:
        BlockCachePolicy(_require_profile(profile), delta),
    "pab": lambda module_type="spatial_attn", ranges=None, **kw:
        PABPolicy(module_type, ranges),
    "clusca": lambda interval=4, k=16, **kw: ClusCaPolicy(interval, k),
    "speca": lambda interval=4, tau=0.1, **kw: SpeCaPolicy(interval, tau=tau),
    # temporal-aware TeaCache for video latent clips: `frames` must match
    # the clip's frame count — the serving engine (string path) and
    # DenoiseWorkload.make_policy inject cfg.dit_num_frames
    "teacache_video": lambda delta=0.1, frames=4, reduce="max", **kw:
        TemporalTeaCachePolicy(delta, frames, reduce=reduce),
    # CFG-branch reuse: gates the unconditional stream, so it belongs in
    # CachedDenoiser's or DiffusionServingEngine's `cfg_policy`
    "fastercache_cfg": lambda interval=4, num_steps=50, mode="extrapolate",
        **kw: FasterCacheCFG(interval, num_steps, mode=mode),
}

# Stack-structural methods are not CachePolicy instances: they own the
# layer loop instead of gating one module's output behind `apply`, so
# `make_policy` cannot build them without a block function and a layer
# count.  They are built directly:
#   dbcache   — DBCacheStack(block_fn, num_layers, front_n, back_n, threshold)
#   deepcache — CachedDenoiser(..., granularity="deepcache")
#   pab_video — TemporalPABStack(video_dit.pab_branch_fns(cfg), num_layers),
#               or CachedDenoiser(..., granularity="pab_video")
STRUCTURAL_POLICIES = {
    "dbcache": DBCacheStack,
    "deepcache": "repro_torch.diffusion.pipeline.CachedDenoiser("
                 "granularity='deepcache')",
    "pab_video": TemporalPABStack,
}

#: names of the JAX registry that wait for a later slice of the port
NOT_PORTED: dict = {}


def make_policy(name: str, **kwargs) -> CachePolicy:
    if name in STRUCTURAL_POLICIES:
        raise KeyError(
            f"'{name}' is a stack-structural method, not a module-level "
            f"policy; see repro_torch.core.STRUCTURAL_POLICIES for how to "
            f"build it")
    if name in NOT_PORTED:
        raise KeyError(f"cache policy '{name}' is not ported to repro_torch "
                       f"yet; see ROADMAP.md {NOT_PORTED[name]}")
    if name not in POLICY_REGISTRY:
        raise KeyError(f"unknown cache policy '{name}'; available: "
                       f"{sorted(POLICY_REGISTRY)}")
    return POLICY_REGISTRY[name](**kwargs)


__all__ = [
    "BASES", "BlockCachePolicy", "CachePolicy", "CachedModule",
    "CachedStack", "ClusCaPolicy", "DBCacheStack", "DeltaCachePolicy",
    "EasyCachePolicy", "FasterCacheCFG", "FixedIntervalPolicy",
    "ForesightPolicy", "FreqCaPolicy", "GatedPolicy", "LazyDiTPolicy",
    "MagCachePolicy", "NOT_PORTED", "NoCachePolicy", "PABPolicy",
    "POLICY_REGISTRY", "PredictivePolicy", "STRUCTURAL_POLICIES",
    "SlotBatchedPolicy", "SlotWant", "SpeCaPolicy", "TeaCachePolicy",
    "TemporalPABStack", "TemporalTeaCachePolicy", "ToCaPolicy",
    "cache_state_bytes", "compute_fraction", "cosine_sim",
    "forecast_from_diffs", "gate_score", "init_gate", "interval_pred",
    "kmeans", "layer_params", "lazy_trajectory_loss", "lowpass",
    "mag_ratio", "make_policy", "psnr",
    "rel_l1", "rel_l1_block", "rel_l2", "stack_slots", "static_plan",
    "train_lazy_gate", "transform_rate", "update_diff_stack",
]
