"""repro_torch.core — the cache-policy library of the port.

Ported so far: NoCachePolicy, FixedIntervalPolicy (FORA) and
PredictivePolicy with the taylor, newton, hermite and ab bases.  The other
names of the JAX registry raise KeyError pointing at ROADMAP.md.
"""
from .engine import (CachedModule, SlotBatchedPolicy, cache_state_bytes,
                     stack_slots)
from .policy import CachePolicy, NoCachePolicy, interval_pred
from .predictive import (BASES, PredictivePolicy, forecast_from_diffs,
                         update_diff_stack)
from .static_policies import FixedIntervalPolicy

POLICY_REGISTRY = {
    "none": lambda **kw: NoCachePolicy(),
    "fora": lambda interval=2, **kw: FixedIntervalPolicy(interval),
    "taylorseer": lambda interval=4, order=2, **kw: PredictivePolicy(interval, order, "taylor"),
    "newtonseer": lambda interval=4, order=2, **kw: PredictivePolicy(interval, order, "newton"),
    "hicache": lambda interval=4, order=2, sigma=0.5, **kw: PredictivePolicy(interval, order, "hermite", sigma),
    "abcache": lambda interval=4, **kw: PredictivePolicy(interval, 2, "ab"),
}


def make_policy(name: str, **kwargs) -> CachePolicy:
    if name not in POLICY_REGISTRY:
        raise KeyError(f"cache policy '{name}' is not ported to repro_torch "
                       f"yet (ported: {sorted(POLICY_REGISTRY)}); see "
                       f"ROADMAP.md §A")
    return POLICY_REGISTRY[name](**kwargs)


__all__ = [
    "BASES", "CachePolicy", "CachedModule", "FixedIntervalPolicy",
    "NoCachePolicy", "POLICY_REGISTRY", "PredictivePolicy",
    "SlotBatchedPolicy", "cache_state_bytes",
    "forecast_from_diffs", "interval_pred", "make_policy", "stack_slots",
    "update_diff_stack",
]
