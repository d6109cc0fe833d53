"""repro_torch.modalities — multi-modal denoise workloads for the port's
cache stack (the JAX `repro.modalities`).

  spec     — ModalitySpec / DenoiseWorkload: image latents, video latent
             clips (frame axis, factorized spatio-temporal backbone), audio
             mel-spectrograms, each bound to a config + params and turned
             into what the cache policies, the cached pipeline and the
             serving engine consume.
  serving  — MixedModalityEngine: per-modality sub-pools interleaved tick
             by tick under one loop, with per-modality row accounting
             (MixedTelemetry) and an autotune umbrella (autotune_pools).

Temporal-aware caching lives in repro_torch.core.temporal
(TemporalTeaCachePolicy = "teacache_video"; TemporalPABStack =
"pab_video"), wired to the video backbone through
DenoiseWorkload.make_policy / .pab_stack.
"""
from .serving import MixedModalityEngine, MixedTelemetry, autotune_pools
from .spec import (MODALITIES, DenoiseWorkload, ModalitySpec, get_modality,
                   make_workload)

__all__ = [
    "MODALITIES", "ModalitySpec", "DenoiseWorkload", "get_modality",
    "make_workload",
    "MixedModalityEngine", "MixedTelemetry", "autotune_pools",
]
