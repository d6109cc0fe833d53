"""Optimizer and learning-rate schedule of the port (no torch.optim): the
port of the JAX package's `repro.optim`."""
from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    clip_scale, cosine_warmup_schedule, global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "clip_scale", "cosine_warmup_schedule"]
