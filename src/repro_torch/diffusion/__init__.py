"""repro_torch.diffusion — noise schedules, the DDIM sampler and the cached
pipeline of the port."""
from .schedules import NoiseSchedule, linear_schedule
from .samplers import ddim_step, sample
from .pipeline import CachedDenoiser, cfg_denoise_fn

__all__ = [
    "NoiseSchedule", "linear_schedule", "ddim_step",
    "sample", "CachedDenoiser", "cfg_denoise_fn",
]
