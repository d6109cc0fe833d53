"""repro_torch.diffusion — noise schedules (linear, cosine, the
rectified-flow grid), samplers (DDPM, DDIM, DPM-Solver++(2M),
rectified-flow Euler) and the cached pipeline of the port."""
from .schedules import (NoiseSchedule, cosine_schedule, linear_schedule,
                        rectified_flow_times)
from .samplers import (ddim_step, ddpm_step, dpmpp_2m_step, rf_euler_step,
                       sample)
from .pipeline import CachedDenoiser, cfg_denoise_fn

__all__ = [
    "NoiseSchedule", "linear_schedule", "cosine_schedule",
    "rectified_flow_times", "ddpm_step", "ddim_step", "dpmpp_2m_step",
    "rf_euler_step", "sample", "CachedDenoiser", "cfg_denoise_fn",
]
