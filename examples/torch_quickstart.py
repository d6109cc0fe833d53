"""Quickstart on the PyTorch port: cached diffusion sampling in ~30 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The steps of `examples/quickstart.py` on `repro_torch`: builds a small DiT,
samples once exactly and once under TaylorSeer ("Cache-Then-Forecast", the
survey's headline method), and reports the compute saving and the output
agreement.  Runs on the GPU unless --device says otherwise.  Weights and
noise come from torch generators, so the numbers differ from the JAX
example's.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import make_policy
from repro_torch.diffusion import CachedDenoiser, ddim_step, linear_schedule, sample
from repro_torch.diffusion.pipeline import cfg_denoise_fn
from repro_torch.models import init_params, perturb_zero_init

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# 1. a small DiT (the zoo's dit-xl config, reduced for CPU)
cfg = get_config("dit-xl").reduced(num_layers=6, d_model=256, num_heads=4,
                                   num_kv_heads=4, d_ff=1024,
                                   dit_patch_tokens=64, dit_num_classes=10)
gen = torch.Generator(device=device).manual_seed(0)
params = perturb_zero_init(init_params(gen, cfg, device=device), gen)

# 2. a 40-step DDIM trajectory
sched = linear_schedule(1000)
timesteps = sched.spaced(40)
x_T = torch.randn((2, cfg.dit_patch_tokens, cfg.dit_in_dim), device=device,
                  generator=torch.Generator(device=device).manual_seed(1))

# 3. exact baseline
exact_fn = cfg_denoise_fn(params, cfg, cfg_scale=0.0)
x0_exact, _ = sample(exact_fn, x_T, timesteps, sched, step_fn=ddim_step)

# 4. cached: TaylorSeer forecasts 3 of every 4 steps (survey Eq. 42)
policy = make_policy("taylorseer", interval=4, order=2)
denoiser = CachedDenoiser(params, cfg, policy, granularity="model",
                          device=device)
x0_cached, _ = sample(denoiser, x_T, timesteps, sched, step_fn=ddim_step,
                      denoiser_state=denoiser.init_state(2))

# DDIM from t = 999 scales this random model's x0 to an RMS of ~200, so the
# agreement is stated relative to the exact output's norm
mse = float(((x0_cached - x0_exact) ** 2).mean())
rel = float((x0_cached - x0_exact).norm() / x0_exact.norm())
sched_mask = policy.static_schedule(40)
print(f"full model evaluations: {sum(sched_mask)}/40 "
      f"(speedup ~{40/sum(sched_mask):.1f}x)")
print(f"output MSE vs exact: {mse:.2e} (relative L2 error {rel:.3f})")
assert rel == rel and rel < 0.2
print("OK")
