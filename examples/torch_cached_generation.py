"""Policy zoo tour on the PyTorch port: every surveyed cache family on one
sampling problem.

    PYTHONPATH=src python examples/torch_cached_generation.py [--device cpu]

The steps of `examples/cached_generation.py` on `repro_torch`: static
(FORA, Δ-DiT), timestep-adaptive (TeaCache, MagCache, EasyCache),
predictive (TaylorSeer, HiCache, FoCa, AB-Cache, FreqCa), token-wise
(ToCa) and hybrid (ClusCa, SpeCa) policies, plus DeepCache-style
structural splitting and CFG-branch caching (FasterCache), each sampled
from the same noise with CFG 1.5 and scored by PSNR against the exact
trajectory.  On random weights a PSNR measures agreement with the exact
sample, not quality (about -25 to -14 dB here, as in the JAX example), so
nothing is asserted on it.  Runs on the GPU unless --device says
otherwise; weights and noise come from torch generators.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import make_policy
from repro_torch.core.metrics import psnr
from repro_torch.core.static_policies import FasterCacheCFG
from repro_torch.diffusion import (CachedDenoiser, ddim_step, linear_schedule,
                                   sample)
from repro_torch.diffusion.pipeline import cfg_denoise_fn
from repro_torch.models import init_params, perturb_zero_init

NUM_STEPS = 40

ZOO = [
    ("fora (static, N=4)", "fora", {"interval": 4}, "model"),
    ("delta-dit (residual, deepcache split)", "delta_dit", {"interval": 4},
     "deepcache"),
    ("teacache (adaptive, d=0.15)", "teacache", {"delta": 0.15}, "model"),
    ("magcache (d=0.06)", "magcache", {"delta": 0.06}, "model"),
    ("easycache (tau=3)", "easycache", {"tau": 3.0}, "model"),
    ("taylorseer (N=4, m=2)", "taylorseer", {"interval": 4}, "model"),
    ("hicache (hermite)", "hicache", {"interval": 4}, "model"),
    ("foca (BDF2+Heun)", "foca", {"interval": 4}, "model"),
    ("abcache (adams-bashforth)", "abcache", {"interval": 4}, "model"),
    ("freqca (freq split + CRF)", "freqca", {"interval": 4}, "model"),
    ("toca (token-wise, Eq. 19-21)", "toca", {"interval": 4, "ratio": 0.25},
     "model"),
    ("clusca (token clusters)", "clusca", {"interval": 4, "k": 8}, "block"),
    ("speca (speculative)", "speca", {"interval": 4, "tau": 0.1}, "model"),
]


def run(device="cuda", log=print):
    """Sample the zoo; returns {label: PSNR against the exact x0 in dB}."""
    cfg = get_config("dit-xl").reduced(num_layers=6, d_model=256,
                                       num_heads=4, num_kv_heads=4,
                                       d_ff=1024, dit_patch_tokens=64,
                                       dit_num_classes=10)
    gen = torch.Generator(device=device).manual_seed(0)
    params = perturb_zero_init(init_params(gen, cfg, device=device), gen)
    sched = linear_schedule(1000)
    ts = sched.spaced(NUM_STEPS)
    x_T = torch.randn((2, cfg.dit_patch_tokens, cfg.dit_in_dim),
                      device=device,
                      generator=torch.Generator(device=device).manual_seed(1))
    exact, _ = sample(cfg_denoise_fn(params, cfg, 1.5), x_T, ts, sched,
                      step_fn=ddim_step)

    def score(label, den):
        x0, _ = sample(den, x_T, ts, sched, step_fn=ddim_step,
                       denoiser_state=den.init_state(2))
        out[label] = float(psnr(x0, exact))
        log(f"{label:42s} {out[label]:14.1f}")

    out = {}
    log(f"{'policy':42s} {'PSNR vs exact':>14s}")
    for label, name, kw, gran in ZOO:
        score(label, CachedDenoiser(params, cfg, make_policy(name, **kw),
                                    granularity=gran, cfg_scale=1.5,
                                    device=device))
    # CFG-branch caching on top of a feature cache (FasterCache §III-C)
    score("taylorseer + fastercache-CFG",
          CachedDenoiser(params, cfg, make_policy("taylorseer", interval=4),
                         cfg_scale=1.5,
                         cfg_policy=FasterCacheCFG(2, NUM_STEPS),
                         device=device))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(parser.parse_args().device)
    print("OK")
