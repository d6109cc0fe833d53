"""Diffusion language model + caching on the PyTorch port (the survey's
§IV-F, dLLM-Cache).

    PYTHONPATH=src python examples/torch_diffusion_lm.py [--device cpu]

The steps of `examples/diffusion_lm.py` on `repro_torch`: LLaDA-style
mask-denoising generation on the tinyllama-1.1b SMOKE backbone, exact
against FORA, TaylorSeer and TeaCache, reporting full-compute counts and
token agreement with the exact canvas.  Runs on the GPU unless --device
says otherwise; the weights come from a torch generator, so the tokens
differ from the JAX example's.
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import make_policy
from repro_torch.diffusion.dlm import dlm_generate
from repro_torch.models import init_params

B, S, T = 2, 24, 8
POLICIES = [("fora", {"interval": 2}), ("taylorseer", {"interval": 2}),
            ("teacache", {"delta": 0.3})]


def run(device="cuda", log=print, arch="tinyllama-1.1b", cfg=None,
        batch=B, seq_len=S, num_steps=T, policies=POLICIES):
    """Exact and cached generation; returns {policy: (canvas, computes)}."""
    cfg = cfg or get_smoke_config(arch)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    ref, n_ref = dlm_generate(params, cfg, batch=batch, seq_len=seq_len,
                              num_steps=num_steps)
    log(f"exact: {n_ref}/{num_steps} full computes | canvas[0, :12] = "
        f"{ref[0, :12].tolist()}")
    out = {"none": (ref, n_ref)}
    for name, kw in policies:
        tokens, n = dlm_generate(params, cfg, batch=batch, seq_len=seq_len,
                                 num_steps=num_steps,
                                 policy=make_policy(name, **kw))
        agree = float((tokens == ref).float().mean())
        log(f"{name:11s}: {n}/{num_steps} full computes, token agreement "
            f"{agree:.2f}")
        out[name] = (tokens, n)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    res = run(parser.parse_args().device)
    assert all(int(t.max()) < get_smoke_config("tinyllama-1.1b").vocab_size - 1
               for t, _ in res.values()), "mask tokens remain"
    print("OK")
