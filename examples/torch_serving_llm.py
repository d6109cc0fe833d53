"""Batched LLM serving across the architecture zoo, on the PyTorch port.

    PYTHONPATH=src python examples/torch_serving_llm.py [--device cpu]

The steps of `examples/serving_llm.py` on `repro_torch`: the ServingEngine
(prefill + rolling-cache greedy decode) over one architecture from each
family (dense GQA, MoE + MLA, pure SSM, hybrid) at SMOKE size, showing
that decode_step / prefill and the cache containers work across the
families; whisper-small, an encoder-decoder, is served through
`models.encdec` instead.  Runs on the GPU unless --device says otherwise;
the weights come from a torch generator, so the tokens differ from the
JAX example's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine

ARCHS = ["tinyllama-1.1b", "deepseek-v2-236b", "falcon-mamba-7b",
         "zamba2-2.7b", "whisper-small"]


def run(device="cuda", log=print, archs=ARCHS):
    """Serve 6 prompts over 4 slots per architecture; returns {arch:
    results}."""
    rng = np.random.default_rng(0)
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        if cfg.is_encoder_decoder:
            log(f"{arch:18s}: enc-dec — served via decode_step with exact "
                f"cross-KV (see tests/test_torch_encdec.py)")
            continue
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
        engine = ServingEngine(params, cfg, slots=4, cache_len=64,
                               max_prompt=16, device=device)
        prompts = [rng.integers(1, cfg.vocab_size,
                                size=rng.integers(3, 12)).tolist()
                   for _ in range(6)]
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=12)
        dt = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in res)
        log(f"{arch:18s}: {len(res)} reqs, {toks} tokens, {toks / dt:5.1f} "
            f"tok/s | e.g. {res[0].tokens[:8]}")
        out[arch] = res
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    res = run(parser.parse_args().device)
    assert all(len(r.tokens) == 12 for rs in res.values() for r in rs)
    print("OK")
