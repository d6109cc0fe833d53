"""Text-to-image cache-aware serving on the PyTorch port.

    PYTHONPATH=src python examples/torch_text_to_image_serving.py [--device cpu]

The steps of `examples/text_to_image_serving.py` on `repro_torch`, on the
GPU unless --device says otherwise: the t2i workload (the image DiT with an
AdaLN-zero-gated cross-attention branch over prompt embeddings) at its
SMOKE size, its text encoder behind a PromptCache, and a prompted guided
queue where a few popular prompts repeat, as real T2I traffic does.  What
the conditioning stack pays, and how often:

  * text encoder: once per unique prompt (PromptCache content-hash LRU),
  * cross-attention K/V projection: once per admission wave (the per-slot
    text tables),
  * per tick: nothing — the text K/V are operands of the tick.

`run(workload, log)` holds the steps, so a caller can drive them at
another width (chip_smoke.py serves the full-width model through it).
"""
import argparse

import numpy as np

from repro_torch.core import FasterCacheCFG, make_policy
from repro_torch.modalities import make_workload
from repro_torch.serving.diffusion import DiffusionRequest

NUM_STEPS = 12
SLOTS = 2
NEG_PROMPT = "blurry, low quality"

PROMPTS = [
    "a photo of a red fox in the snow",
    "a watercolor painting of a lighthouse",
    "a photo of a red fox in the snow",       # repeat: cache hit
    "an isometric render of a tiny city",
    "a watercolor painting of a lighthouse",  # repeat: cache hit
    "a photo of a red fox in the snow",       # repeat: cache hit
]


def requests():
    """The example's queue: the 6 prompts guided at 3.0; request 0 adds a
    negative prompt, which rides the uncond branch's null vector and text
    tables under CFG."""
    return [DiffusionRequest(
        i, num_steps=NUM_STEPS, seed=i, cfg_scale=3.0, prompt_tokens=p,
        neg_prompt_tokens=NEG_PROMPT if i == 0 else None)
        for i, p in enumerate(PROMPTS)]


def run(wl, log=print):
    """Build the conditioner and the TeaCache + FasterCacheCFG engine, warm
    them up, serve the prompted queue; asserts every x0 is finite, the
    encoder ran once per unique prompt and a repeated prompt is an identity
    hit.  Returns the conditioner, the engine (its `telemetry` holds the
    serving summary), the warmup's runs and the results."""
    log(f"t2i latent {wl.latent_shape()}  backbone={wl.cfg.name}  "
        f"text_len={wl.cfg.dit_text_len}")
    conditioner = wl.conditioner()            # PromptCache + text encoder
    engine = wl.engine(make_policy("teacache", delta=0.1), slots=SLOTS,
                       max_steps=NUM_STEPS,
                       cfg_policy=FasterCacheCFG(4, NUM_STEPS),
                       conditioner=conditioner)
    runs = engine.warmup()       # buckets, then text_kv and text_encoder
    text_runs = sorted(r for r in runs if isinstance(r, str)
                       and r.startswith("text"))
    log(f"warmup ran {len(runs)} programs (text-side: {text_runs})")

    reqs = requests()
    results = engine.serve(reqs)
    assert all(np.isfinite(r.x0).all() for r in results)

    s = engine.telemetry.summary()
    log(f"\nserved {s['requests']} prompted requests in "
        f"{s['elapsed_s']:.2f}s ({s['throughput_rps']:.2f} req/s)")
    log(f"backbone rows computed {s['backbone_rows_computed']} "
        f"(saved {s['backbone_rows_saved']}); text tables built "
        f"{engine.text_table_builds} times")

    st = conditioner.stats
    log(f"\nprompt cache: {st['misses']} encoder runs for "
        f"{len(reqs) + 1} prompt resolutions "
        f"({st['hits']} hits, hit rate {st['hit_rate']:.2f})")
    assert st["misses"] == len(set(PROMPTS) | {NEG_PROMPT})
    # the same prompt, re-submitted, is a host-side dict hit: the embedding
    # (and the per-slot K/V built from it) never recompute
    pe = conditioner.get(PROMPTS[0])
    assert conditioner.get(PROMPTS[0]) is pe
    return {"conditioner": conditioner, "engine": engine, "warmup": runs,
            "results": results}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    run(make_workload("t2i", smoke=True, device=parser.parse_args().device))
    print("\nOK")


if __name__ == "__main__":
    main()
