"""Mixed-modality cache-aware serving on the PyTorch port.

    PYTHONPATH=src python examples/torch_mixed_modality_serving.py [--device cpu]

The steps of `examples/mixed_modality_serving.py` on `repro_torch`, on the
GPU unless --device says otherwise: three denoise workloads — image latents
(DiT-XL shape), video latent clips (the factorized spatio-temporal DiT) and
audio mel-spectrograms — at their SMOKE size; a cache policy autotuned per
modality against one SLA (the video sweep adds teacache_video); then a
mixed image + video + audio queue served through per-modality sub-pools
under MixedModalityEngine, with per-modality row accounting.

`run(workloads, log)` holds the steps, so a caller can drive them at
another width (chip_smoke.py serves the full-width models through it).
Weights are random, so PSNR measures agreement with the exact trajectory
on random weights, not quality.
"""
import argparse
import time

import numpy as np

from repro_torch.core import FasterCacheCFG
from repro_torch.modalities import (MixedModalityEngine, autotune_pools,
                                    make_workload)
from repro_torch.serving.diffusion import SLA, DiffusionRequest

NUM_STEPS = 12
SLOTS = 2
MODALITIES = ("image", "video", "audio")


def requests(workloads):
    """The example's queue: 9 requests cycling image, video, audio with
    budgets 12 and 8; image requests guided at 3.0, request 0 with a
    negative-prompt conditioning vector."""
    neg = np.random.RandomState(0).randn(
        workloads["image"].cfg.d_model).astype(np.float32) * 0.1
    return [
        DiffusionRequest(i, num_steps=NUM_STEPS - 4 * (i % 2), seed=i,
                         class_label=i % 5, modality=MODALITIES[i % 3],
                         cfg_scale=3.0 if MODALITIES[i % 3] == "image"
                         else 0.0,
                         null_label=neg if i == 0 else None)
        for i in range(9)]


def run(workloads, log=print):
    """Autotune per modality, build the pools, serve the mixed queue;
    asserts every x0 is finite.  Returns the picks, each modality's
    autotune wall seconds, the engine (its `telemetry` holds the serving
    summary) and the results."""
    for name, wl in workloads.items():
        log(f"{name:6s} latent {wl.latent_shape()}  frames={wl.frames}  "
            f"backbone={wl.cfg.name}")

    # one SLA-driven sweep per modality (video adds a temporal candidate);
    # random-weight backbones cache poorly, so the SLA floor is permissive
    log("\nautotuning per modality ...")
    tuned, tune_s = {}, {}
    for name, wl in workloads.items():
        t0 = time.perf_counter()
        tuned[name] = autotune_pools({name: wl}, SLA(min_psnr=12.0),
                                     num_steps=NUM_STEPS)[name]
        tune_s[name] = time.perf_counter() - t0
        t = tuned[name]
        log(f"  {name:6s} -> {t.policy_name} {t.kwargs} "
            f"(psnr={t.psnr:.1f}dB cf={t.compute_fraction:.2f}, "
            f"{tune_s[name]:.2f}s)")

    pools = {
        name: wl.engine(tuned[name].make(), slots=SLOTS,
                        max_steps=NUM_STEPS,
                        # guided image requests reuse the uncond branch
                        cfg_policy=(FasterCacheCFG(4, NUM_STEPS)
                                    if name == "image" else None))
        for name, wl in workloads.items()}
    engine = MixedModalityEngine(pools)
    engine.warmup()          # every sub-pool's buckets once

    results = engine.serve(requests(workloads))
    s = engine.telemetry.summary()
    log(f"\nserved {s['requests']} requests in {s['elapsed_s']:.2f}s "
        f"({s['throughput_rps']:.2f} req/s)")
    log(f"backbone rows computed {s['backbone_rows_computed']} "
        f"(saved {s['backbone_rows_saved']}); token-weighted "
        f"{s['backbone_tokens_computed']} "
        f"(saved {s['backbone_tokens_saved']})")
    log("\nper-modality pools:")
    for m, ms in engine.telemetry.by_modality().items():
        log(f"  {m:6s} reqs={ms['requests']} "
            f"rows={ms['backbone_rows_computed']:4d} "
            f"saved={ms['backbone_rows_saved']:4d} "
            f"cf={ms['compute_fraction_mean']:.2f} "
            f"p50={ms['latency_p50_s']:.3f}s")
    assert len(results) == 9
    assert all(np.isfinite(r.x0).all() for r in results)
    return {"tuned": tuned, "autotune_s": tune_s, "engine": engine,
            "results": results}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    device = parser.parse_args().device
    workloads = {m: make_workload(m, smoke=True, device=device)
                 for m in MODALITIES}
    run(workloads)
    print("\nOK")


if __name__ == "__main__":
    main()
