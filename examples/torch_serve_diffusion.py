"""Cache-aware diffusion serving on the PyTorch port: continuous batching
with per-slot caches.

    PYTHONPATH=src python examples/torch_serve_diffusion.py [--device cpu]

The steps of `examples/serve_diffusion.py` on `repro_torch`, on the GPU
unless --device says otherwise:

  1. the SLA autotuner picks a cache policy per traffic class
     ("interactive" previews tolerate lower PSNR, "quality" renders not);
  2. a queue of 20 requests with mixed step budgets (8 and 16) flows
     through 6 slots, each traffic class under its tuned policy;
  3. guided and unguided requests share one slot pool whose slots each
     carry a FasterCacheCFG state that reuses the unconditional branch;
     every tick gathers exactly the cond and uncond rows that are wanted.

`run(params, cfg, device, log)` holds the three steps, so a caller can
drive them at another width (chip_smoke.py serves DiT-XL through it).
Weights are random, so PSNR measures agreement with the exact trajectory
on random weights, not image quality.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import FasterCacheCFG
from repro_torch.diffusion import linear_schedule
from repro_torch.models import init_params, perturb_zero_init
from repro_torch.serving.diffusion import (SLA, DiffusionRequest,
                                           DiffusionServingEngine,
                                           autotune_traffic_classes)

#: the JAX example's CPU-sized DiT
CPU_CONFIG = dict(num_layers=6, d_model=256, num_heads=4, num_kv_heads=4,
                  d_ff=1024, dit_patch_tokens=64, dit_in_dim=16,
                  dit_num_classes=10)


def run(params, cfg, device, log=print):
    """The three steps on `params` / `cfg` on `device`; asserts that every
    request finishes with a finite x0.  Returns, per traffic class, the
    pick and its serving summary, step 3's summary and tick mix, and the
    autotune's wall seconds."""
    noise_sched = linear_schedule(1000)
    out = {"tuned": {}, "served": {}}

    # -- 1. autotune: pick a policy per traffic class against its SLA -----
    slas = {
        "interactive": SLA("interactive", min_psnr=-100.0),  # latency first
        "quality": SLA("quality", min_psnr=40.0),            # near-exact
    }
    log("== autotuning policies per traffic class ==")
    t0 = time.perf_counter()
    tuned = autotune_traffic_classes(params, cfg, slas, num_steps=16,
                                     noise_schedule=noise_sched, verbose=True)
    out["autotune_s"] = time.perf_counter() - t0
    log(f"  (autotune {out['autotune_s']:.2f}s wall)")
    for tc, t in tuned.items():
        log(f"  {tc:12s} -> {t.policy_name} {t.kwargs} "
            f"(psnr={t.psnr:.1f}dB, compute_fraction={t.compute_fraction:.2f})")
        out["tuned"][tc] = t

    # -- 2. serve a mixed-budget queue per traffic class ------------------
    requests = [DiffusionRequest(i, num_steps=8 if i % 2 == 0 else 16,
                                 seed=i, class_label=i % cfg.dit_num_classes,
                                 traffic_class="interactive" if i % 2 == 0
                                 else "quality")
                for i in range(20)]
    for tc, t in tuned.items():
        batch = [r for r in requests if r.traffic_class == tc]
        eng = DiffusionServingEngine(params, cfg, t.make(), slots=6,
                                     max_steps=16, noise_schedule=noise_sched,
                                     align=t.align, device=device)
        results = eng.serve(batch)
        s = eng.telemetry.summary()
        assert len(results) == len(batch)
        assert all(np.isfinite(r.x0).all() for r in results)
        out["served"][tc] = s
        log(f"\n== {tc}: {len(batch)} requests via {t.policy_name} ==")
        log(f"  throughput      : {s['throughput_rps']:.2f} req/s")
        log(f"  latency p50/p95 : {s['latency_p50_s']:.3f}s / "
            f"{s['latency_p95_s']:.3f}s")
        log(f"  compute fraction: {s['compute_fraction_mean']:.3f} "
            f"(cache hit rate {s['cache_hit_rate_mean']:.3f})")
        log(f"  ticks           : {s['ticks']} "
            f"({100 * s['full_tick_fraction']:.0f}% ran the backbone; "
            f"backbone {s['tick_ms_cond_mean']:.1f}ms vs "
            f"skip {s['tick_ms_skip_mean']:.1f}ms)")
        log(f"  cache state     : {s['cache_state_bytes_per_slot']} B/slot")
        for r in results[:4]:
            rec = r.record
            log(f"    req {rec.request_id:2d}: {rec.num_steps:2d} steps, "
                f"latency {rec.latency:.3f}s (queued {rec.queue_wait:.3f}s), "
                f"computed {rec.computed_steps}/{rec.num_steps}")

    # -- 3. guided + unguided requests through one CFG-aware slot pool ----
    # cfg_scale > 0 makes a request guided: a second (unconditional)
    # backbone branch, blended eps = e_u + s (e_c - e_u); FasterCacheCFG per
    # slot reuses the uncond branch between refreshes, so most backbone
    # ticks drop the uncond rows
    guided_requests = [
        DiffusionRequest(100 + i, num_steps=16, seed=i,
                         class_label=i % cfg.dit_num_classes,
                         cfg_scale=4.0 if i % 2 == 0 else 0.0)
        for i in range(12)]
    eng = DiffusionServingEngine(params, cfg, "fora", slots=6, max_steps=16,
                                 noise_schedule=noise_sched,
                                 cfg_policy=FasterCacheCFG(interval=4,
                                                           num_steps=16),
                                 device=device)
    results = eng.serve(guided_requests)
    s = eng.telemetry.summary()
    tel = eng.telemetry
    assert len(results) == len(guided_requests)
    assert all(np.isfinite(r.x0).all() for r in results)
    out["guided"] = s
    out["tick_mix"] = (tel.ticks_full, tel.ticks_cond, tel.ticks_skip)
    log(f"\n== mixed guided/unguided: {len(guided_requests)} requests "
        f"({s['guided_requests']} guided @ cfg_scale=4.0) ==")
    log(f"  throughput      : {s['throughput_rps']:.2f} req/s")
    log(f"  tick mix        : {tel.ticks_full} w/ uncond rows / "
        f"{tel.ticks_cond} cond-only / {tel.ticks_skip} skip")
    log(f"  backbone rows   : {s['backbone_rows_computed']} computed "
        f"(+{s['backbone_rows_padding']} bucket padding), "
        f"{s['backbone_rows_saved']} saved vs dense whole-pool ticks "
        f"({s['backbone_rows_per_tick_mean']:.1f} rows/backbone tick)")
    log(f"  uncond rows     : {s['uncond_rows_computed']} dispatched, "
        f"{s['uncond_rows_saved']} saved by CFG reuse "
        f"({s['uncond_saved_steps_total']} uncond computes saved "
        f"across guided requests)")
    for r in results[:4]:
        rec = r.record
        tag = (f"guided, uncond {rec.uncond_computed_steps}/{rec.num_steps}"
               if rec.guided else "unguided")
        log(f"    req {rec.request_id:3d}: computed "
            f"{rec.computed_steps}/{rec.num_steps} cond ({tag})")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    device = parser.parse_args().device
    cfg = get_config("dit-xl").reduced(**CPU_CONFIG)
    gen = torch.Generator(device=device).manual_seed(0)
    params = perturb_zero_init(init_params(gen, cfg, device=device), gen)
    run(params, cfg, device)
    print("\nOK")


if __name__ == "__main__":
    main()
