"""Online control plane on the PyTorch port: live policy retuning and a
want_compute gate learned from serving traces.

    PYTHONPATH=src python examples/torch_online_control_plane.py [--device cpu]

The three acts of `examples/online_control_plane.py` on `repro_torch`, on
the GPU unless --device says otherwise, on the same tiny DiT:

1. SmoothCache — profile the model once (rel-L1 change of consecutive
   exact outputs), derive a static compute/reuse schedule, served from the
   engine's host plan.  The strongest offline baseline.
2. OnlineTuner — quality-sweep a candidate menu once (the SmoothCache
   schedule family plus dynamic policies), then serve while a
   TelemetryWindow hook watches every tick; each retune window re-prices
   the menu with live row timings, occupancy and the measured plan time
   of device-planned policies, and rolls the pool over blue/green at a
   refill boundary when a different candidate wins — in-flight requests
   always drain under the policy that admitted them.
3. Learned want_compute — a SignalTraceLog hook on the same sessions
   records per-slot signals and probes latent trajectories; the probes
   become teacher pairs for a LazyDiT gate trained with torch autograd,
   which then serves through `make_policy("lazydit", gate=...)` on the
   row-compacted path.

`run(params, cfg, requests, ...)` holds the acts, so a caller can drive
them at another width (chip_smoke.py runs them on DiT-XL).  Weights are
random, so PSNR measures agreement with the exact trajectory on random
weights, not image quality.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import make_policy, psnr
from repro_torch.device import tree_device
from repro_torch.models import init_params, perturb_zero_init
from repro_torch.serving.control import (OnlineTuner, SignalTraceLog,
                                         SmoothCacheSchedule,
                                         TelemetryWindow, calibration_profile,
                                         fit_want_gate, probe_training_set)
from repro_torch.serving.diffusion import (SLA, DiffusionRequest,
                                           DiffusionServingEngine)

#: the JAX example's tiny DiT
CPU_CONFIG = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                  d_ff=256, dit_patch_tokens=16, dit_in_dim=8,
                  dit_num_classes=10)
STEPS, SLOTS = 8, 2


def queue(n, base=0, steps=(STEPS,)):
    """n requests, budgets cycling through `steps`, labels i mod 10."""
    return [DiffusionRequest(base + i, num_steps=steps[i % len(steps)],
                             seed=base + i, class_label=i % 10)
            for i in range(n)]


def menu(profile):
    """The tuner's candidates: no cache, TeaCache, FORA and two SmoothCache
    operating points (BlockCache on the calibration profile)."""
    return [("none", {}), ("teacache", {"delta": 0.06}),
            ("fora", {"interval": 2}),
            ("blockcache", {"profile": profile, "delta": 0.05}),
            ("blockcache", {"profile": profile, "delta": 0.2})]


def run(params, cfg, requests, *, steps=STEPS, slots=SLOTS, learned=None,
        verbose=True, log=print):
    """The three acts: `requests` go through the tuner, `learned` (default
    6 requests of `steps`) through the learned gate's engine and an exact
    one; `verbose` prints the sweep and every re-pricing.  Asserts every
    x0 is finite and the gate's loss falls.  Returns the profile, schedule,
    tuner, window, trace, teacher pairs, gate, loss history, the learned
    gate's compute fraction and PSNR, and the wall seconds of the sweep,
    the tuner's serving and the training."""
    device = tree_device(params)
    out = {}
    # -- 1. SmoothCache: calibrate once, serve statically ------------------
    log("== 1. SmoothCache static schedule ==")
    profile = calibration_profile(params, cfg, steps)
    sc = SmoothCacheSchedule(profile, alpha=0.05)
    log(f"profile (rel-L1/step): {[f'{p:.3f}' for p in profile]}")
    log(f"schedule alpha={sc.alpha}: {sc.static_schedule(steps)} "
        f"(compute fraction {sc.compute_fraction:.2f})")
    out.update(profile=profile, schedule=sc.static_schedule(steps),
               compute_fraction=sc.compute_fraction)

    # -- 2. OnlineTuner: sweep once, re-price live, roll over blue/green ---
    log("\n== 2. online tuner ==")
    window = TelemetryWindow(max_ticks=128)
    trace = SignalTraceLog(probe_every=2, max_probes=6,
                           max_probe_steps=steps)
    t0 = time.perf_counter()
    tuner = OnlineTuner(params, cfg, SLA(min_psnr=15.0), slots=slots,
                        max_steps=steps, candidates=menu(profile),
                        retune_every=6, min_window_ticks=4,
                        initial=("none", {}), window=window, trace=trace,
                        verbose=verbose)
    out["sweep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tuner.submit_all(requests)
    results = tuner.drain()
    out["serve_s"] = time.perf_counter() - t0
    assert len(results) == len(requests)
    assert all(np.isfinite(r.x0).all() for r in results)
    log(f"served {len(results)} requests; policy now "
        f"'{tuner.current.policy_name}' after {len(tuner.swaps)} swap(s)")
    for sw in tuner.swaps:
        log(f"  swap @tick {sw['tick']}: {sw['from'][0]} -> {sw['to'][0]} "
            f"(row_time={sw['row_time_ms']}, "
            f"plan={sw['plan_time_ms']:.2f}ms)")
    w = window.summary()
    log(f"window: row_time={w['row_time_ms']:.2f}ms "
        f"occupancy={w['occupancy']} plan_time={w['plan_time_ms']:.2f}ms "
        f"compute_fraction={w['compute_fraction']:.2f}")
    out.update(tuner=tuner, window=window, trace=trace, results=results)

    # -- 3. learned want_compute from the serving traces -------------------
    log("\n== 3. learned want_compute gate from logged traces ==")
    log(f"trace: {trace.summary()}")
    pairs = probe_training_set(params, cfg, trace)
    t0 = time.perf_counter()
    gate, hist = fit_want_gate(torch.Generator(device=device).manual_seed(1),
                               pairs, steps=120)
    out["train_s"] = time.perf_counter() - t0     # the history's read syncs
    log(f"trained on {len(pairs)} probe trajectories: "
        f"loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    assert hist[-1] < hist[0], "the gate's loss did not fall"

    reqs = learned if learned is not None else queue(6, base=100,
                                                    steps=(steps,))
    eng = DiffusionServingEngine(params, cfg,
                                 make_policy("lazydit", gate=gate,
                                             threshold=0.5),
                                 slots=slots, max_steps=steps, device=device)
    ref_eng = DiffusionServingEngine(params, cfg, "none", slots=slots,
                                     max_steps=steps, device=device)
    got = {r.request_id: r for r in eng.serve(reqs)}
    ref = {r.request_id: r.x0 for r in ref_eng.serve(reqs)}
    assert all(np.isfinite(g.x0).all() for g in got.values())
    cf = float(np.mean([g.record.compute_fraction for g in got.values()]))
    q = float(np.mean([float(psnr(torch.as_tensor(ref[i]),
                                  torch.as_tensor(got[i].x0)))
                       for i in got]))
    log(f"learned gate served {len(got)} requests: "
        f"compute fraction {cf:.2f}, {q:.1f}dB vs exact")
    out.update(pairs=pairs, gate=gate, hist=hist, learned_cf=cf,
               learned_psnr=q, learned_results=got)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    device = parser.parse_args().device
    cfg = get_config("dit-xl").reduced(**CPU_CONFIG)
    gen = torch.Generator(device=device).manual_seed(0)
    params = perturb_zero_init(init_params(gen, cfg, device=device), gen)
    run(params, cfg, queue(10))
    print("\nOK")


if __name__ == "__main__":
    main()
