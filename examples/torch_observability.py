"""Observability end to end on the PyTorch port: trace, metrics and program
profiles from one mixed-modality serving session.

    PYTHONPATH=src python examples/torch_observability.py [OUTDIR] [--device cpu]

The steps of `examples/observability.py` on `repro_torch`, on the GPU
unless --device says otherwise: a mixed image + video queue (TeaCache on
both pools, FasterCacheCFG(4, 8) uncond reuse on the image pool) served
with the full repro_torch.obs surface attached, then written to OUTDIR
(default: `repro_torch_obs` under the system's temporary directory):

  trace.json          Chrome/Perfetto trace — one process per modality
                      sub-pool, plan/backbone tracks, per-slot cache
                      lifecycle spans (admit -> compute/reuse annotated
                      with signal vs threshold -> finish).  Open it at
                      https://ui.perfetto.dev or chrome://tracing.
  cache_events.jsonl  one line per active slot per tick — the durable
                      SignalTraceLog: `signal_trace_from_files` rebuilds
                      a trainable trace from it after the process exits.
  metrics.prom        Prometheus text exposition of every counter/gauge/
                      histogram the engines + schedulers published.
  metrics.json        the same registry as a JSON snapshot (+ event ring).

It also prints warmup's per-program first-run seconds and FLOPs
(`engine.pools[m].program_profile`) and the measured redundancy ratio
(FLOPs the caches avoided over the dense FLOPs a no-cache pool would have
dispatched), and reconciles the JSONL against ServingTelemetry:
per-request computed and uncond steps must agree EXACTLY.

`run(workloads, outdir, log)` holds the steps, so a caller can drive them
at another width (chip_smoke.py serves DiT-XL and dit-video through it).
"""
import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.core import FasterCacheCFG
from repro_torch.modalities import MixedModalityEngine, make_workload
from repro_torch.obs import (MetricsRegistry, TraceRecorder, flops_per_row,
                             redundancy_ratio, validate_chrome_trace)
from repro_torch.serving.diffusion import DiffusionRequest

NUM_STEPS = 8
SLOTS = 2
MODALITIES = ("image", "video")
ARTIFACTS = ("trace.json", "cache_events.jsonl", "metrics.prom",
             "metrics.json")


def requests():
    """The example's queue: 8 requests alternating image and video, the
    image ones guided at 3.0; budgets staggered WITHIN each pool (8 and 6)
    — uniform queues tick in lockstep (every slot wants compute on the same
    ticks), which hides the row savings the redundancy ratio prices."""
    return [DiffusionRequest(i, num_steps=NUM_STEPS - 2 * ((i // 2) % 2),
                             seed=i, class_label=i % 5,
                             modality=MODALITIES[i % 2],
                             cfg_scale=3.0 if MODALITIES[i % 2] == "image"
                             else 0.0)
            for i in range(8)]


def build_engine(workloads):
    """One TeaCache pool per modality; the image pool also reuses the
    uncond branch under FasterCacheCFG(4, NUM_STEPS)."""
    return MixedModalityEngine({
        name: wl.engine("teacache", slots=SLOTS, max_steps=NUM_STEPS,
                        cfg_policy=(FasterCacheCFG(4, NUM_STEPS)
                                    if name == "image" else None))
        for name, wl in workloads.items()})


def write_artifacts(recorders, registry, outdir):
    """The four artifacts; every recorder's trace must validate."""
    # merge the per-pool recorders into one Perfetto trace (events carry
    # their own pid per modality, so concatenation is safe after remapping
    # pids to stay distinct)
    merged = {"traceEvents": [], "displayTimeUnit": "ms"}
    pid_base = 0
    for m in sorted(recorders):
        rec = recorders[m]
        rec.finish()
        trace = rec.chrome_trace()
        problems = validate_chrome_trace(trace)
        assert not problems, (m, problems)
        for ev in trace["traceEvents"]:
            ev = dict(ev)
            ev["pid"] += pid_base
            merged["traceEvents"].append(ev)
        pid_base += 1 + max(
            (e["pid"] for e in trace["traceEvents"]), default=0)
    assert not validate_chrome_trace(merged)
    with open(os.path.join(outdir, "trace.json"), "w") as f:
        json.dump(merged, f, default=float)
    with open(os.path.join(outdir, "cache_events.jsonl"), "w") as f:
        for m in sorted(recorders):
            for ev in recorders[m].cache_events:
                f.write(json.dumps(ev, default=float) + "\n")
    registry.write_prometheus(os.path.join(outdir, "metrics.prom"))
    registry.write_snapshot(os.path.join(outdir, "metrics.json"))


def run(workloads, outdir, log=print):
    """Warm and profile the pools, serve the queue with recorders and a
    registry attached, write the artifacts, reconcile the JSONL with
    telemetry exactly and price the redundancy ratio.  Returns the engine,
    the recorders, the registry, the results and the ratios."""
    os.makedirs(outdir, exist_ok=True)
    engine = build_engine(workloads)

    # -- warmup doubles as the program profiler ------------------------
    engine.warmup()
    profiles = {m: eng.program_profile for m, eng in engine.pools.items()}
    log("== program profiles (first run, kernel builds included; FLOPs "
        "counted) ==")
    for modality, prof in sorted(profiles.items()):
        for key, p in sorted(prof.items(), key=lambda kv: str(kv[0])):
            log(f"  {modality:6s} program {str(key):>5s}: "
                f"compile_seconds (first run) {p.compile_seconds:8.4f}  "
                f"flops {p.flops:12.4e}  bytes {p.bytes_accessed}")
        log(f"  {modality:6s} marginal FLOPs/row: "
            f"{flops_per_row(prof):.4e}")

    # -- serve with the full observability surface attached ------------
    registry = MetricsRegistry()
    recorders = {m: TraceRecorder(policy=engine.pools[m].policy)
                 for m in engine.pools}
    reqs = requests()
    results = engine.serve(reqs, hooks={m: [rec] for m, rec
                                        in recorders.items()},
                           metrics=registry)
    assert len(results) == len(reqs)
    assert all(np.isfinite(r.x0).all() for r in results)
    for m, tele in engine.telemetry.pools.items():
        tele.publish(registry, modality=m)     # telemetry as a metrics view
    write_artifacts(recorders, registry, outdir)

    # -- reconcile: JSONL == telemetry, exactly ------------------------
    log("\n== reconciliation (cache-event JSONL vs ServingTelemetry) ==")
    ok = True
    for m, rec in sorted(recorders.items()):
        by_req = rec.computed_steps_by_request()
        by_req_u = rec.uncond_steps_by_request()
        for r in engine.telemetry.pools[m].records:
            match = (by_req.get(r.request_id) == r.computed_steps
                     and by_req_u.get(r.request_id)
                     == r.uncond_computed_steps)
            ok &= match
            log(f"  {m:6s} req {r.request_id}: telemetry "
                f"{r.computed_steps} computed / {r.uncond_computed_steps} "
                f"uncond steps, trace {by_req.get(r.request_id)} / "
                f"{by_req_u.get(r.request_id)} "
                f"{'OK' if match else 'MISMATCH'}")
    assert ok, "cache-event log diverged from telemetry"

    # -- the survey's redundancy claim, measured in FLOPs --------------
    log("\n== measured redundancy ratio ==")
    ratios = {}
    for m, tele in sorted(engine.telemetry.pools.items()):
        rr = ratios[m] = redundancy_ratio(
            profiles[m], tele.backbone_rows_computed,
            tele.backbone_rows_padding, tele.backbone_rows_saved)
        log(f"  {m:6s} {rr['redundancy_ratio']:.4f} "
            f"({rr['flops_avoided']:.4e} of {rr['dense_flops']:.4e} "
            f"dense FLOPs avoided)")

    s = engine.telemetry.summary()
    log(f"\nserved {s['requests']} requests "
        f"({s['throughput_rps']:.4f} req/s); wrote")
    for name in ARTIFACTS:
        log(f"  {os.path.join(outdir, name)}")
    log("open trace.json at https://ui.perfetto.dev")
    return {"engine": engine, "recorders": recorders, "registry": registry,
            "results": results, "ratios": ratios, "requests": reqs}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?",
                        default=os.path.join(tempfile.gettempdir(),
                                             "repro_torch_obs"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    workloads = {m: make_workload(m, smoke=True, device=args.device)
                 for m in MODALITIES}
    run(workloads, args.outdir)
    print("\nOK")


if __name__ == "__main__":
    main()
