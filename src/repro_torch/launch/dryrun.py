"""Dry run: trace every (arch x input shape) step on one rank of the
production mesh, without devices, and write its memory and roofline terms
(the JAX package's `launch/dryrun.py`).

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --all       # one subprocess a case

It runs on the CPU by design, as JAX's runs on placeholder devices: a fake
process group (`torch.testing._internal.distributed.fake_pg`) at world
size 256 (512 with --multi-pod) stands for the pod, whose collectives
move nothing, and `FakeTensorMode` gives every tensor a shape and no
storage.  Params come from the meta-device init; each rank's argument is
its local shard (`sharding.from_local_shards`), and the step (forward and
backward for train) runs on DTensors over them under `StepCounter`
(`roofline.py`), which counts one rank's FLOPs, bytes, collectives and
live-output peak.

Each record keeps JAX's keys: `status`, `memory`, `bytes_per_device`
(argument bytes + the activation peak), `fits_80gb_hbm` (JAX's
`fits_16gb_hbm`, for an 80 GB H100), `roofline`, `model_flops_global`,
`useful_flops_ratio` and `lower_s` (the trace's seconds; there is no
compile, so `compile_s` is 0).  Records go to --out, by default
`dryrun_out/` at the root of the checkout (git-ignored).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ALL_ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import (attn_shards, make_logical_mesh,
                                     make_production_mesh)
from repro_torch.launch.roofline import (HBM_BYTES, StepCounter, analyze,
                                         model_flops)
from repro_torch.launch.specs import build_case

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"


def init_fake_world(world: int) -> None:
    """A fake process group of `world` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    from repro_torch.spmd import is_dtensor
    from repro_torch.tree import tree_leaves
    return sum(t.to_local().nbytes if is_dtensor(t) else t.nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def trace(fn, inputs, specs, mesh):
    """Run fn on fake local shards of `inputs` (meta tensors) under a
    StepCounter.  Returns (counter, argument bytes, output bytes,
    seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import sharding as shd
    # the meshes' own rank tensors are real: let operators on them through
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = shd.from_local_shards(
            inputs, specs, mesh,
            lambda shape, dtype: torch.empty(shape, dtype=dtype))
        counter = StepCounter()
        t0 = time.perf_counter()
        with counter:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        return counter, _local_bytes(args), _local_bytes(out), seconds


def run_case(arch: str, shape_name: str, multi_pod: bool,
             contract_mesh: bool = False) -> dict:
    case = build_case(arch, shape_name)
    cfg = get_config(arch)
    init_fake_world(512 if multi_pod else 256)
    if contract_mesh:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh_name = "2x16x16(d,m)" if multi_pod else "16x16(d,m)"
    else:
        mesh = make_logical_mesh(cfg, multi_pod=multi_pod, device="cpu")
        a = attn_shards(cfg)
        mesh_name = "x".join(str(s) for s in mesh.shape)
        mesh_name += f"(attn_shards={a})"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": case.kind, "notes": case.notes}
    if case.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = case.skip
        return rec

    chips = mesh.size()
    inputs, specs = tuple(case.inputs.values()), case.in_shardings(mesh)
    if case.kind == "train":
        def step(mb):
            return case.fn_builder(mesh, microbatches=mb)
    else:
        def step(mb):
            return case.build_fn(mesh)
    counter, arg_bytes, out_bytes, seconds = trace(step(1), inputs, specs,
                                                   mesh)
    accum = getattr(step(None), "accum", 1)
    if accum > 1:
        # every microbatch runs the same operators: the counts of 2 less
        # those of 1 are one microbatch's, added for the other accum - 2
        one = counter
        counter, arg_bytes, out_bytes, s = trace(step(2), inputs, specs,
                                                 mesh)
        counter.extrapolate(one, accum - 2)
        seconds += s
        rec["traced_microbatches"] = f"1 and 2 of {accum}, extrapolated"
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": out_bytes,
                     "temp_size_in_bytes": counter.peak,
                     "generated_code_size_in_bytes": 0}
    per_dev = arg_bytes + counter.peak
    rec["bytes_per_device"] = per_dev
    rec["fits_80gb_hbm"] = bool(per_dev < HBM_BYTES)

    mf = model_flops(cfg, INPUT_SHAPES[shape_name])
    rl = analyze(counter, chips, analytic_flops=mf)
    rec["roofline"] = rl.summary()
    rec["model_flops_global"] = mf
    counted_global = rl.flops * chips
    rec["useful_flops_ratio"] = (mf / counted_global) if counted_global \
        else 0.0
    rec["lower_s"] = round(seconds, 2)
    rec["compile_s"] = 0.0
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--contract-mesh", action="store_true",
                    help="use the flat (data, model) contract mesh instead "
                         "of the per-arch logical (data, attn, ffn) mesh")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) as subprocesses")
    ap.add_argument("--also-multi-pod", action="store_true",
                    help="with --all: additionally run the 2x16x16 mesh")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args(argv)
    outdir = Path(args.out) if args.out else RESULTS_DIR
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        combos = [(a, s, False) for a in ALL_ARCH_IDS for s in INPUT_SHAPES]
        if args.also_multi_pod:
            combos += [(a, s, True) for a in ALL_ARCH_IDS
                       for s in INPUT_SHAPES]
        procs, pending, failed = {}, list(combos), []
        while pending or procs:
            while pending and len(procs) < args.jobs:
                a, s, mp = pending.pop(0)
                tag = f"{a}_{s}_{'mp' if mp else 'sp'}"
                if (outdir / f"dryrun_{tag}.json").exists():
                    print(f"[skip existing] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s, "--out", str(outdir)]
                if mp:
                    cmd.append("--multi-pod")
                procs[tag] = (subprocess.Popen(cmd), time.time())
                print(f"[start] {tag}")
            for tag in list(procs):
                p, t0 = procs[tag]
                if p.poll() is not None:
                    ok = p.returncode == 0
                    print(f"[done {'ok' if ok else f'FAIL({p.returncode})'}]"
                          f" {tag} in {time.time() - t0:.0f}s")
                    if not ok:
                        failed.append(tag)
                    del procs[tag]
            time.sleep(1)
        print("FAILED:", failed if failed else "none")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    tag = (f"{args.arch}_{args.shape}_{'mp' if args.multi_pod else 'sp'}"
           + ("_contract" if args.contract_mesh else ""))
    try:
        rec = run_case(args.arch, args.shape, args.multi_pod,
                       args.contract_mesh)
    except Exception as e:     # the record carries the failure
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multi_pod else "16x16",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(outdir / f"dryrun_{tag}.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1))
    return 1 if rec["status"] == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
