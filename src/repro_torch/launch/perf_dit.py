"""dit-xl x decode_32k, the paper-representative pair (the JAX package's
`launch/perf_dit.py`): three variants of the diffusion serve step, traced
on one rank of dit-xl's logical mesh as the dry run traces a case.

  uncached — the full denoiser forward every step (the survey's baseline)
  refresh  — TaylorSeer's cache-refresh step: full forward + the
             difference-stack update
  skip     — a scheduled forecast-only step: the host knows the step is a
             skip (`interval_pred`), so only the polynomial forecast runs,
             one forecast kernel launch on each rank's batch shard

It writes each variant's roofline terms per rank (compute from the counted
FLOPs alone, with no analytic floor) and the amortised terms of N = 4
(one refresh, three skips).

    python -m repro_torch.launch.perf_dit [--out DIR]

Records go beside the dry run's (`dryrun_out/` by default).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import sharding as shd
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.dryrun import RESULTS_DIR, init_fake_world, trace
from repro_torch.launch.mesh import logical_mesh_shape, make_logical_mesh
from repro_torch.launch.roofline import PEAK_FLOPS, analyze
from repro_torch.launch.specs import BF16, _params_specs
from repro_torch.models import dit

VARIANTS = ("uncached", "refresh", "skip")
INTERVAL = 4
ORDER = 2


def policy():
    from repro_torch.core import make_policy
    return make_policy("taylorseer", interval=INTERVAL, order=ORDER)


def variant_fn(kind: str, cfg, pol):
    """The serve step of one variant: fn(params, state, batch) -> (eps,
    state)."""
    if kind not in VARIANTS:
        raise ValueError(f"unknown variant {kind} (one of {VARIANTS})")

    def fn(params, state, batch):
        def compute(lat):
            return dit.forward(params, lat, batch["t"], batch["labels"], cfg)
        with implicit_replication():
            if kind == "uncached":
                return compute(batch["latents"]), state
            return pol.apply(state, 0 if kind == "refresh" else 1,
                             batch["latents"], compute)
    return fn


def variant_inputs(cfg, batch: int, pol, device=None):
    """(state, batch) of the serve step: empty tensors on `device` (the
    meta device by default: shapes only)."""
    device = device or torch.device("meta")
    eps_shape = (batch, cfg.dit_patch_tokens, cfg.dit_in_dim)
    state = pol.init_state(eps_shape, BF16, device=device)
    inputs = {"latents": torch.empty(eps_shape, dtype=BF16, device=device),
              "t": torch.empty((batch,), device=device),
              "labels": torch.empty((batch,), dtype=torch.long,
                                    device=device)}
    return state, inputs


def per_rank_batch(cfg) -> int:
    """decode_32k's global batch over dit-xl's logical mesh's batch axes."""
    shape, axes = logical_mesh_shape(cfg)
    return INPUT_SHAPES["decode_32k"].global_batch // shape[axes.index("data")]


def roofline_terms(kind: str) -> dict:
    """One variant's per-rank roofline terms on dit-xl's logical mesh at
    decode_32k (fake process group, fake tensors: runs on the CPU)."""
    cfg = get_config("dit-xl")
    pol = policy()
    init_fake_world(256)
    mesh = make_logical_mesh(cfg, device="cpu")
    pspec = _params_specs(cfg)
    state, batch = variant_inputs(cfg, INPUT_SHAPES["decode_32k"].global_batch,
                                  pol)
    specs = (shd.params_sharding(pspec, mesh), shd.cache_sharding(state, mesh),
             shd.inputs_sharding(batch, mesh))
    fn = variant_fn(kind, cfg, pol)
    counter, arg_bytes, _, seconds = trace(fn, (pspec, state, batch), specs,
                                           mesh)
    rl = analyze(counter, mesh.size())
    return {"kind": kind, "compute_s": rl.flops / PEAK_FLOPS,
            "memory_s": rl.memory_s, "collective_s": rl.collective_s,
            "flops": rl.flops, "hbm_bytes": rl.hbm_bytes,
            "coll_bytes": rl.coll_bytes,
            "bytes_per_device": arg_bytes + counter.peak,
            "trace_s": round(seconds, 2)}


def summarize(rows, n: int = INTERVAL) -> dict:
    by = {r["kind"]: r for r in rows}
    terms = ("compute_s", "memory_s", "collective_s")
    amort = {t: (by["refresh"][t] + (n - 1) * by["skip"][t]) / n
             for t in terms}
    return {"variants": rows, f"amortized_N{n}": amort,
            "speedup_terms": {t: by["uncached"][t] / max(amort[t], 1e-12)
                              for t in terms}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    outdir = Path(args.out) if args.out else RESULTS_DIR
    outdir.mkdir(parents=True, exist_ok=True)
    out = summarize([roofline_terms(k) for k in VARIANTS])
    out["mesh"] = "x".join(str(s) for s in
                           logical_mesh_shape(get_config("dit-xl"))[0])
    out["per_rank_batch"] = per_rank_batch(get_config("dit-xl"))
    print(json.dumps(out, indent=1))
    with open(outdir / "perf_dit_decode.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
