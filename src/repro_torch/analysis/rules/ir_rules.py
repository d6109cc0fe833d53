"""The six ir-* rules: runtime program verification surfaced through the
ordinary rule registry, so `--rule 'ir-*'`, inline suppressions, the
fingerprinted baseline and JSON reports apply to them exactly as to AST
findings (the counterpart of the JAX package's `rules/ir_rules.py`).

ir-host-sync, ir-dtype, ir-const-bloat and ir-retrace share one cached
golden context
per device (repro_torch.analysis.ir.golden): tiny image + video + t2i
engines warmed with `warmup(verify=True)` and served through a mixed
session under the retrace sentinel.  ir-donation drives the real DiT train
step through `train_loop(verify_donation=True)`; ir-launch drives every
kernel wrapper under the launch lint, on the card only.

Every rule runs on the run's device ("cuda" unless the caller asks for
"cpu") and reports itself as not run where that device is missing.
"""
from __future__ import annotations

import os
from typing import List

from ..base import Finding, NotRun, ProjectRule, register, run_device

_ENGINE_REL = "src/repro_torch/serving/diffusion/engine.py"
_TRAIN_REL = "src/repro_torch/train/loop.py"
_KERNELS_REL = "src/repro_torch/kernels/_build.py"


def _read_line(root: str, relpath: str, line: int) -> str:
    try:
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            lines = f.read().splitlines()
        return lines[line - 1].strip() if 0 < line <= len(lines) else ""
    except OSError:
        return ""


def _find_line(root: str, relpath: str, needle: str) -> int:
    try:
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            for i, text in enumerate(f.read().splitlines(), 1):
                if needle in text:
                    return i
    except OSError:
        pass
    return 1


def _at(rule_id: str, root: str, rel: str, needle: str, msg: str) -> Finding:
    line = _find_line(root, rel, needle)
    return Finding(rule_id, rel, line, 0, msg,
                   snippet=_read_line(root, rel, line))


def _golden(rule_id: str, root: str, device: str):
    from ..ir.golden import golden_context
    run_device(device)
    ctx = golden_context(device)
    if ctx.error:
        return ctx, [_at(rule_id, root, _ENGINE_REL, "def warmup(self",
                         f"golden lint context failed to build — program "
                         f"contracts unverifiable: {ctx.error}")]
    return ctx, []


def _program_findings(rule_id: str, root: str, device: str) -> List[Finding]:
    """This rule's slice of the golden engines' warmup(verify) findings."""
    ctx, err = _golden(rule_id, root, device)
    if err:
        return err
    return [Finding(rule_id, f.path, f.line, f.col, f.message,
                    snippet=f.snippet)
            for f in ctx.program_findings if f.rule == rule_id]


@register
class IRHostSyncRule(ProjectRule):
    id = "ir-host-sync"
    description = ("host syncs in a warmup program (tick / text: none; "
                   "the device plan: exactly its one priced read), from "
                   "the operators one run dispatches")
    rationale = ("the AST host-sync rule sees source taint; this sees the "
                 "aten._local_scalar_dense, nonzero and device-to-host "
                 "copies a run really makes — each one stalls the tick, "
                 "and a CUDA-graph capture of the tick cannot hold it")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        return _program_findings(self.id, root, device)


@register
class IRDtypeRule(ProjectRule):
    id = "ir-dtype"
    description = ("float64 / complex128 tensors made by a warmup program, "
                   "and the engine's schedule tables not float32 at the "
                   "device boundary")
    rationale = ("an f64 intermediate doubles hot-path memory traffic and "
                 "runs at 1/64 of the f32 rate on the card; it enters "
                 "through host numpy tables promoted on the device path")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        return _program_findings(self.id, root, device)


@register
class IRConstBloatRule(ProjectRule):
    id = "ir-const-bloat"
    description = ("a warmup program that makes a tensor from host data, "
                   "or reads a storage above 64 KiB that is neither a "
                   "param leaf nor a static buffer of its engine")
    rationale = ("a CUDA graph replays its capture: a tensor made from host "
                 "data inside it keeps the capture's value, and an "
                 "undeclared tensor it reads is pinned by every graph of "
                 "the program (one per bucket) — or freed under it")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        return _program_findings(self.id, root, device)


@register
class IRDonationRule(ProjectRule):
    id = "ir-donation"
    description = ("a train step that does not update every TrainState "
                   "leaf in place (the eager form of a donation that "
                   "silently no-ops)")
    rationale = ("a step that returns copies holds two of every param and "
                 "optimizer leaf at once; at full width that is the "
                 "difference between fitting the card and not")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        dev = run_device(device)
        from ..ir.op_checks import DonationError
        try:
            import torch
            from repro_torch.configs import get_smoke_config
            from repro_torch.diffusion import linear_schedule
            from repro_torch.train.loop import train_loop
            from repro_torch.train.steps import (init_train_state,
                                                 make_diffusion_train_step)

            cfg = get_smoke_config("dit-xl").reduced(
                num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                d_ff=64)
            gen = torch.Generator(device=dev).manual_seed(0)
            state = init_train_state(gen, cfg, device=dev)
            step_fn = make_diffusion_train_step(cfg, linear_schedule(50),
                                                total_steps=5)
            batch = {"latents": torch.zeros((2, cfg.dit_tokens,
                                             cfg.dit_in_dim), device=dev),
                     "labels": torch.zeros((2,), dtype=torch.long,
                                           device=dev),
                     "generator": torch.Generator(device=dev).manual_seed(1)}
            train_loop(step_fn, state, iter([batch]), 1, log_every=1,
                       log_fn=lambda s: None, verify_donation=True)
        except DonationError as e:
            return [_at(self.id, root, _TRAIN_REL, "verify_donation",
                        e.issue.message)]
        except Exception as e:
            return [_at(self.id, root, _TRAIN_REL, "verify_donation",
                        f"cannot drive the train step's donation check: "
                        f"{e!r}")]
        return []


@register
class IRRetraceRule(ProjectRule):
    id = "ir-retrace"
    description = ("steady-state serving after engine.warmup() built or "
                   "loaded a kernel library, or ran a program at a key "
                   "warmup did not run, during the golden mixed session")
    rationale = ("warmup promises the complete program set; a build or a "
                 "first run inside a live tick pays its cost there — and, "
                 "with CUDA graphs, a capture")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        ctx, err = _golden(self.id, root, device)
        if err:
            return err
        findings = []
        if not ctx.sentinel_live:
            findings.append(_at(
                self.id, root, _ENGINE_REL, "def _note_program",
                "retrace sentinel selftest failed: a channel did not see "
                "its known event — the zero-retrace claim is unverifiable"))
        if ctx.retrace_count != 0:
            names = ", ".join(sorted(set(ctx.retrace_names))) or "<unnamed>"
            findings.append(_at(
                self.id, root, _ENGINE_REL, "def _note_program",
                f"golden mixed session did {ctx.retrace_count} build(s), "
                f"load(s) or cold program(s) AFTER warmup (expected 0): "
                f"{names}"))
        return findings


@register
class IRLaunchRule(ProjectRule):
    id = "ir-launch"
    description = ("CUDA launch lint: operand contiguity / alignment / "
                   "dtype / int32 extents of every call through "
                   "_build.launch, and each site's grid, block, shared "
                   "memory, registers and occupancy on the card")
    rationale = ("a launch over a hardware limit fails only at run time on "
                 "the card, and a misaligned operand silently drops a "
                 "kernel to its slow staging; the plan each site really "
                 "launches is checked, not a copy of its arithmetic")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        import torch
        if torch.device(device).type != "cuda" \
                or not torch.cuda.is_available():
            raise NotRun("needs a CUDA device (a CUDA kernel has no CPU "
                         "mode; the wrappers' plain versions never launch)")
        from ..ir.launch_lint import lint_launches
        from ..ir.verify import issue_to_finding
        res = lint_launches()
        fallback = os.path.join(root, _KERNELS_REL)
        return [issue_to_finding(i, root, fallback_file=fallback,
                                 fallback_line=1) for i in res.issues]
