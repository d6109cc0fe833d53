"""policy-registry-conformance: drive every make_policy entry of the port
through the serving contract (the JAX package's rule of the same id, over
`repro_torch.core.POLICY_REGISTRY`).

The serving engine trusts four things about every policy it hosts:

  * `want_compute` mirrors `apply`'s refresh decision — at minimum, a
    FRESH state must want a compute (the cache is empty; reusing it would
    serve zeros), and `apply` at step 0 must actually run compute_fn.
  * reset-on-refill — `init_state` is a pure function of (shape, dtype):
    two refills produce identical states, so a slot refill fully isolates
    requests (no state bleed across the requests that share a slot).
  * `static_schedule`, when offered, is coherent: length == num_steps and
    step 0 computes (the engine's host plan trusts it blindly).
  * pab-family `RANGES` tables name module TYPES that some registered DiT
    backbone actually exposes (`block_branches`): a range keyed on a
    module type no backbone has is a silent no-op.

This rule is not an AST pass: it imports `repro_torch.core` and drives
each registry entry with small dummy tensors on the run's device, so a
policy merged without the serving contract fails lint before it ever
reaches an engine.  Findings anchor on the entry's line in
core/__init__.py.
"""
from __future__ import annotations

import os
from typing import Dict, List

from ..base import Finding, ProjectRule, register, run_device

REL_PATH = "src/repro_torch/core/__init__.py"


def _dummy_kwargs(name: str, device) -> Dict:
    """Constructor kwargs that let every registry entry build: generic
    knobs all lambdas absorb via **kw, plus the two entries that refuse
    to default (lazydit's trained gate, blockcache's measured profile)."""
    import torch
    base = {"num_steps": 8, "frames": 2}
    if name == "lazydit":
        base["gate"] = {"w": torch.zeros((4,), device=device),
                        "b": torch.zeros((), device=device)}
    if name == "blockcache":
        base["profile"] = [0.0] * 8
    return base


def _entry_line(source_lines: List[str], name: str) -> int:
    needle = f'"{name}":'
    for i, line in enumerate(source_lines, 1):
        if needle in line:
            return i
    return 1


def _tree_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    return a == b


@register
class PolicyConformanceRule(ProjectRule):
    id = "policy-registry-conformance"
    description = ("make_policy registry entry violates the serving "
                   "contract (want_compute mirror, reset-on-refill, "
                   "static_schedule coherence, pab RANGES)")
    rationale = ("the serving engine trusts want_compute to mirror apply "
                 "and init_state to be a pure refill; a policy that "
                 "breaks either serves stale zeros or bleeds state across "
                 "requests sharing a slot")

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        dev = run_device(device)
        try:
            import numpy as np
            import torch
            from repro_torch.core import (CachePolicy, POLICY_REGISTRY,
                                          make_policy)
        except Exception as e:  # pragma: no cover - broken checkout
            return [Finding(self.id, REL_PATH, 1, 0,
                            f"cannot import repro_torch.core to introspect "
                            f"the policy registry: {e!r}")]
        try:
            with open(os.path.join(root, REL_PATH), encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            lines = []

        findings: List[Finding] = []

        def fail(name, msg):
            line = _entry_line(lines, name)
            snippet = lines[line - 1].strip() if lines else ""
            findings.append(Finding(self.id, REL_PATH, line, 0,
                                    f"policy '{name}': {msg}",
                                    snippet=snippet))

        # module types some registered DiT backbone exposes — the legal
        # key universe for pab-family RANGES tables
        exposed = None
        try:
            from repro_torch.configs import ALL_ARCH_IDS, get_config
            from repro_torch.diffusion.pipeline import backbone_module
            exposed = set()
            for arch in ALL_ARCH_IDS:
                cfg = get_config(arch)
                if cfg.is_dit:
                    exposed |= set(backbone_module(cfg).block_branches(cfg))
        except Exception as e:
            findings.append(Finding(
                self.id, REL_PATH, 1, 0,
                f"cannot enumerate backbone module types for the RANGES "
                f"conformance check: {e!r}"))

        x = torch.ones((2, 4), device=dev)
        for name in sorted(POLICY_REGISTRY):
            try:
                policy = make_policy(name, **_dummy_kwargs(name, dev))
            except Exception as e:
                fail(name, f"not constructible with generic kwargs "
                           f"(num_steps/frames/gate/profile): {e!r}")
                continue
            if not isinstance(policy, CachePolicy):
                fail(name, f"make_policy returned {type(policy).__name__}, "
                           f"not a CachePolicy")
                continue
            ranges = getattr(type(policy), "RANGES", None)
            if ranges and exposed is not None:
                unknown = sorted(set(ranges) - exposed)
                if unknown:
                    fail(name, f"RANGES names module types {unknown} that "
                               f"no registered DiT backbone exposes "
                               f"(block_branches union: {sorted(exposed)}) "
                               f"— those broadcast ranges can never serve "
                               f"a real branch")
            try:
                s1 = policy.init_state(tuple(x.shape), device=dev)
                s2 = policy.init_state(tuple(x.shape), device=dev)
            except Exception as e:
                fail(name, f"init_state(shape) raised: {e!r}")
                continue
            if not _tree_equal(s1, s2):
                fail(name, "init_state is not a pure refill: two calls "
                           "with the same shape produced different states "
                           "(slot refills would bleed state)")
            try:
                wc0 = policy.want_compute(s1, 0, x, signal=x)
            except Exception as e:
                fail(name, f"want_compute(fresh_state, step=0) raised: "
                           f"{e!r}")
                continue
            if not bool(torch.as_tensor(wc0)):
                fail(name, "want_compute is False on a FRESH state at "
                           "step 0 — the engine would reuse an empty "
                           "cache and serve zeros")
            try:
                y, _ = policy.apply(s1, 0, x, lambda v: v * 2.0, signal=x)
            except Exception as e:
                fail(name, f"apply(fresh_state, step=0) raised: {e!r}")
                continue
            if not torch.allclose(torch.as_tensor(y).float().cpu(),
                                  2.0 * x.cpu(), atol=1e-5):
                fail(name, "apply at step 0 did not run compute_fn "
                           "(output != compute_fn(x)) — want_compute's "
                           "mirror promise is broken on the first tick")
            try:
                wm = policy.want_metric(s1, 0, x, signal=x)
                float(np.asarray(torch.as_tensor(wm).cpu()))
            except Exception as e:
                fail(name, f"want_metric(fresh_state, step=0) is not a "
                           f"float scalar: {e!r}")
            try:
                sched = policy.static_schedule(8)
            except Exception as e:
                fail(name, f"static_schedule(8) raised: {e!r}")
                continue
            if sched is not None:
                if len(sched) != 8:
                    fail(name, f"static_schedule(8) returned "
                               f"{len(sched)} entries, expected 8")
                elif not sched[0]:
                    fail(name, "static_schedule()[0] is falsy — the host "
                               "plan would skip the first step against an "
                               "empty cache")
        return findings
