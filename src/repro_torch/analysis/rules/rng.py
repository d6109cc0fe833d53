"""rng-generator-discipline: the port's torch.Generator discipline, the
counterpart of the JAX package's `rng-key-reuse`.

JAX threads explicit keys, and its rule catches one key feeding two
draws.  torch draws from a stateful generator instead, so the same bug
class — per-slot noise that was meant to be i.i.d. coming out identical —
takes other shapes here, and the port's rule is that every draw names its
`torch.Generator`:

  * a draw from torch's GLOBAL generator: a torch.rand* / randn* /
    randint* / randperm / normal / bernoulli / multinomial / poisson call,
    or an in-place .normal_() / .uniform_() / .bernoulli_() / .random_() /
    .exponential_() (and the other in-place samplers), without
    `generator=` — its stream depends on every draw anything else made
    before it;
  * global seeding: torch.manual_seed, torch.cuda.manual_seed*,
    np.random.seed, and module-level np.random.* draws (a
    np.random.default_rng / SeedSequence / Generator is fine);
  * a generator re-seeded inside a loop body with a seed that does not
    change in the loop: every iteration then draws the same stream — the
    identical-per-slot-noise bug.  A seed expression that names a name
    the loop binds, or calls anything, counts as changing.
"""
from __future__ import annotations

import ast
from typing import List, Set

from ..base import Finding, Rule, register
from ..source import ModuleSource
from ..taint import attr_chain

#: torch.* samplers that draw from the global generator unless given one
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "normal", "bernoulli",
                "multinomial", "poisson"}
#: in-place tensor samplers
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}
#: global seeding calls
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.random.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all", "np.random.seed",
                 "numpy.random.seed"}
#: np.random.* that build a local generator instead of drawing globally
_NP_LOCAL = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
             "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
             "RandomState"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _walk_no_defs(node: ast.AST):
    """Nodes under `node` (itself included), not entering nested defs."""
    yield node
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, _DEFS):
            yield from _walk_no_defs(child)


def _bound_in(loop: ast.AST) -> Set[str]:
    """Names a loop binds: its target and every name stored in its body."""
    out: Set[str] = set()
    parts = [loop.target] if isinstance(loop, (ast.For, ast.AsyncFor)) \
        else []
    parts += list(loop.body) + list(loop.orelse)
    for part in parts:
        for n in _walk_no_defs(part):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                out.add(n.id)
    return out


def _seed_changes(arg: ast.AST, bound: Set[str]) -> bool:
    for n in ast.walk(arg):
        if isinstance(n, ast.Call):
            return True
        if isinstance(n, ast.Name) and n.id in bound:
            return True
    return False


@register
class RngGeneratorDisciplineRule(Rule):
    id = "rng-generator-discipline"
    description = ("a draw from torch's global generator (no generator=), "
                   "global seeding, or a generator re-seeded in a loop "
                   "with a seed the loop does not change")
    rationale = ("the port threads an explicit torch.Generator per draw; "
                 "a global draw makes a request's noise depend on every "
                 "draw before it, and a loop-invariant re-seed gives every "
                 "slot the same stream — the identical-per-slot-noise bug "
                 "JAX's rng-key-reuse was written for")
    trees = ("src/repro_torch/",)

    def check_module(self, module: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                f = self._check_call(module, node)
                if f is not None:
                    findings.append(f)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                findings.extend(self._check_loop(module, node))
        uniq, seen = [], set()
        for f in sorted(findings, key=lambda f: f.key()):
            if f.key() not in seen:
                seen.add(f.key())
                uniq.append(f)
        return uniq

    def _check_call(self, module, call: ast.Call):
        chain = attr_chain(call.func) or ""
        parts = chain.split(".")
        where = (module, call.lineno, call.col_offset)
        if chain in _GLOBAL_SEEDS:
            return self.finding(
                *where, f"{chain}() seeds a global generator; seed a "
                f"torch.Generator (or np.random.default_rng) and pass it "
                f"to the draws instead")
        if (len(parts) == 3 and parts[0] in ("np", "numpy")
                and parts[1] == "random" and parts[2] not in _NP_LOCAL):
            return self.finding(
                *where, f"{chain}() draws from numpy's global generator; "
                f"draw from a np.random.default_rng(seed) instead")
        if _has_generator(call):
            return None
        if len(parts) == 2 and parts[0] == "torch" \
                and parts[1] in _TORCH_DRAWS:
            return self.finding(
                *where, f"{chain}() without generator= draws from torch's "
                f"global generator; pass the request's torch.Generator")
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _INPLACE_DRAWS:
            return self.finding(
                *where, f".{call.func.attr}() without generator= draws from "
                f"torch's global generator; pass a torch.Generator")
        return None

    def _check_loop(self, module, loop) -> List[Finding]:
        bound = _bound_in(loop)
        out = []
        for stmt in list(loop.body) + list(loop.orelse):
            for n in _walk_no_defs(stmt):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "manual_seed" and n.args):
                    continue
                owner = attr_chain(n.func.value)
                if owner in ("torch", "torch.cuda", "torch.random"):
                    continue        # global seeding: reported by call
                if not _seed_changes(n.args[0], bound):
                    out.append(self.finding(
                        module, n.lineno, n.col_offset,
                        "generator re-seeded in a loop with a seed the loop "
                        "does not change: every iteration draws the same "
                        "stream (identical per-slot noise); derive the seed "
                        "from the loop's request or index"))
        return out
