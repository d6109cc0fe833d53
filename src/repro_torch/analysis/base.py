"""Rule protocol, findings, and the rule registry (the JAX package's
`analysis/base.py`, kept as the port's own copy).

A rule is a stateless object with an `id`, a `trees` scope (repo-relative
path prefixes it lints — scoping is what keeps the host-sync rule out of
benchmarks/ where a blocking transfer is the whole point), and one of two
check surfaces:

  * `Rule.check_module(module)` — AST rules, called once per parsed file
    in scope.
  * `ProjectRule.check_project(root, device)` — whole-project rules
    (import-time introspection and runtime program checks), called once
    per run on `device` ("cuda" unless the caller asks for "cpu").  A
    project rule that cannot run where it is asked to raises `NotRun`: the
    report lists it as not run, never as clean and never as a finding.

Findings carry a content fingerprint (rule + path + normalized source
line + occurrence index) so the baseline survives line-number drift: an
unrelated edit above a grandfathered finding must not resurrect it.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence

from .source import ModuleSource


@dataclass
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str                   # repo-relative, "/" separators
    line: int
    col: int
    message: str
    snippet: str = ""           # the offending source line, stripped
    fingerprint: str = ""       # stable id for baseline matching

    def key(self):
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "snippet": self.snippet, "fingerprint": self.fingerprint,
        }


def _normalize(line: str) -> str:
    return " ".join(line.split())


def assign_fingerprints(findings: Sequence[Finding]) -> None:
    """Stable content fingerprints: hash(rule | path | normalized line |
    occurrence index among identical lines).  Line numbers are deliberately
    excluded so edits elsewhere in the file don't invalidate a baseline."""
    seen: Dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        base = (f.rule, f.path, _normalize(f.snippet))
        occ = seen.get(base, 0)
        seen[base] = occ + 1
        raw = "|".join((f.rule, f.path, _normalize(f.snippet), str(occ)))
        f.fingerprint = hashlib.sha256(raw.encode()).hexdigest()[:16]


class Rule:
    """Base class for per-module AST rules."""

    #: rule id — what `# repro-lint: disable=<id>` and `--rule <id>` name
    id: str = "base"
    #: one-line description (rule table in README / --list-rules)
    description: str = ""
    #: why the rule matters for cached serving (README rationale column)
    rationale: str = ""
    #: repo-relative path prefixes this rule lints ("/" separators);
    #: empty = every linted file
    trees: Sequence[str] = ()

    def applies_to(self, relpath: str) -> bool:
        if not self.trees:
            return True
        return any(relpath.startswith(t) for t in self.trees)

    def check_module(self, module: ModuleSource) -> List[Finding]:
        raise NotImplementedError

    def finding(self, module: ModuleSource, line: int, col: int,
                message: str) -> Finding:
        return Finding(self.id, module.relpath, line, col, message,
                       snippet=module.line(line).strip())


class NotRun(Exception):
    """Raised by a project rule that cannot run here (the reason is its
    message, e.g. "needs a CUDA device")."""


class ProjectRule(Rule):
    """A rule that inspects the project as a whole (e.g. imports the
    policy registry, or drives the engines) instead of walking per-file
    ASTs."""

    def check_module(self, module: ModuleSource) -> List[Finding]:
        return []

    def check_project(self, root: str, device: str = "cuda"
                      ) -> List[Finding]:
        raise NotImplementedError


def run_device(device: str):
    """torch.device for a project rule's run on `device`; NotRun when it
    asks for a card this machine does not have."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NotRun("needs a CUDA device (pass --device cpu to run it on "
                     "the CPU)")
    return dev


_REGISTRY: Dict[str, Rule] = {}


def register(rule_cls):
    """Class decorator: instantiate and register a rule by its id."""
    rule = rule_cls()
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id '{rule.id}'")
    _REGISTRY[rule.id] = rule
    return rule_cls


def all_rules() -> List[Rule]:
    from . import rules  # noqa: F401  (import populates the registry)
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    from . import rules  # noqa: F401
    if rule_id not in _REGISTRY:
        raise KeyError(f"unknown rule '{rule_id}'; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[rule_id]
