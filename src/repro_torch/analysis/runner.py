"""Walk files, dispatch rules, apply suppressions and the baseline (the
JAX package's `analysis/runner.py`; default tree `src/repro_torch`, and
project rules run on a device and may be reported as not run)."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .base import (Finding, NotRun, ProjectRule, Rule, all_rules,
                   assign_fingerprints)
from .baseline import DEFAULT_BASELINE, Baseline
from .source import ModuleSource

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

#: the tree linted when no paths are given
DEFAULT_TREE = os.path.join("src", "repro_torch")


def find_repo_root(start: Optional[str] = None) -> str:
    """Nearest ancestor of `start` (default: cwd) that looks like this
    repo (has src/repro_torch); falls back to the package's own checkout
    so the lint works from anywhere inside it."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(cur, DEFAULT_TREE)):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            break
        cur = parent
    # .../src/repro_torch/analysis/runner.py -> repo
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _walk_python_files(root: str, paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            out.append(ap)
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d not in _SKIP_DIRS
                               and not d.startswith(".")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
    return out


@dataclass
class RunResult:
    """Everything one analysis run produced."""
    findings: List[Finding] = field(default_factory=list)   # actionable
    suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale_baseline: List[Dict] = field(default_factory=list)
    files_scanned: int = 0
    rules: List[str] = field(default_factory=list)
    root: str = ""
    device: str = "cuda"
    #: rule id -> why it did not run (never clean, never a finding)
    not_run: Dict[str, str] = field(default_factory=dict)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0


def run_analysis(root: Optional[str] = None,
                 paths: Optional[Sequence[str]] = None,
                 rules: Optional[Sequence[Rule]] = None,
                 baseline_path: Optional[str] = None,
                 force_scope: bool = False,
                 device: Optional[str] = None) -> RunResult:
    """Run `rules` (default: all registered) over `paths` (default:
    src/repro_torch) under `root` (default: auto-detected repo root); the
    project rules drive the port on `device` (default "cuda": the port
    runs on the CPU only when asked to).

    force_scope=True applies every selected AST rule to every scanned file
    regardless of its `trees` scope — what fixture tests use to lint
    snippets living outside the real tree layout.

    Suppressed findings are filtered per line; baseline-matched findings
    are filtered by fingerprint; everything is reported in the result so
    the JSON artifact stays auditable."""
    root = os.path.abspath(root or find_repo_root())
    selected = list(rules if rules is not None else all_rules())
    paths = list(paths or [DEFAULT_TREE])
    device = device or "cuda"

    ast_rules = [r for r in selected if not isinstance(r, ProjectRule)]
    project_rules = [r for r in selected if isinstance(r, ProjectRule)]

    raw: List[Finding] = []
    files = _walk_python_files(root, paths)
    modules: List[ModuleSource] = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        mod = ModuleSource.from_file(path, rel)
        modules.append(mod)
        if mod.parse_error is not None:
            e = mod.parse_error
            raw.append(Finding("syntax-error", rel, e.lineno or 1,
                               e.offset or 0, f"file does not parse: "
                               f"{e.msg}"))
            continue
        for rule in ast_rules:
            if force_scope or rule.applies_to(rel):
                raw.extend(rule.check_module(mod))

    not_run: Dict[str, str] = {}
    for rule in project_rules:
        try:
            raw.extend(rule.check_project(root, device))
        except NotRun as e:
            not_run[rule.id] = str(e)

    raw.sort(key=lambda f: f.key())
    assign_fingerprints(raw)

    by_rel = {m.relpath: m for m in modules}
    kept, suppressed = [], []
    for f in raw:
        mod = by_rel.get(f.path)
        if mod is None and os.path.isfile(os.path.join(root, f.path)):
            # project-rule findings anchor in files the walk may not have
            # parsed; their inline suppressions apply all the same
            mod = by_rel[f.path] = ModuleSource.from_file(
                os.path.join(root, f.path), f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            suppressed.append(f)
        else:
            kept.append(f)

    bl = Baseline.load(baseline_path if baseline_path is not None
                       else os.path.join(root, DEFAULT_BASELINE))
    actionable = [f for f in kept if not bl.match(f)]
    baselined = [f for f in kept if bl.match(f)]

    return RunResult(
        findings=actionable, suppressed=suppressed, baselined=baselined,
        stale_baseline=bl.stale(kept), files_scanned=len(files),
        rules=[r.id for r in selected], root=root, device=device,
        not_run=not_run)
