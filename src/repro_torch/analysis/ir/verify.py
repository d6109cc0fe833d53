"""verify_programs: run the program contract over every program an
engine's warmup runs and return registry Findings (the counterpart of the
JAX package's `ir/verify.py`).

The engine records each program once under `op_checks.OpRecorder`
(`warmup(verify=True)`, or on demand through
`engine._capture_program_records()`): each bucket of the compacted engine
or `full` / `cond` / `skip` of the dense one, `"want"` when the engine
plans on the device, `"text_kv"` and `"text_encoder"` on a text engine.
The contract:

  ir-host-sync   tick and text programs make no host sync; "want" (the
                 device plan, `engine._plan_all`) makes exactly the one
                 priced read (`repro_torch.obs.watch.host_read`) and no
                 other sync
  ir-dtype       no program makes a float64 / complex128 tensor; the
                 engine's schedule tables are float32 where they cross to
                 the device (the per-slot alpha-bar and timestep tables,
                 and the NoiseSchedule's exposed tables, as JAX checks)
  ir-const-bloat no program makes a tensor from host data, or reads a
                 storage above 64 KiB that it did not make and that is
                 neither a param leaf nor one of the engine's static
                 buffers (what its CUDA graph would pin)

Findings anchor on the user frame that dispatched the operator (so
`# repro-lint: disable=ir-*` inline suppressions work), else on the
program's Python def site.  Keys come back for every program, clean ones
with an empty list, so the key set is the engine's program set.
"""
from __future__ import annotations

import inspect
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base import Finding
from .op_checks import OpIssue, check_const_bloat, check_record

__all__ = ["verify_programs", "verify_programs_by_key", "issue_to_finding",
           "PRICED_READS", "param_leaf_specs"]

_CATEGORY_RULE = {
    "host-sync": "ir-host-sync",
    "dtype": "ir-dtype",
    "donation": "ir-donation",
    "launch": "ir-launch",
    "retrace": "ir-retrace",
    "const-bloat": "ir-const-bloat",
}

#: priced reads each program key makes (every other program: none)
PRICED_READS = {"want": 1}


def _repo_root(root: Optional[str]) -> str:
    if root:
        return root
    from ..runner import find_repo_root
    return find_repo_root()


def _read_line(root: str, relpath: str, line: int) -> str:
    try:
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            lines = f.read().splitlines()
        return lines[line - 1].strip() if 0 < line <= len(lines) else ""
    except OSError:
        return ""


def _rel(path: str, root: str) -> str:
    if not path:
        return ""
    try:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
    except ValueError:
        return ""
    return "" if rel.startswith("..") else rel


def issue_to_finding(issue: OpIssue, root: str, *, fallback_file: str = "",
                     fallback_line: int = 0, prefix: str = "") -> Finding:
    """OpIssue -> registry Finding, anchored on a repo-relative source line
    so fingerprints and suppressions behave exactly like AST findings."""
    rel, line = _rel(issue.file, root), issue.line
    if not rel:
        rel, line = _rel(fallback_file, root), fallback_line
    if not rel:
        rel, line = "src/repro_torch", 1
    line = max(int(line), 1)
    rule = _CATEGORY_RULE.get(issue.category, f"ir-{issue.category}")
    return Finding(rule, rel, line, 0,
                   (prefix + issue.message) if prefix else issue.message,
                   snippet=_read_line(root, rel, line))


def _def_site(fn) -> tuple:
    try:
        fn = inspect.unwrap(getattr(fn, "__func__", fn))
        return inspect.getsourcefile(fn) or "", \
            inspect.getsourcelines(fn)[1]
    except (TypeError, OSError):
        return "", 0


def param_leaf_specs(params) -> Tuple[Tuple[tuple, str], ...]:
    """(shape, dtype-name) multiset of a param tree's leaves: what an
    engine program is supposed to read besides its static buffers."""
    from repro_torch.tree import tree_leaves
    return tuple((tuple(getattr(leaf, "shape", ())),
                  str(getattr(leaf, "dtype", "")).replace("torch.", ""))
                 for leaf in tree_leaves(params))


def engine_declared(engine) -> List:
    """The tensors an engine's programs are declared to read: its param
    leaves and static buffers, and its conditioner's."""
    from repro_torch.tree import tree_leaves
    out = tree_leaves(engine.params) + list(engine.static_buffers())
    cond = getattr(engine, "conditioner", None)
    if cond is not None:
        out += tree_leaves(cond.params) + list(cond._in.dev.values()) \
            + [cond._out]
    return out


def _engine_level_issues(engine) -> List[OpIssue]:
    """The tables gathered into every tick: an f64 table would re-promote
    the per-request DDIM coefficients off the f32 path."""
    issues = []
    sched = getattr(engine, "sched", None)
    tables = [(f"noise schedule table '{n}'", getattr(sched, n, None))
              for n in ("betas", "alpha_bars")]
    tables += [(f"engine table '{n}'", getattr(engine, n, None))
               for n in ("_ab", "_tv", "_scales", "_null_vecs")]
    for what, tab in tables:
        dt = getattr(tab, "dtype", None)
        if dt is not None and np.dtype(str(dt).replace("torch.", "")) \
                != np.float32:
            issues.append(OpIssue(
                "dtype", f"{what} is {dt} — cast to float32 where it "
                f"crosses to the device"))
    return issues


def verify_programs_by_key(engine, *, root: Optional[str] = None
                           ) -> Dict[object, List[Finding]]:
    """Findings for one engine, grouped by program key (every program;
    "__engine__" only for engine-level table issues).  Records the
    programs first when no warmup recorded them."""
    root = _repo_root(root)
    records = engine._capture_program_records()
    sites = engine._program_sites()
    by_key: Dict[object, List[Finding]] = {}
    declared = engine_declared(engine)
    for key, rec in sorted(records.items(), key=lambda kv: str(kv[0])):
        issues = check_record(rec, priced_reads=PRICED_READS.get(key, 0),
                              label=f"program {key!r}")
        issues += check_const_bloat(rec, declared, label=f"program {key!r}")
        file, line = _def_site(sites.get(key))
        by_key[key] = [issue_to_finding(i, root, fallback_file=file,
                                        fallback_line=line)
                       for i in issues]
    eng = _engine_level_issues(engine)
    if eng:
        file, line = _def_site(type(engine))
        by_key["__engine__"] = [issue_to_finding(i, root, fallback_file=file,
                                                 fallback_line=line)
                                for i in eng]
    return by_key


def verify_programs(engine, *, root: Optional[str] = None) -> List[Finding]:
    """Flat list of findings over every program of `engine` (plus the
    engine-level table checks).  Empty == verified clean."""
    by_key = verify_programs_by_key(engine, root=root)
    return [f for _, fs in sorted(by_key.items(), key=lambda kv: str(kv[0]))
            for f in fs]
