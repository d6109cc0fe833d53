"""Human-readable text and machine-readable JSON reports (the JAX
package's `analysis/report.py`, plus the rules that did not run)."""
from __future__ import annotations

import json
import os
from typing import Dict

from .runner import RunResult


def to_text(result: RunResult, verbose: bool = False) -> str:
    """clang/ruff-style text report: path:line:col: rule-id message."""
    lines = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.message}")
        if f.snippet:
            lines.append(f"    {f.snippet}")
    if verbose and result.suppressed:
        lines.append("")
        lines.append(f"suppressed ({len(result.suppressed)}):")
        for f in result.suppressed:
            lines.append(f"  {f.path}:{f.line}: [{f.rule}] (inline disable)")
    if result.baselined:
        lines.append("")
        lines.append(f"baselined ({len(result.baselined)} grandfathered "
                     f"finding(s) — see tools/lint_baseline_torch.json)")
    for e in result.stale_baseline:
        lines.append(f"stale baseline entry (fixed? delete it): "
                     f"{e.get('rule')} @ {e.get('path')} "
                     f"[{e.get('fingerprint')}]")
    for rid, why in sorted(result.not_run.items()):
        lines.append(f"not run: [{rid}] {why}")
    n = len(result.findings)
    ran = [r for r in result.rules if r not in result.not_run]
    lines.append("")
    lines.append(
        f"repro-lint: {n} finding(s) in {result.files_scanned} file(s) "
        f"({len(result.suppressed)} suppressed, "
        f"{len(result.baselined)} baselined) on {result.device} — rules: "
        f"{', '.join(ran)}"
        + (f"; not run: {', '.join(sorted(result.not_run))}"
           if result.not_run else ""))
    if n == 0:
        lines.append("repro-lint: OK")
    return "\n".join(lines)


def to_json(result: RunResult) -> Dict:
    return {
        "version": 1,
        "root": result.root,
        "device": result.device,
        "rules": result.rules,
        "not_run": dict(sorted(result.not_run.items())),
        "files_scanned": result.files_scanned,
        "findings": [f.to_dict() for f in result.findings],
        "suppressed": [f.to_dict() for f in result.suppressed],
        "baselined": [f.to_dict() for f in result.baselined],
        "stale_baseline": result.stale_baseline,
        "exit_code": result.exit_code,
    }


def write_json(result: RunResult, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_json(result), f, indent=2)
        f.write("\n")
