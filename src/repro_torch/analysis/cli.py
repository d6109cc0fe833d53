"""Command-line entry point: `python -m repro_torch.analysis` (the JAX
package's `analysis/cli.py`, plus `--device`).

Exit status: 0 when every finding is suppressed or baselined, 1 otherwise
(what the CI step keys on), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
from typing import List, Optional

from .base import all_rules, get_rule
from .baseline import DEFAULT_BASELINE, Baseline
from .report import to_json, to_text, write_json
from .runner import find_repo_root, run_analysis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lint of the PyTorch port: AST rules (host syncs, "
                    "clock sources, torch.Generator discipline, policy-"
                    "registry contracts) and the ir-* runtime checks of "
                    "the engines' programs, the train step's in-place "
                    "updates, the retrace sentinel and the CUDA launch "
                    "plans")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: src/repro_torch)")
    p.add_argument("--rule", action="append", dest="rules", metavar="ID",
                   help="run only this rule (repeatable; glob patterns "
                        "like 'ir-*' expand against registered ids)")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detect from cwd)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline file (default: "
                        "tools/lint_baseline_torch.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather current findings into the baseline "
                        "file and exit 0")
    p.add_argument("--json", default=None, metavar="FILE",
                   help="also write the full JSON report to FILE "
                        "('-' for stdout)")
    p.add_argument("--no-scope", action="store_true",
                   help="apply every rule to every file, ignoring per-rule "
                        "tree scoping (fixture/debug use)")
    p.add_argument("--device", default=None,
                   help="device the ir-* rules drive the port on (default: "
                        "cuda; pass cpu to run them on the CPU)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the text report (exit status only)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also list suppressed findings")
    return p


def resolve_rules(patterns: List[str]) -> List:
    """Rule ids / glob patterns -> rule objects.  A pattern matching
    nothing is an error, not a silent no-op lint."""
    out, seen = [], set()
    for pat in patterns:
        if any(ch in pat for ch in "*?["):
            matched = [r for r in all_rules()
                       if fnmatch.fnmatchcase(r.id, pat)]
            if not matched:
                raise KeyError(f"--rule pattern '{pat}' matches no "
                               f"registered rule")
            for r in matched:
                if r.id not in seen:
                    seen.add(r.id)
                    out.append(r)
        else:
            r = get_rule(pat)
            if r.id not in seen:
                seen.add(r.id)
                out.append(r)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:32s} {r.description}")
        return 0

    try:
        rules = resolve_rules(args.rules) if args.rules else None
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    root = args.root or find_repo_root()
    result = run_analysis(root=root, paths=args.paths or None, rules=rules,
                          baseline_path=args.baseline,
                          force_scope=args.no_scope, device=args.device)

    if args.write_baseline:
        path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
        # grandfather what is currently actionable on top of what is
        # already baselined, so rewriting is idempotent
        Baseline.write(path, result.findings + result.baselined,
                       justification="grandfathered; justify or fix")
        print(f"wrote {len(result.findings) + len(result.baselined)} "
              f"finding(s) to {path}")
        return 0

    if args.json == "-":
        print(json.dumps(to_json(result), indent=2))
    elif args.json:
        write_json(result, args.json)

    if not args.quiet:
        print(to_text(result, verbose=args.verbose))
    return result.exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
