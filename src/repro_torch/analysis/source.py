"""Parsed source files and inline suppressions (the JAX package's
`analysis/source.py`, kept as the port's own copy).

`ModuleSource` bundles everything a rule needs about one file: the text,
split lines, the parsed AST, and the per-line suppression sets parsed from
`# repro-lint: disable=<rule>[,<rule>...]` comments.  Parsing happens once
per file per run regardless of how many rules inspect it.

Suppression grammar (the justification rides in the same comment, after
the rule list — keep one):

    x = float(metric)   # repro-lint: disable=host-sync-in-hot-path -- why
    # repro-lint: disable-next-line=rng-generator-discipline -- why
    noise = torch.randn(shape)

`disable=all` suppresses every rule on that line (use sparingly).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, Optional

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable(?P<next>-next-line)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)")


def _parse_suppressions(lines) -> Dict[int, FrozenSet[str]]:
    """1-indexed line -> set of suppressed rule ids on that line."""
    out: Dict[int, set] = {}
    for i, line in enumerate(lines, 1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
        target = i + 1 if m.group("next") else i
        out.setdefault(target, set()).update(rules)
    return {k: frozenset(v) for k, v in out.items()}


class ModuleSource:
    """One parsed Python file presented to AST rules."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        #: repo-relative path with "/" separators (what scoping + baselines
        #: key on, so reports are machine-independent)
        self.relpath = relpath.replace("\\", "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as e:  # surfaced by the runner as a finding
            self.parse_error = e
        self._suppressions = _parse_suppressions(self.lines)

    @classmethod
    def from_file(cls, path: str, relpath: str) -> "ModuleSource":
        with open(path, encoding="utf-8") as f:
            return cls(path, relpath, f.read())

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, lineno: int, rule_id: str) -> bool:
        rules = self._suppressions.get(lineno)
        return bool(rules) and (rule_id in rules or "all" in rules)
