"""Checked-in baseline of grandfathered findings (the JAX package's
`analysis/baseline.py`; the port's baseline is a file of its own, which
holds no entries).

The baseline lets a new rule land while a known, justified finding is
still being worked off: matched findings don't fail the run but stay
visible in the JSON report.  Every entry must carry a `justification` —
an unexplained baseline entry is just a muted bug.

Matching is by content fingerprint (see base.assign_fingerprints), so the
baseline survives line-number drift but NOT edits to the offending line
itself: touching a grandfathered line re-surfaces its finding, which is
exactly when it should be fixed.

Entries whose fingerprint no longer matches anything are reported as
stale (the finding was fixed — delete the entry) without failing the run.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .base import Finding

#: default baseline location, relative to the repo root
DEFAULT_BASELINE = os.path.join("tools", "lint_baseline_torch.json")


@dataclass
class Baseline:
    path: str = ""
    #: fingerprint -> entry dict ({"rule", "path", "fingerprint",
    #: "justification"})
    entries: Dict[str, Dict] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        entries = {}
        for e in data.get("findings", []):
            fp = e.get("fingerprint", "")
            if fp:
                entries[fp] = e
        return cls(path=path, entries=entries)

    def match(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def stale(self, findings: Sequence[Finding]) -> List[Dict]:
        """Baseline entries no longer matched by any current finding."""
        live = {f.fingerprint for f in findings}
        return [e for fp, e in sorted(self.entries.items())
                if fp not in live]

    @staticmethod
    def write(path: str, findings: Sequence[Finding],
              justification: str = "grandfathered at baseline creation"
              ) -> None:
        data = {
            "comment": ("repro_torch.analysis baseline — grandfathered "
                        "findings. Every entry needs a justification; "
                        "prefer fixing or an inline `# repro-lint: "
                        "disable=` with a reason. Regenerate: "
                        "python -m repro_torch.analysis --write-baseline"),
            "findings": [
                {"rule": f.rule, "path": f.path, "snippet": f.snippet,
                 "fingerprint": f.fingerprint,
                 "justification": justification}
                for f in sorted(findings, key=lambda f: f.key())
            ],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2)
            f.write("\n")
