"""clock-discipline: wall-clock reads in serving/modalities/conditioning
code (the JAX package's rule of the same id, over the port's trees).

The port's serving stack reads time through `repro_torch/obs/clock.py`
(`monotonic()`, `wall()`): one clock source that tests monkeypatch as one
symbol and that keeps every span on one monotonic axis.  A stray
`time.time()` (or perf_counter/monotonic) in serving/, modalities/ or
conditioning/ reads the real clock behind that module's back.
"""
from __future__ import annotations

import ast
from typing import List

from ..base import Finding, Rule, register
from ..source import ModuleSource
from ..taint import attr_chain

_BANNED = {"time.time", "time.perf_counter", "time.monotonic",
           "time.monotonic_ns", "time.perf_counter_ns", "time.time_ns"}


@register
class ClockRule(Rule):
    id = "clock-discipline"
    description = ("direct wall-clock read (time.time/perf_counter/"
                   "monotonic) instead of repro_torch.obs.clock")
    rationale = ("serving, modalities and conditioning code must read time "
                 "through repro_torch.obs.clock so tests control it and "
                 "every span shares one monotonic axis; a raw time.time() "
                 "bypasses both")
    trees = ("src/repro_torch/serving/", "src/repro_torch/modalities/",
             "src/repro_torch/conditioning/")

    def check_module(self, module: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if chain in _BANNED:
                findings.append(self.finding(
                    module, node.lineno, node.col_offset,
                    f"{chain}() reads the wall clock; use "
                    f"repro_torch.obs.clock (monotonic / wall) so tests "
                    f"and traces share one clock"))
        return findings
