"""host-sync-in-hot-path: blocking device->host transfers on tick paths
(the counterpart of the JAX package's rule of the same id).

Every `float(x)`, `.item()`, `.cpu()`, `.numpy()` or `np.asarray(x)` on a
CUDA tensor stalls the Python thread until the device catches up — on the
serving tick path that serializes the pipeline and shows up directly as
req/s, and it is what a CUDA-graph capture of a tick cannot hold.  The
engine's design confines host syncs to ONE priced read a tick (the device
plan's packed copy, `repro_torch.obs.watch.host_read`) and one
`torch.cuda.synchronize` that prices the tick; this rule keeps it that
way.

Fires only when the argument is provably tensor-tainted (see
analysis.taint) or, for `torch.cuda.synchronize()`, unconditionally — it
has no other purpose than a wait, so every call site must either be a
priced sync (inline-suppressed with its justification) or a bug.
"""
from __future__ import annotations

import ast
from typing import List

from ..base import Finding, Rule, register
from ..source import ModuleSource
from ..taint import TaintScope, attr_chain, build_scope, expr_tainted

#: builtins that force a sync when handed a CUDA tensor
_CONVERSIONS = {"float", "int", "bool"}
#: np entry points that copy tensors to the host
_NP_SINKS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
#: tensor methods that force a sync
_METHOD_SINKS = {"item", "tolist", "cpu", "numpy"}
#: calls that are a wait and nothing else
_WAITS = {"torch.cuda.synchronize"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _iter_scope_nodes(owner: ast.AST):
    """Nodes of `owner`'s scope, not descending into nested defs."""
    for child in ast.iter_child_nodes(owner):
        yield child
        if not isinstance(child, _DEFS):
            yield from _iter_scope_nodes(child)


def _direct_nested_defs(owner: ast.AST):
    """Function defs whose nearest enclosing scope is `owner`."""
    for node in _iter_scope_nodes(owner):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


@register
class HostSyncRule(Rule):
    id = "host-sync-in-hot-path"
    description = ("blocking device->host sync (float/int/bool/.item()/"
                   ".tolist()/.cpu()/.numpy()/np.asarray on tensors, "
                   "torch.cuda.synchronize) in tick-path code")
    rationale = ("each sync stalls the host until the device drains; the "
                 "serving design allows one priced read and one priced "
                 "synchronize a tick, so any other sync silently "
                 "serializes the pipeline, caps req/s and breaks a graph "
                 "capture of the tick")
    trees = ("src/repro_torch/serving/", "src/repro_torch/modalities/",
             "src/repro_torch/core/", "src/repro_torch/conditioning/")

    def check_module(self, module: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        self._visit_scope(module, module.tree, None, findings)
        findings.sort(key=lambda f: f.key())
        return findings

    def _visit_scope(self, module, owner, parent_scope, findings):
        scope = build_scope(owner, parent_scope)
        for node in _iter_scope_nodes(owner):
            if isinstance(node, ast.Call):
                f = self._check_call(module, node, scope)
                if f is not None:
                    findings.append(f)
        for fn in _direct_nested_defs(owner):
            self._visit_scope(module, fn, scope, findings)

    def _check_call(self, module, call: ast.Call, scope: TaintScope):
        chain = attr_chain(call.func)
        # unconditional: synchronize IS a wait
        if chain in _WAITS:
            return self.finding(
                module, call.lineno, call.col_offset,
                f"{chain}() blocks the host until the device drains; if "
                f"this is the one priced sync of a tick, suppress with a "
                f"justification")
        # x.item() / x.tolist() / x.cpu() / x.numpy() on a tensor
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _METHOD_SINKS
                and expr_tainted(call.func.value, scope)):
            return self.finding(
                module, call.lineno, call.col_offset,
                f".{call.func.attr}() on a tensor blocks until the device "
                f"drains; keep it on the device or batch the transfer "
                f"into the priced read")
        args = list(call.args)
        if not args:
            return None
        # float(x) / int(x) / bool(x)
        if isinstance(call.func, ast.Name) and call.func.id in _CONVERSIONS:
            if expr_tainted(args[0], scope):
                return self.finding(
                    module, call.lineno, call.col_offset,
                    f"{call.func.id}() on a tensor blocks until the device "
                    f"drains; keep it on the device or batch the transfer")
        # np.asarray(x) / np.array(x)
        if chain in _NP_SINKS and expr_tainted(args[0], scope):
            return self.finding(
                module, call.lineno, call.col_offset,
                f"{chain}() on a tensor copies it to the host "
                f"synchronously; hoist out of the per-tick loop or batch "
                f"into one transfer")
        return None
