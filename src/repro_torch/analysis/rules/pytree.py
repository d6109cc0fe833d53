"""pytree-registration: a dataclass with tensor fields handed to a
captured program's static buffers (the counterpart of the JAX package's
rule of the same id).

The port's static buffers are trees that `repro_torch/tree.py` walks:
dicts, NamedTuples, lists and tuples.  Anything else is a leaf, so a
`@dataclass` holding tensors is opaque to `tree_copy_`: a program would
neither refill those tensors before a replay nor write its results back
into them, and the graph would keep reading the capture's values.  The
rule fires when, within one module, it sees a `@dataclass` with a field
annotated as a tensor and an instance of it (constructed in the module,
directly or through a name) passed to `tree_copy_`, `compile_program`,
`capture_ir`, `train_loop` or a captured `*_static` function.  Make such
a container a NamedTuple (as TrainState is) or a dict.  Cross-module
flows are out of scope (bias to no false positives).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..base import Finding, Rule, register
from ..source import ModuleSource
from ..taint import attr_chain
from .host_sync import _direct_nested_defs, _iter_scope_nodes

#: calls whose arguments become (or fill) a captured program's buffers
_SINKS = {"tree_copy_", "compile_program", "capture_ir", "train_loop"}


def _is_dataclass_decorator(dec: ast.AST) -> bool:
    chain = attr_chain(dec.func if isinstance(dec, ast.Call) else dec)
    return chain in ("dataclass", "dataclasses.dataclass")


def _tensor_fields(cls: ast.ClassDef) -> List[str]:
    out = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                         ast.Name):
            if "Tensor" in ast.unparse(stmt.annotation):
                out.append(stmt.target.id)
    return out


def _sink_name(call: ast.Call):
    chain = attr_chain(call.func)
    name = chain.split(".")[-1] if chain else None
    if name in _SINKS or (name or "").endswith("_static"):
        return name
    return None


@register
class PytreeRegistrationRule(Rule):
    id = "pytree-registration"
    description = ("a @dataclass with tensor fields passed into a captured "
                   "program's static buffers, which repro_torch.tree cannot "
                   "see into")
    rationale = ("tree.py walks dicts, NamedTuples, lists and tuples only: "
                 "a dataclass is one opaque leaf, so its tensors are never "
                 "refilled before a replay nor written back after it — the "
                 "graph keeps the capture's values")
    trees = ("src/repro_torch/",)

    def check_module(self, module: ModuleSource) -> List[Finding]:
        opaque: Dict[str, List[str]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and any(
                    _is_dataclass_decorator(d) for d in node.decorator_list):
                fields = _tensor_fields(node)
                if fields:
                    opaque[node.name] = fields
        if not opaque:
            return []
        findings: List[Finding] = []
        self._visit_scope(module, module.tree, {}, opaque, findings)
        findings.sort(key=lambda f: f.key())
        return findings

    def _visit_scope(self, module, owner, inherited, opaque, findings):
        instances: Dict[str, str] = dict(inherited)
        for node in _iter_scope_nodes(owner):
            if isinstance(node, ast.Assign):
                cls = self._ctor_class(node.value, opaque)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        if cls is not None:
                            instances[t.id] = cls
                        else:
                            instances.pop(t.id, None)
        for node in _iter_scope_nodes(owner):
            if not isinstance(node, ast.Call):
                continue
            sink = _sink_name(node)
            if sink is None:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                cls = self._ctor_class(arg, opaque)
                if cls is None and isinstance(arg, ast.Name):
                    cls = instances.get(arg.id)
                if cls is not None:
                    findings.append(self.finding(
                        module, node.lineno, node.col_offset,
                        f"dataclass '{cls}' (tensor fields "
                        f"{', '.join(opaque[cls])}) passed to '{sink}': "
                        f"repro_torch.tree treats it as one leaf, so the "
                        f"static buffers miss its tensors — make it a "
                        f"NamedTuple or a dict"))
        for fn in _direct_nested_defs(owner):
            self._visit_scope(module, fn, instances, opaque, findings)

    @staticmethod
    def _ctor_class(node: ast.AST, opaque) -> str:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in opaque:
            return node.func.id
        return None
