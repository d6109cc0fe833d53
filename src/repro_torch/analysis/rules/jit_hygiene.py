"""jit-hygiene: patterns that silently defeat a captured program (the
counterpart of the JAX package's rule of the same id, for CUDA graphs).

A CUDA graph replays the kernels and the addresses of its capture, so
whatever the captured Python read on the host is frozen into it.  Four
sub-checks, one rule id, over the captured functions of a module: a
function (or lambda) passed to `compile_program` / `capture_ir`, a
function named `*_static` (the port's convention for a program body over
static buffers), and the body of `with torch.cuda.graph(...)`:

  * a mutable default argument: read once at capture, later mutation is
    invisible to every replay;
  * a read of a mutable module-level global: its value at capture is
    baked in; pass it through a static buffer;
  * a host value read inside it (`.item()`, `.tolist()`, `.numpy()`,
    `.tobytes()`, `np.asarray` / `np.array` of a tensor): a sync the
    capture refuses, or a value the graph freezes;
  * and anywhere, a capture (`torch.cuda.graph`, `CUDAGraph.capture_begin`,
    `make_graphed_callables`) inside a loop body outside a warmup: a fresh
    graph (and pool memory) every iteration; capture once, replay after.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..base import Finding, Rule, register
from ..source import ModuleSource
from ..taint import attr_chain

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_MUTABLE_CTORS = {"list", "dict", "set", "defaultdict", "OrderedDict",
                  "Counter", "deque"}
#: calls whose first argument is a captured function
CAPTURE_ENTRIES = {"compile_program", "capture_ir"}
_CAPTURE_CALLS = {"torch.cuda.graph", "torch.cuda.make_graphed_callables",
                  "make_graphed_callables"}
_HOST_ATTRS = {"item", "tolist", "numpy", "tobytes"}
_HOST_FUNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_mutable_value(node: ast.AST) -> bool:
    if isinstance(node, _MUTABLE_LITERALS):
        return True
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if chain and chain.split(".")[-1] in _MUTABLE_CTORS:
            return True
    return False


def _entry_name(call: ast.Call) -> Optional[str]:
    chain = attr_chain(call.func)
    return chain.split(".")[-1] if chain else None


def is_capture_call(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    if chain in _CAPTURE_CALLS:
        return True
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr == "capture_begin"


def captured_bodies(tree: ast.AST) -> List[ast.AST]:
    """The captured functions (and `with torch.cuda.graph` bodies) of a
    module: defs and lambdas passed to a capture entry, `*_static` defs."""
    defs = {}
    for node in ast.walk(tree):
        if isinstance(node, _DEFS):
            defs.setdefault(node.name, []).append(node)
    out, seen = [], set()

    def add(node):
        if id(node) not in seen:
            seen.add(id(node))
            out.append(node)

    for node in ast.walk(tree):
        if isinstance(node, _DEFS) and node.name.endswith("_static"):
            add(node)
        elif isinstance(node, ast.Call) \
                and _entry_name(node) in CAPTURE_ENTRIES and node.args:
            fn = node.args[0]
            if isinstance(fn, ast.Lambda):
                add(fn)
            name = (fn.id if isinstance(fn, ast.Name) else fn.attr
                    if isinstance(fn, ast.Attribute) else None)
            for d in defs.get(name, ()):
                add(d)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) \
                        and attr_chain(ctx.func) == "torch.cuda.graph":
                    add(node)
    return out


def _bound_names(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    a = getattr(fn, "args", None)
    if a is not None:
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            out.add(arg.arg)
        for extra in (a.vararg, a.kwarg):
            if extra:
                out.add(extra.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _own_nodes(body: ast.AST):
    """Nodes of a captured body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(body))
    while stack:
        node = stack.pop()
        if isinstance(node, _DEFS + (ast.ClassDef,)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class JitHygieneRule(Rule):
    id = "jit-hygiene"
    description = ("CUDA-graph capture misuse: a capture in a loop outside "
                   "warmup; mutable defaults, mutable module globals or "
                   "host value reads in a captured function")
    rationale = ("a graph replays what its capture saw — each of these "
                 "patterns either replays stale host data, refuses to "
                 "capture, or captures (and allocates) again every "
                 "iteration")
    trees = ("src/repro_torch/",)

    def check_module(self, module: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        tree = module.tree
        mutable_globals: Set[str] = set()
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
            else:
                continue
            if _is_mutable_value(stmt.value):
                mutable_globals.update(t.id for t in targets
                                       if isinstance(t, ast.Name))
        for body in captured_bodies(tree):
            self._check_captured(module, body, mutable_globals, findings)
        self._check_loops(module, tree, "", findings)
        unique = {f.key(): f for f in findings}      # nested loops repeat
        return sorted(unique.values(), key=lambda f: f.key())

    def _check_captured(self, module, body, mutable_globals, findings):
        name = getattr(body, "name", "<captured block>")
        a = getattr(body, "args", None)
        if a is not None:
            for default in list(a.defaults) + [d for d in a.kw_defaults
                                               if d]:
                if _is_mutable_value(default):
                    findings.append(self.finding(
                        module, default.lineno, default.col_offset,
                        f"captured function '{name}' has a mutable default "
                        f"argument; the capture reads it once and no replay "
                        f"sees a later mutation — use None + in-function "
                        f"init"))
        local = _bound_names(body)
        reported: Set[str] = set()
        for node in _own_nodes(body):
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and node.id in mutable_globals and node.id not in local
                    and node.id not in reported):
                reported.add(node.id)
                findings.append(self.finding(
                    module, node.lineno, node.col_offset,
                    f"captured function '{name}' reads mutable module "
                    f"global '{node.id}'; the graph keeps what the capture "
                    f"read — pass it through a static buffer"))
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            host = (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_ATTRS) or chain in _HOST_FUNCS
            if host:
                what = chain or node.func.attr
                findings.append(self.finding(
                    module, node.lineno, node.col_offset,
                    f"captured function '{name}' reads a host value "
                    f"({what}); a capture refuses the sync, or the graph "
                    f"freezes the value — stage it in a static buffer "
                    f"before the replay"))

    def _check_loops(self, module, scope, fn_name, findings):
        for node in ast.iter_child_nodes(scope):
            if isinstance(node, _DEFS):
                self._check_loops(module, node, node.name, findings)
            elif isinstance(node, ast.ClassDef):
                self._check_loops(module, node, fn_name, findings)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                if "warmup" not in fn_name:
                    self._check_loop(module, node, findings)
                self._check_loops(module, node, fn_name, findings)
            else:
                self._check_loops(module, node, fn_name, findings)

    def _check_loop(self, module, loop, findings):
        for part in loop.body:
            for node in [part, *_own_nodes(part)]:
                if isinstance(node, ast.Call) and is_capture_call(node):
                    findings.append(self.finding(
                        module, node.lineno, node.col_offset,
                        "a CUDA-graph capture inside a loop body outside "
                        "warmup captures (and allocates pool memory) every "
                        "iteration; capture once per shape key and replay"))
