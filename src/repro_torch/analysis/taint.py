"""Function-scope device-tensor taint analysis for torch code (the
counterpart of the JAX package's `analysis/taint.py`).

The host-sync rule must tell `float(n)` on a Python int (fine) apart from
`float(metric)` on a CUDA tensor (a blocking device->host round trip).
The codebase has no annotations to say which is which, so this pass
approximates it with a deliberately simple, flow-insensitive taint per
function scope:

  Sources (expression produces a tensor):
    * calls into torch.* (torch.stack, torch.where, torch.zeros, ...) and
      torch.nn.functional.* / F.*, except the namespaces and functions
      that stay on the host (torch.cuda, torch.device, torch.Generator,
      torch.is_tensor, ...)
    * calls of names assigned a transform result — `f = torch.vmap(g)`
      makes every `f(...)` a tensor-producing call
  Propagation:
    * through names (a name EVER assigned a tainted value is tainted —
      flow-insensitive, so loops need no fixpoint over orderings),
      tuple-unpack, binary/unary/compare ops, subscripts, conditionals
    * through attribute access and method calls on tainted values, except
      host metadata (.shape, .dtype, .device, .ndim, .numel(), .size(),
      .dim(), ...)
  Sinks (clear the taint — the value is on the host afterwards):
    * .item(), .tolist(), .cpu(), .numpy(), float/int/bool,
      np.asarray/np.array

False-negative bias is intentional, as in JAX's pass: an unknown call
(`self._decode(...)`) is NOT a source even when it returns tensors,
because treating every unknown as a source would drown the report in
noise.  The rule catches the syncs whose device origin is visible in the
same function.
"""
from __future__ import annotations

import ast
from typing import Optional, Set

#: torch.* namespaces and functions whose calls stay on the host
_TORCH_HOST = {"cuda", "device", "Generator", "is_tensor", "is_storage",
               "is_grad_enabled", "no_grad", "enable_grad", "inference_mode",
               "set_grad_enabled", "get_default_dtype", "set_default_dtype",
               "manual_seed", "seed", "initial_seed", "backends", "utils",
               "distributed", "profiler", "autograd", "_C", "finfo", "iinfo",
               "Size", "dtype", "jit", "testing", "library", "numel",
               "is_floating_point", "is_complex", "result_type",
               "promote_types", "can_cast", "get_num_threads",
               "set_num_threads", "use_deterministic_algorithms",
               "set_printoptions", "version", "hub", "onnx", "fx", "export",
               "overrides", "random", "multiprocessing", "compiler"}
#: torch.* callables whose RESULT is a tensor-producing callable
_TORCH_TRANSFORMS = {"vmap", "compile", "func"}
#: attribute reads that return host metadata, not tensors
_HOST_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                    "requires_grad", "layout", "names", "is_leaf",
                    "itemsize", "nbytes"}
#: methods whose result is on the host (some are also host-sync sinks)
_HOST_RESULT_METHODS = {"item", "tolist", "cpu", "numpy", "numel", "dim",
                        "size", "stride", "element_size", "nelement",
                        "get_device", "data_ptr", "storage_offset",
                        "is_contiguous", "is_floating_point", "is_complex",
                        "untyped_storage"}


def attr_chain(node: ast.AST) -> Optional[str]:
    """'torch.nn.functional.gelu' for nested Attribute/Name chains, else
    None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class TaintScope:
    """Taint facts for one function (or module) scope."""

    def __init__(self, tainted: Set[str], callables: Set[str]):
        #: names holding (or having held) tensors
        self.tainted = tainted
        #: names holding tensor-producing callables (vmap / compile results)
        self.device_callables = callables


def _is_transform_call(call: ast.Call) -> bool:
    """Is this `torch.vmap(...)`-style — its result a tensor-producing
    function?"""
    chain = attr_chain(call.func)
    if not chain:
        return False
    parts = chain.split(".")
    return parts[0] == "torch" and len(parts) > 1 \
        and parts[1] in _TORCH_TRANSFORMS


def _is_device_call(call: ast.Call, scope: TaintScope) -> bool:
    """Does this call produce a tensor?"""
    func = call.func
    chain = attr_chain(func)
    if chain:
        head, *rest = chain.split(".")
        if head == "F":
            return True
        if head == "torch":
            if not rest or rest[0] in _TORCH_HOST:
                return False
            if rest[0] in _TORCH_TRANSFORMS:
                return False     # the transform itself yields a callable
            return True
        if chain in scope.device_callables:
            return True
    # torch.vmap(f)(x): func is itself a call of a transform
    if isinstance(func, ast.Call) and _is_transform_call(func):
        return True
    # method call on a tainted value: x.sum(), x.float()
    if isinstance(func, ast.Attribute):
        if func.attr in _HOST_RESULT_METHODS:
            return False
        if _expr_tainted(func.value, scope):
            return True
    return False


def _is_host_conversion(call: ast.Call) -> bool:
    """float()/int()/bool()/np.asarray()/np.array() — the result is on
    the host regardless of the argument."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in ("float", "int", "bool",
                                                  "str", "len"):
        return True
    chain = attr_chain(func)
    return chain in ("np.asarray", "np.array", "numpy.asarray",
                     "numpy.array")


def _expr_tainted(node: ast.AST, scope: TaintScope) -> bool:
    if isinstance(node, ast.Name):
        return node.id in scope.tainted
    if isinstance(node, ast.Call):
        if _is_host_conversion(node):
            return False
        return _is_device_call(node, scope)
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_META_ATTRS:
            return False
        return _expr_tainted(node.value, scope)
    if isinstance(node, ast.Subscript):
        return _expr_tainted(node.value, scope)
    if isinstance(node, ast.BinOp):
        return (_expr_tainted(node.left, scope)
                or _expr_tainted(node.right, scope))
    if isinstance(node, ast.UnaryOp):
        return _expr_tainted(node.operand, scope)
    if isinstance(node, ast.Compare):
        return (_expr_tainted(node.left, scope)
                or any(_expr_tainted(c, scope) for c in node.comparators))
    if isinstance(node, ast.IfExp):
        return (_expr_tainted(node.body, scope)
                or _expr_tainted(node.orelse, scope))
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_expr_tainted(e, scope) for e in node.elts)
    if isinstance(node, ast.Starred):
        return _expr_tainted(node.value, scope)
    return False


def _assign_targets(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            yield from _assign_targets(el)
    elif isinstance(target, ast.Starred):
        yield from _assign_targets(target.value)
    # attribute/subscript targets (self.x = ...) are not tracked


def build_scope(fn: ast.AST, parent: Optional[TaintScope] = None
                ) -> TaintScope:
    """Flow-insensitive fixpoint over one function body (nested function
    bodies excluded — they get their own scope seeded from this one)."""
    scope = TaintScope(set(parent.tainted) if parent else set(),
                       set(parent.device_callables) if parent else set())

    def walk_no_nested(node):
        """Yield nodes in this scope, not descending into nested defs."""
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            yield from walk_no_nested(child)

    nodes = [n for top in ast.iter_child_nodes(fn)
             for n in walk_no_nested(top)]

    for _ in range(4):  # tiny fixpoint; chains are short
        changed = False
        for node in nodes:
            targets, value = (), None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = (node.target,), node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = (node.target,), node.value
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets, value = (node.target,), node.iter
            elif isinstance(node, ast.withitem) and node.optional_vars:
                targets, value = (node.optional_vars,), node.context_expr
            elif isinstance(node, ast.NamedExpr):
                targets, value = (node.target,), node.value
            if value is None:
                continue
            flat = [n for t in targets for n in _assign_targets(t)]
            if not flat:
                continue
            if isinstance(value, ast.Call) and _is_transform_call(value):
                for n in flat:
                    if n not in scope.device_callables:
                        scope.device_callables.add(n)
                        changed = True
                continue
            if _expr_tainted(value, scope):
                for n in flat:
                    if n not in scope.tainted:
                        scope.tainted.add(n)
                        changed = True
        if not changed:
            break
    return scope


def expr_tainted(node: ast.AST, scope: TaintScope) -> bool:
    """Public wrapper: is this expression tensor-tainted in `scope`?"""
    return _expr_tainted(node, scope)
