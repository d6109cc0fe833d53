"""Minimal pytree helpers over the port's containers: nested dicts (keys in
sorted order, as JAX flattens a dict), NamedTuples (fields in order),
lists and tuples; anything else is a leaf.

The orders and names follow `jax.tree_util`, so that a flattened tree of
the port lines up leaf for leaf with the JAX package's: `tree_paths` gives
the key strings the JAX checkpoint store writes (`.params/blocks/attn/wq`
for a NamedTuple field, `mu/0` for a list index) and `treedef_str` the
string of `jax.tree_util.tree_structure`."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(key string, child)] of a container, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def tree_paths(tree: Tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flattening order, the path's keys joined
    with '/'."""
    out = []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix), node))
            return
        for key, child in kids:
            walk(child, prefix + [key])

    walk(tree, [])
    return out


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` (and the matching leaves of `rest`),
    keeping the containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, c, *(r[i] for r in rest))
                            for i, c in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(tree: Tree, leaves: list) -> Tree:
    """`tree`'s containers with `leaves` in its flattening order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten_like: more leaves than the tree has")
    return out


def treedef_str(tree: Tree) -> str:
    """The string `str(jax.tree_util.tree_structure(tree))` gives."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(c) for c in node) + "])")
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"
