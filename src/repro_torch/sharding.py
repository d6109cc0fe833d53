"""Sharding rules of the port (its own copy of the JAX package's
`sharding.py`): a spec for every parameter, input, cache and logits leaf
on the production mesh, and the DTensor placements a spec means.

Two mesh layouts are supported transparently:

  contract mesh  ("data", "model")               [+ leading "pod"]
  logical mesh   ("data", "attn", "ffn")         [+ leading "pod"]

The logical mesh (`launch.mesh.make_logical_mesh`) factors the tensor
axis per architecture so that attention-head sharding stays head-aligned
(attn | KV heads); "attn" and "ffn" composed recover the full tensor
parallelism for FFN / vocab / expert-inner dims.  On the contract mesh
the single "model" axis plays both roles, and `_sanitize` drops it
wherever the dim does not divide.

Rules:
  * attention projections: head axis on ATTN
  * MLP / expert-inner / vocab / mamba-inner dims: on TP (= attn+ffn)
  * MoE expert axis: on "data" (expert parallelism)
  * activations: batch on ("pod", "data")
  * KV caches: batch on data, kv heads on ATTN, head_dim on "ffn"
  * optimizer moments: the spec of their param

A spec is a tuple shaped like JAX's PartitionSpec: one entry per tensor
dim, each None, an axis name or a tuple of axis names (a composed axis,
major first), so `tuple(spec)` compares equal to JAX's.  The rules read
only a mesh's axis names and sizes: a `DeviceMesh` (`mesh_dim_names`,
`size`) or any object with JAX's `axis_names` and `shape[name]`.

`placements(mesh, spec)` turns a spec into DTensor placements.  JAX maps
tensor dims to mesh axes; DTensor maps each mesh dim to a placement, so
a composed axis becomes one `Shard(d)` on each of its mesh dims, in mesh
order (DTensor splits a dim sharded on several mesh dims major to minor
in that order, as JAX does for a composed axis).  `distribute` builds a
DTensor tree from a tree of tensors and a tree of specs.
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional

from repro_torch.tree import tree_map, tree_paths, tree_unflatten_like

Tree = Any


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, an axis name
    or a tuple of names (JAX's PartitionSpec; a tuple, so a spec tree
    keeps its specs whole as leaves).  A one-name tuple is stored as the
    name, as JAX's PartitionSpec stores it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple)
                                     and len(a) == 1 else a for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# ----------------------------------------------------------------------
# mesh views and helpers
# ----------------------------------------------------------------------

def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return int(mesh.size(list(names).index(name)))
    return int(mesh.shape[name])


def batch_axes(mesh):
    """The composed batch axis: ("pod", "data") on multi-pod meshes."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def attn_axis(mesh) -> str:
    return "attn" if "attn" in axis_names(mesh) else "model"


def tp_axes(mesh):
    """Full tensor-parallel axis (attn+ffn composed, or plain model)."""
    return ("attn", "ffn") if "attn" in axis_names(mesh) else ("model",)


def ffn_axis(mesh) -> str:
    return "ffn" if "ffn" in axis_names(mesh) else "model"


def _as_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axes_size(mesh, axes) -> int:
    return math.prod(axis_size(mesh, a) for a in _as_tuple(axes))


def _fit(mesh, axes, dim: int):
    """axes if dim is divisible by their product, else None (replicate)."""
    return axes if dim % _axes_size(mesh, axes) == 0 else None


def _path_str(path) -> str:
    """A leaf's path: a '/'-joined string (`tree.tree_paths`), or a
    sequence of keys."""
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def _size(leaf) -> int:
    return math.prod(int(s) for s in leaf.shape)


# ----------------------------------------------------------------------
# parameter sharding rules
# ----------------------------------------------------------------------

def param_spec(path: str, leaf, mesh) -> P:
    """Spec for one parameter leaf (unstacked suffix rules; a leading None
    is prepended for layer-stacked block params)."""
    ATTN, TP = attn_axis(mesh), tp_axes(mesh)
    stacked = bool(re.search(r"(^|/)(blocks|enc_blocks|dec_blocks)/", path))
    ndim = len(leaf.shape) - (1 if stacked else 0)

    def out(*spec):
        spec = list(spec)
        spec = spec[:ndim] + [None] * max(0, ndim - len(spec))
        if stacked:
            spec = [None] + spec
        return P(*spec)

    # --- embeddings / vocab projections: vocab on the full tensor axis ---
    if re.search(r"(^|/)embed$", path):
        return out(TP, None)                 # (vocab, d)
    if re.search(r"(^|/)lm_head$", path):
        return out(None, TP)                 # (d, vocab)

    # --- MoE experts: expert axis on data + inner ff on tensor axis ---
    if re.search(r"/moe/w_(gate|up)$", path):
        return out("data", None, TP)         # (E, d, ff)
    if re.search(r"/moe/w_down$", path):
        return out("data", TP, None)         # (E, ff, d)
    if re.search(r"/moe/router$", path):
        return out(None, None)               # small; replicate for routing
    if re.search(r"/moe/(shared|dense_res)/", path):
        if re.search(r"w_down$", path):
            return out(TP, None)
        return out(None, TP)

    # --- attention projections: whole heads on ATTN ---
    if re.search(r"(attn|self|cross)/w[qkv]$", path):
        return out(None, ATTN)               # (d, H*hd), head-aligned
    if re.search(r"(attn|self|cross)/wo$", path):
        return out(ATTN, None)               # (H*hd, d)
    if re.search(r"(attn|self|cross)/b[qkv]$", path):
        return out(ATTN)

    # --- MLA (deepseek) ---
    if re.search(r"attn/(w_dkv|w_kr)$", path):
        return out(None, None)               # small lora-down: replicate
    if re.search(r"attn/(w_uk|w_uv)$", path):
        return out(ATTN, None, None)         # (H, r, d): heads on ATTN

    # --- MLP ---
    if re.search(r"mlp/(w_up|w_gate)$", path):
        return out(None, TP)
    if re.search(r"mlp/w_down$", path):
        return out(TP, None)

    # --- mamba: inner channels on the full tensor axis ---
    if re.search(r"mamba/in_proj$", path):
        return out(None, TP)
    if re.search(r"mamba/out_proj$", path):
        return out(TP, None)
    if re.search(r"mamba/(x_proj|dt_proj)$", path):
        return out(None, None)
    if re.search(r"mamba/(conv_w|conv_b|A_log|D|dt_bias|norm_w)$", path):
        return out(None)

    # --- DiT ---
    if re.search(r"(ada_w|final_ada_w)$", path):
        return out(None, TP)
    if re.search(r"patch_out$", path):
        return out(TP, None)
    if re.search(r"(patch_in|t_mlp1|t_mlp2|vision_proj|class_embed)$", path):
        return out(None, None)

    # norms, biases, everything small: replicate
    return out()


def _sanitize(mesh, spec: P, shape) -> P:
    """Drop mesh axes whose size does not divide the dim (whisper's 51865
    vocab, GQA kv heads < shards, ...): DTensor would shard unevenly."""
    return P(*(_fit(mesh, axes, int(shape[i])) if axes else None
               for i, axes in enumerate(spec)))


def _add_fsdp(mesh, spec: P, leaf) -> P:
    """ZeRO/FSDP: additionally shard a large leaf over "data" on its first
    free divisible dim (weights are all-gathered at use; optimizer moments
    inherit the spec and shrink by the data axis)."""
    if _size(leaf) < 1 << 20 or any("data" in _as_tuple(ax)
                                    for ax in spec if ax):
        return spec
    fixed = list(spec)
    for i, ax in enumerate(fixed):
        dim = int(leaf.shape[i])
        if ax is None and dim % axis_size(mesh, "data") == 0 and dim >= 1024:
            fixed[i] = "data"
            return P(*fixed)
    return spec


def params_sharding(params: Tree, mesh, fsdp: bool = False) -> Tree:
    """Spec tree matching `params`.  fsdp=True additionally shards big
    weights over the data axis (the >10B-param train cases)."""
    specs = []
    for path, leaf in tree_paths(params):
        spec = _sanitize(mesh, param_spec(path, leaf, mesh), leaf.shape)
        specs.append(_add_fsdp(mesh, spec, leaf) if fsdp else spec)
    return tree_unflatten_like(params, specs)


# ----------------------------------------------------------------------
# activations / inputs / caches
# ----------------------------------------------------------------------

def inputs_sharding(inputs: Tree, mesh) -> Tree:
    """Batch-shard every input leaf on its leading axis (replicate if the
    batch does not divide the mesh, e.g. long_500k's global batch of 1)."""
    ba = batch_axes(mesh)

    def spec(leaf):
        return P(*((_fit(mesh, ba, int(leaf.shape[0])),)
                   + (None,) * (len(leaf.shape) - 1))) if len(leaf.shape) \
            else P()

    return tree_map(spec, inputs)


def cache_spec(path: str, leaf, mesh) -> P:
    """KV/state caches: batch on data, kv heads on ATTN, head_dim on ffn.

    Layouts: k/v (L, B, W, KH, hd); ckv/kr (L, B, W, r); pos (B, W); conv
    (L, B, W, C); state (L, B, ..., n); encdec xk/xv (L, B, S, H, hd).

    When batch cannot shard (long_500k, B = 1) the KV *sequence* axis
    takes the data axis instead: a sequence-parallel cache."""
    ba = batch_axes(mesh)
    ATTN, FFN, TP = attn_axis(mesh), ffn_axis(mesh), tp_axes(mesh)
    name = path.split("/")[-1]
    shape = [int(s) for s in leaf.shape]
    if name == "pos":
        b = _fit(mesh, ba, shape[0])
        w = ba if b is None and shape[1] % _axes_size(mesh, ba) == 0 else None
        return P(b, w)
    if name in ("k", "v", "xk", "xv", "ckv", "kr"):
        b = _fit(mesh, ba, shape[1])
        w = ba if b is None and shape[2] % _axes_size(mesh, ba) == 0 else None
        if name in ("ckv", "kr"):
            # MLA's compressed cache has no head axis: the sequence axis
            # takes the tensor axis (sequence-parallel)
            wm = _fit(mesh, TP, shape[2])
            return P(None, b, wm if w is None else w, None)
        kh = _fit(mesh, ATTN, shape[3])
        hd = _fit(mesh, FFN, shape[4]) if FFN != ATTN else None
        return P(None, b, w, kh, hd)
    if name == "conv":
        return P(None, _fit(mesh, ba, shape[1]), None,
                 _fit(mesh, TP, shape[3]))
    if name == "state":
        spec = [None, _fit(mesh, ba, shape[1])] + [None] * (len(shape) - 2)
        if len(shape) >= 3:
            spec[2] = _fit(mesh, TP, shape[2])   # heads / din axis
        return P(*spec)
    # predictive-cache diff stacks (order+1, B, ...): batch on axis 1
    if name == "diffs":
        return P(None, _fit(mesh, ba, shape[1]), *[None] * (len(shape) - 2))
    return P(*[None] * len(shape))


def cache_sharding(cache: Tree, mesh) -> Tree:
    return tree_unflatten_like(
        cache, [cache_spec(p, leaf, mesh) for p, leaf in tree_paths(cache)])


def logits_sharding(mesh, ndim: int = 3, batch: Optional[int] = None,
                    vocab: Optional[int] = None) -> P:
    """(B, ..., vocab) -> (batch axes, ..., tensor axes)."""
    ba = batch_axes(mesh)
    if batch is not None:
        ba = _fit(mesh, ba, batch)
    tp = tp_axes(mesh)
    if vocab is not None:
        tp = _fit(mesh, tp, vocab)   # whisper's 51865 does not divide 16
    return P(ba, *[None] * (ndim - 2), tp)


def replicated(mesh) -> P:
    return P()


# ----------------------------------------------------------------------
# specs as DTensor placements
# ----------------------------------------------------------------------

def placements(mesh, spec: P) -> list:
    """DTensor placements over `mesh` for a spec: `Shard(d)` on every mesh
    dim that tensor dim d names (a composed axis shards d on each of its
    mesh dims, in mesh order), `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        for a in _as_tuple(axes):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis '{a}' shards two "
                                 f"dims")
            out[i] = Shard(d)
    return out


def local_shape(mesh, spec: P, shape) -> tuple:
    """The shape of one rank's shard of a tensor of `shape` under `spec`
    (the rules only shard dims that the axes divide)."""
    shape = [int(s) for s in shape]
    for d, axes in enumerate(spec):
        n = _axes_size(mesh, axes)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        shape[d] //= n
    return tuple(shape)


def distribute(tree: Tree, specs: Tree, mesh) -> Tree:
    """A DTensor tree: each tensor of `tree` distributed over `mesh` by
    the spec at its place in `specs` (every rank holds the whole tensor,
    as after a seeded init, and keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor
    leaves = [l for _, l in tree_paths(tree)]
    spec_leaves = _spec_leaves(specs, len(leaves))
    return tree_unflatten_like(tree, [
        distribute_tensor(t, mesh, placements(mesh, s))
        for t, s in zip(leaves, spec_leaves)])


def from_local_shards(tree: Tree, specs: Tree, mesh, make) -> Tree:
    """A DTensor tree whose local shards `make(shape, dtype)` builds (for
    example fake tensors in a dry run): no collective, no global tensor."""
    from torch.distributed.tensor import DTensor
    leaves = [l for _, l in tree_paths(tree)]
    spec_leaves = _spec_leaves(specs, len(leaves))
    out = []
    for t, s in zip(leaves, spec_leaves):
        local = make(local_shape(mesh, s, t.shape), t.dtype)
        shape = tuple(int(n) for n in t.shape)
        out.append(DTensor.from_local(local, mesh, placements(mesh, s),
                                      run_check=False, shape=shape,
                                      stride=_contiguous_strides(shape)))
    return tree_unflatten_like(tree, out)


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


def _spec_leaves(specs: Tree, n: int) -> list:
    """The specs of a spec tree, in flattening order."""
    out = []

    def walk(node):
        if isinstance(node, P):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            for c in node:
                walk(c)

    walk(specs)
    if len(out) != n:
        raise ValueError(f"{len(out)} specs for {n} leaves")
    return out


__all__ = ["P", "axis_names", "axis_size", "batch_axes", "attn_axis",
           "tp_axes", "ffn_axis", "param_spec", "params_sharding",
           "inputs_sharding", "cache_spec", "cache_sharding",
           "logits_sharding", "replicated", "placements", "local_shape",
           "distribute", "from_local_shards"]
