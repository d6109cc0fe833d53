"""Pytree checkpoint store: .npz tensors + JSON sidecar, the port of the
JAX package's `checkpoint/store.py` and its on-disk format.

Layout:  <dir>/step_<n:08d>/arrays.npz + arrays.json + meta.json, written
into a temporary directory and renamed into place; `save` keeps the newest
`keep`.  Array names are the JAX store's paths (`repro_torch.tree`):
dict keys, `.field` for a NamedTuple field (a `TrainState` gives
`.params/...`, `.opt/.step`, `.opt/.mu/...`), list indices.  bfloat16,
which numpy lacks, is stored as its uint16 bits with the true dtype in the
sidecar.  Leaves are tensors, numpy arrays or Python scalars; `restore`
returns tensors on `tree_like`'s devices and in its dtypes."""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten_like, treedef_str

Tree = Any


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_pytree(tree: Tree, path: str):
    """Serialize a tree of tensors / arrays to <path>.npz + <path>.json."""
    items = tree_paths(tree)
    arrays = {k: _to_numpy(v) for k, v in items}
    dtypes = {k: _dtype_name(v) for k, v in items}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    with open(path + ".json", "w") as f:
        json.dump({"treedef": treedef_str(tree), "keys": [k for k, _ in items],
                   "dtypes": dtypes}, f)


def _to_tensor(arr: np.ndarray, ref) -> torch.Tensor:
    if isinstance(ref, torch.Tensor):
        dtype, device = ref.dtype, ref.device
    else:
        dtype, device = torch.from_numpy(np.asarray(ref)).dtype, "cpu"
    arr = np.require(arr, requirements="W")    # np.load's are fresh
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def load_pytree(tree_like: Tree, path: str) -> Tree:
    """Restore into the structure of `tree_like` (shape, dtype and device
    donor)."""
    items = tree_paths(tree_like)
    leaves = []
    with np.load(path + ".npz") as data:
        for key, ref in items:
            arr = data[key]
            shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                                 f"expected {shape}")
            leaves.append(_to_tensor(arr, ref))
    return tree_unflatten_like(tree_like, leaves)


def save(ckpt_dir: str, step: int, tree: Tree, extra: Optional[dict] = None,
         keep: int = 3):
    """Save a training checkpoint; prunes to the most recent `keep`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    save_pytree(tree, os.path.join(tmp, "arrays"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for s in sorted(_list_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Tree, step: Optional[int] = None):
    """Returns (tree, step, extra) for `step` (default: the latest)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tree = load_pytree(tree_like, os.path.join(d, "arrays"))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return tree, step, meta.get("extra", {})
