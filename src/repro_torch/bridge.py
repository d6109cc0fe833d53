"""Weight bridge: a params tree with array leaves (for example the JAX
package's params, converted leaf by leaf with `numpy.asarray`) -> nested
dicts of torch tensors on a given device.

Keys, the `(in, out)` matrix layout, the stacked per-layer leading axis
and each leaf's dtype stay as they are (a MoE router stays f32 in a bf16
tree, as JAX keeps it).  Weights are bridged rather than re-drawn, because torch
cannot reproduce `jax.random`.  A bfloat16 leaf arrives as an
`ml_dtypes.bfloat16` numpy array, which `torch.from_numpy` rejects, so its
bits travel as 16-bit integers and are reinterpreted — the same
bf16-as-uint16 convention the JAX checkpoint store uses.  This module reads
arrays only; it imports no JAX.  `train_state_to_torch` bridges a whole
training state (params, AdamW moments and step).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_torch(tree: Mapping[str, Any], device: DeviceLike = None):
    """Nested dict of array leaves -> nested dict of tensors on `device`
    (the GPU unless the caller passes device="cpu")."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return to_tensor(node, dev)

    return walk(tree)


def train_state_to_torch(params: Mapping[str, Any], opt, device: DeviceLike = None):
    """A JAX training state -> the port's `TrainState` on `device`: params,
    the AdamW moments `opt.mu` / `opt.nu` and the step count `opt.step`
    (any object with those attributes; leaves as arrays), so that a run
    started in JAX continues in the port."""
    from repro_torch.optim import AdamWState
    from repro_torch.train.steps import TrainState
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(params=to_torch(params, dev),
                      opt=AdamWState(step=step, mu=to_torch(opt.mu, dev),
                                     nu=to_torch(opt.nu, dev)))
