"""Device resolution shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
CUDA device and no explicit `device`, they raise instead of quietly
running on the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tree_device(tree) -> Optional[torch.device]:
    """Device of the first tensor leaf of a nested dict (None if empty)."""
    for v in tree.values():
        d = tree_device(v) if isinstance(v, dict) else v.device
        if d is not None:
            return d
    return None


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Host data (a numpy array, a scalar or a CPU tensor) on `device`
    without a stream sync.

    torch's blocking host-to-device copy from pageable memory ends in a
    cudaStreamSynchronize: the host waits for every kernel queued before
    it.  On a CUDA device the data goes through pinned memory instead and
    is copied with non_blocking=True, which waits for nothing (torch's
    pinned-memory cache keeps the staging buffer until the copy has run).
    On the CPU this is torch.as_tensor."""
    device = torch.device(device)
    t = torch.as_tensor(a, dtype=dtype)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
