"""Device resolution shared by the port's entry points, and the static
input buffers of captured programs.

Entry points run on the GPU unless the caller asks for the CPU: with no
CUDA device and no explicit `device`, they raise instead of quietly
running on the CPU.

A CUDA graph replays fixed addresses, so every value a captured program
takes from the host lives in a static buffer that the owner refills
before each replay (`StaticInputs`): a pinned host buffer per name on the
card, copied non-blocking into a static device buffer.  A `Staged` value
carries the host array beside its device buffer: host code branches on
the host array (`any()` / `all()`, recorded by `branch_log` so that a
program can be keyed on the branches it took), device code reads the
buffer.  On the CPU the same buffers are plain tensors and the same
functions run eagerly."""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Set, Tuple, Union

import numpy as np
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
    without a stream sync; a `Staged` value gives its device buffer.

    torch's blocking host-to-device copy from pageable memory ends in a
    cudaStreamSynchronize: the host waits for every kernel queued before
    it.  On a CUDA device the data goes through pinned memory instead and
    is copied with non_blocking=True, which waits for nothing (torch's
    pinned-memory cache keeps the staging buffer until the copy has run).
    On the CPU this is torch.as_tensor."""
    if isinstance(a, Staged):
        t = a.dev
        return t if dtype is None or t.dtype == dtype else t.to(dtype)
    device = torch.device(device)
    t = torch.as_tensor(a, dtype=dtype)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_BRANCHES = threading.local()


class Staged:
    """A host array and its copy in a static device buffer.

    `tag` names the input: ("want_c",) for the array itself, ("steps", k)
    for `steps % k == 0` (`interval_pred` derives it).  `any()` and `all()`
    answer from the host array and, inside `branch_log`, record (tag, op,
    answer): the host branches a program took, which its key must fix."""

    __slots__ = ("host", "dev", "tag")

    def __init__(self, host, dev: torch.Tensor, tag: Tuple = ()):
        self.host = np.asarray(host)
        self.dev = dev
        self.tag = tag

    def _ask(self, op: str, answer: bool) -> bool:
        log = getattr(_BRANCHES, "log", None)
        if log is not None:
            if not self.tag:
                raise RuntimeError("an untagged Staged value decided a host "
                                   "branch of a program")
            log.add((self.tag, op, answer))
        return answer

    def any(self) -> bool:
        return self._ask("any", bool(self.host.any()))

    def all(self) -> bool:
        return self._ask("all", bool(self.host.all()))

    def __array__(self, dtype=None, copy=None):
        return self.host if dtype is None else self.host.astype(dtype)

    def derive(self, host, dev: torch.Tensor, modulus: int) -> "Staged":
        """`self % modulus == 0` as a Staged value tagged for guards."""
        tag = (self.tag[0], modulus) if len(self.tag) == 1 else ()
        return Staged(host, dev, tag)


@contextmanager
def branch_log():
    """Collect the (tag, op, answer) of every `Staged` branch in scope."""
    prev = getattr(_BRANCHES, "log", None)
    log: Set = set()
    _BRANCHES.log = log
    try:
        yield log
    finally:
        _BRANCHES.log = prev


def guards_hold(guards, inputs: Dict[str, np.ndarray]) -> bool:
    """Would a run on host `inputs` take the branches `guards` recorded?"""
    for tag, op, answer in guards:
        arr = np.asarray(inputs[tag[0]])
        if len(tag) > 1:
            arr = arr % tag[1] == 0
        if bool(getattr(arr, op)()) != answer:
            return False
    return True


class StaticInputs:
    """Named static buffers that captured programs read their host inputs
    from, allocated outside any graph pool.

    `put(name, array)` fills the buffer: on the card through a pinned host
    buffer and a non-blocking copy (the host waits for nothing), on the
    CPU a plain copy.  A pinned buffer is refilled only once its previous
    copy has run: the serving engine's one synchronize a tick guarantees
    that between ticks, and an event recorded after each copy guards
    every other caller (warmup's back-to-back replays).
    `staged(name, array)` is `put` returning a `Staged`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.dev: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, np.ndarray] = {}
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copied: Dict[str, torch.cuda.Event] = {}

    def alloc(self, name: str, shape, dtype) -> torch.Tensor:
        t = self.dev.get(name)
        if t is not None and tuple(t.shape) == tuple(shape) \
                and t.dtype == dtype:
            return t
        t = torch.zeros(shape, dtype=dtype, device=self.device)
        self.dev[name] = t
        self.host[name] = np.zeros(shape, _NP_DTYPES[dtype])
        if self.device.type == "cuda":
            self._pinned[name] = torch.zeros(shape, dtype=dtype,
                                             pin_memory=True)
            self._copied[name] = torch.cuda.Event()
        return t

    def put(self, name: str, a) -> torch.Tensor:
        dst = self.dev[name]
        host = self.host[name]
        host[...] = np.asarray(a).reshape(host.shape)
        pinned = self._pinned.get(name)
        if pinned is None:
            dst.copy_(torch.from_numpy(host))
        else:
            copied = self._copied[name]
            copied.synchronize()      # at once unless the last copy pends
            pinned.copy_(torch.from_numpy(host))
            dst.copy_(pinned, non_blocking=True)
            copied.record()
        return dst

    def staged(self, name: str, a=None) -> Staged:
        """The buffer as a Staged value (after `put(name, a)` when given)."""
        if a is not None:
            self.put(name, a)
        return Staged(self.host[name], self.dev[name], (name,))


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int64: np.int64, torch.bool: np.bool_,
              torch.bfloat16: np.float32}


def tree_copy_(dst, src) -> None:
    """Copy every tensor leaf of `src` into the matching leaf of `dst` in
    place (dicts, NamedTuples, lists and tuples; the structure of `dst`).
    A leaf that is already its destination is skipped; a source leaf that
    is another destination leaf is cloned first, so no copy reads a leaf
    an earlier copy overwrote."""
    from repro_torch.tree import tree_leaves
    d_leaves, s_leaves = tree_leaves(dst), tree_leaves(src)
    if len(d_leaves) != len(s_leaves):
        raise ValueError(f"tree_copy_: {len(s_leaves)} source leaves for "
                         f"{len(d_leaves)} destinations")
    ids = {id(t): i for i, t in enumerate(d_leaves)}
    srcs = [s.clone() if ids.get(id(s), i) != i else s
            for i, s in enumerate(s_leaves)]
    for d, s in zip(d_leaves, srcs):
        if d is not s:
            d.copy_(s)
