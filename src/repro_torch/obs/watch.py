"""Observer hooks of the port's program verifier
(`repro_torch.analysis.ir`) and its retrace sentinel.

The engines, the prompt cache and the kernel builder emit events here; a
verifier or a sentinel listens only while it is active, and with no
listener an event costs one test of an empty list.  Events (kind,
detail):

  "priced-read"   +1 / -1 around `host_read`'s copy
  "kernel-build"  a kernel library compiled (its path)
  "kernel-load"   a shared library loaded (its path)
  "program"       an engine ran a program at a key its warmup did not run
                  (engine and key), or a prompt cache encoded before its
                  warmup

`host_read` is the one designed device-to-host read of a program: the
device plan's packed copy (one a tick) and a prompt-cache miss's
embedding.  The verifier counts it as the program's priced read, never as
a stray sync.
"""
from __future__ import annotations

from typing import Callable, List

__all__ = ["listen", "unlisten", "emit", "host_read"]

Listener = Callable[[str, object], None]
_LISTENERS: List[Listener] = []


def listen(fn: Listener) -> None:
    _LISTENERS.append(fn)


def unlisten(fn: Listener) -> None:
    _LISTENERS.remove(fn)


def emit(kind: str, detail: object = None) -> None:
    for fn in list(_LISTENERS):
        fn(kind, detail)


def host_read(t):
    """t's values as a host numpy array of its own (never a view of a CPU
    tensor: the programs' outputs are static buffers that the next run
    overwrites): the priced device-to-host read."""
    if _LISTENERS:
        emit("priced-read", 1)
    try:
        return t.to("cpu", copy=True).numpy()
    finally:
        if _LISTENERS:
            emit("priced-read", -1)
