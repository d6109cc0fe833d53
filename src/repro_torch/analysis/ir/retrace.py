"""Retrace sentinel: count, inside a scope, the work a warmed-up engine
must never do again (the counterpart of the JAX package's
`ir/retrace.py`, which counts XLA backend compiles).

The eager port compiles no programs, but two things play the part of
JAX's retrace and pay their cost inside a live tick:

  * kernel-library builds and loads — `repro_torch.kernels._build`'s
    `build` (an nvcc run) and `load` (a dlopen); warmup builds and loads
    every kernel a path launches, so serving after it must do neither;
  * engine programs run at a key that warmup did not run — a bucket, a
    dense tick kind, "want", "text_kv", or a prompt cache's encoder before
    its warmup: the first run of a program builds kernels, allocates its
    batch shapes and, once CUDA graphs capture each bucket (ROADMAP
    §A.10), would capture inside a live tick.  That capture is the third
    channel §A.10 adds.

Both channels arrive as `repro_torch.obs.watch` events, fanned out to
every active sentinel, so sentinels nest and an inactive one costs
nothing.  `selftest()` makes each channel see a known event through the
same functions the port calls — a dlopen through `_build._dlopen`, a cold
key through `DiffusionServingEngine._note_program` — so a blind sentinel
cannot report a vacuous zero.
"""
from __future__ import annotations

import ctypes.util
from typing import List

from repro_torch.obs import watch

__all__ = ["RetraceSentinel"]

_BUILD_EVENTS = ("kernel-build", "kernel-load")


class RetraceSentinel:
    """Context manager counting kernel builds / loads and cold engine
    programs in its scope.

    >>> with RetraceSentinel() as s:
    ...     session.tick()
    >>> s.count, s.compiled_names
    (0, [])

    `count` is builds + loads + cold programs; `compiled_names` names each
    (a library path, or engine[key]); `ok` is `count == 0`."""

    def __init__(self):
        self.builds: List[str] = []
        self.programs: List[str] = []

    def _on_event(self, kind: str, detail) -> None:
        if kind in _BUILD_EVENTS:
            self.builds.append(f"{kind}: {detail}")
        elif kind == "program":
            self.programs.append(str(detail))

    def __enter__(self) -> "RetraceSentinel":
        watch.listen(self._on_event)
        return self

    def __exit__(self, *exc) -> None:
        watch.unlisten(self._on_event)
        return None

    @property
    def compiled_names(self) -> List[str]:
        return self.builds + self.programs

    @property
    def count(self) -> int:
        return len(self.builds) + len(self.programs)

    @property
    def ok(self) -> bool:
        return self.count == 0

    def selftest(self) -> bool:
        """True when both channels see a known event: a library loaded
        through `_build._dlopen` (the C library, which every process has)
        and a program key no warmup ran, through the engine's own
        `_note_program`."""
        from repro_torch.kernels import _build
        from repro_torch.serving.diffusion import DiffusionServingEngine

        class _Cold:
            cfg = type("cfg", (), {"name": "selftest"})()
            _warm_keys: set = set()

        with RetraceSentinel() as probe:
            _build._dlopen(ctypes.util.find_library("c") or "libc.so.6")
            DiffusionServingEngine._note_program(_Cold(), "__selftest__")
        return len(probe.builds) >= 1 and len(probe.programs) >= 1
