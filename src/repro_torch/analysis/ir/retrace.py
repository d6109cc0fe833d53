"""Retrace sentinel: count, inside a scope, the work a warmed-up engine
must never do again (the counterpart of the JAX package's
`ir/retrace.py`, which counts XLA backend compiles).

Three things play the part of JAX's retrace and pay their cost inside a
live tick:

  * kernel-library builds and loads — `repro_torch.kernels._build`'s
    `build` (an nvcc run) and `load` (a dlopen); warmup builds and loads
    every kernel a path launches, so serving after it must do neither;
  * engine programs run at a key that warmup did not compile — a bucket,
    a dense tick kind, "want", "text_kv", a prompt cache's encoder before
    its warmup, or a key whose host branches no compiled program took:
    it runs eagerly, building kernels and allocating its batch shapes;
  * program captures (`repro_torch.obs.profiling.compile_program`, the
    counterpart of an XLA compile): a CUDA graph captured inside the
    scope (on the CPU, a program compiled there), as the LLM engine's
    first `generate` or a train loop's second step does, and as a warmed
    engine must never do again.

The channels arrive as `repro_torch.obs.watch` events, fanned out to
every active sentinel, so sentinels nest and an inactive one costs
nothing.  `selftest()` makes each channel see a known event through the
same functions the port calls — a dlopen through `_build._dlopen`, a cold
key through `DiffusionServingEngine._note_program`, a compile through
`compile_program` — so a blind sentinel cannot report a vacuous zero.
"""
from __future__ import annotations

import ctypes.util
from typing import List

from repro_torch.obs import watch

__all__ = ["RetraceSentinel"]

_BUILD_EVENTS = ("kernel-build", "kernel-load")


class RetraceSentinel:
    """Context manager counting kernel builds / loads, cold engine
    programs and program captures in its scope.

    >>> with RetraceSentinel() as s:
    ...     session.tick()
    >>> s.count, s.compiled_names
    (0, [])

    `count` is builds + loads + cold programs + captures; `compiled_names`
    names each (a library path, engine[key], or capture: key); `ok` is
    `count == 0`."""

    def __init__(self):
        self.builds: List[str] = []
        self.programs: List[str] = []
        self.captures: List[str] = []

    def _on_event(self, kind: str, detail) -> None:
        if kind in _BUILD_EVENTS:
            self.builds.append(f"{kind}: {detail}")
        elif kind == "program":
            self.programs.append(str(detail))
        elif kind == "capture":
            self.captures.append(f"capture: {detail!r}")

    def __enter__(self) -> "RetraceSentinel":
        watch.listen(self._on_event)
        return self

    def __exit__(self, *exc) -> None:
        watch.unlisten(self._on_event)
        return None

    @property
    def compiled_names(self) -> List[str]:
        return self.builds + self.programs + self.captures

    @property
    def count(self) -> int:
        return len(self.builds) + len(self.programs) + len(self.captures)

    @property
    def ok(self) -> bool:
        return self.count == 0

    def selftest(self) -> bool:
        """True when every channel sees a known event: a library loaded
        through `_build._dlopen` (the C library, which every process has),
        a program key no warmup ran, through the engine's own
        `_note_program`, and a program compiled through `compile_program`
        (on the CPU, where it captures nothing but announces the same
        event)."""
        from repro_torch.kernels import _build
        from repro_torch.obs.profiling import compile_program
        from repro_torch.serving.diffusion import DiffusionServingEngine

        class _Cold:
            cfg = type("cfg", (), {"name": "selftest"})()
            _warm_keys: set = set()

        with RetraceSentinel() as probe:
            _build._dlopen(ctypes.util.find_library("c") or "libc.so.6")
            DiffusionServingEngine._note_program(_Cold(), "__selftest__")
            compile_program(lambda: None, key="__selftest__", device="cpu")
        return (len(probe.builds) >= 1 and len(probe.programs) >= 1
                and len(probe.captures) >= 1)
