"""Abstractions shared by the LLM and diffusion serving engines.

Both engines follow the same continuous-batching shape: a FIFO admission
queue feeds a fixed pool of slots, every slot advances through one compiled
device program per tick, and finished slots are refilled mid-flight.  The
request/queue machinery is host-side and backend-agnostic, so it lives here
rather than in either engine.
"""
from __future__ import annotations

from collections import deque
from typing import Generic, Iterable, List, Optional, TypeVar

R = TypeVar("R")


class RequestQueue(Generic[R]):
    """FIFO admission queue with batch pops.

    Tracks `submitted` so telemetry can report queueing depth over time.
    """

    def __init__(self, requests: Iterable[R] = ()):
        self._q: deque = deque(requests)
        self.submitted = len(self._q)

    def push(self, request: R) -> None:
        self._q.append(request)
        self.submitted += 1

    def pop(self) -> Optional[R]:
        return self._q.popleft() if self._q else None

    def pop_many(self, n: int) -> List[R]:
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out

    def peek(self) -> Optional[R]:
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
