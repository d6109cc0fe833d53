"""Step-interleaved continuous-batching scheduler (host side).

A fixed pool of slots; each slot holds one request at its own denoising
step.  All slots advance together by one vmapped device program per tick;
slots whose request has exhausted its step budget are harvested and refilled
from the admission queue *mid-flight* — the other slots never stall.

Phase-aligned admission: interval-scheduled policies (FORA, TaylorSeer,
FreqCa, ...) compute at per-request steps {0, N, 2N, ...}.  If requests are
admitted only at global ticks that are multiples of N, every slot's compute
steps land on the same ticks, so (N-1)/N of all ticks need no backbone at
all and the engine dispatches the cheap forecast/reuse program.  Admission
of a freed slot waits at most N-1 ticks; with the batch still advancing this
costs far less than it saves (see benchmarks/bench_serving.py).

This module is pure host-side bookkeeping — no tensors — so the lifecycle is
unit-testable in microseconds (tests/test_torch_serving.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from repro_torch.serving.common import RequestQueue


@dataclass(frozen=True, eq=False)
class DiffusionRequest:
    """One latent-generation request.

    num_steps is the request's denoising step budget — requests with
    different budgets share slots (mixed-budget continuous batching).

    cfg_scale > 0 makes the request *guided*: the engine runs a second,
    unconditional backbone branch and blends eps = e_u + s (e_c - e_u).
    `null_label` selects that branch's conditioning: None (the model's
    null-class embedding), an int class id, or an arbitrary (d_model,)
    conditioning VECTOR — the negative-prompt path, which bypasses the
    class-embedding table entirely.  Guided and unguided requests share one
    slot pool.

    `modality` routes the request to the matching per-modality sub-pool in
    a mixed pool (repro.modalities.MixedModalityEngine); a single-modality
    DiffusionServingEngine ignores it.

    `prompt_tokens` carries text conditioning (T2I/T2V): a prompt string or
    an explicit token-id sequence, resolved through the engine's PromptCache
    at admission (text-enabled configs only).  `neg_prompt_tokens` is the
    CFG negative prompt — its K/V tables feed the slot's uncond rows and
    its pooled embedding rides the null-vec path (so it conflicts with a
    vector-valued `null_label`; the engine rejects that combination)."""
    request_id: int
    num_steps: int
    seed: int = 0
    class_label: int = 0
    traffic_class: str = "default"
    cfg_scale: float = 0.0
    null_label: Optional[Any] = None
    modality: str = "image"
    prompt_tokens: Optional[Any] = None
    neg_prompt_tokens: Optional[Any] = None

    @property
    def guided(self) -> bool:
        return self.cfg_scale > 0.0


@dataclass
class Slot:
    """One slot's lifecycle state."""
    index: int
    request: Optional[DiffusionRequest] = None
    step: int = 0
    admit_tick: int = -1

    @property
    def busy(self) -> bool:
        return self.request is not None

    @property
    def done(self) -> bool:
        return self.busy and self.step >= self.request.num_steps


class SlotScheduler:
    """Admission queue + slot pool + per-request step budgets.

    The engine drives it as:
        admitted = sched.admit(tick)        # refill free slots (aligned)
        ...run one device tick...
        sched.advance()                     # step += 1 on busy slots
        for slot, req in sched.harvest():   # budget exhausted -> free slot
    """

    def __init__(self, num_slots: int, align: int = 1):
        assert num_slots >= 1 and align >= 1
        self.slots: List[Slot] = [Slot(i) for i in range(num_slots)]
        self.align = align
        self.queue: RequestQueue = RequestQueue()
        self._metrics = None
        self._metric_labels = {}

    def bind_metrics(self, registry, **labels) -> None:
        """Opt this scheduler into publishing repro_scheduler_* metrics
        (admissions by traffic class, queue depth) into a repro.obs
        MetricsRegistry.  `labels` (e.g. modality=...) tag every sample."""
        self._metrics = registry
        self._metric_labels = {k: str(v) for k, v in labels.items()
                               if v is not None}

    # -- queue ----------------------------------------------------------
    def submit(self, request: DiffusionRequest) -> None:
        self.queue.push(request)

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    # -- lifecycle ------------------------------------------------------
    def admit(self, tick: int) -> List[Tuple[Slot, DiffusionRequest]]:
        """Fill free slots from the queue; respects phase alignment."""
        if tick % self.align != 0:
            return []
        admitted = []
        for slot in self.slots:
            if slot.busy or not self.queue:
                continue
            req = self.queue.pop()
            slot.request = req
            slot.step = 0
            slot.admit_tick = tick
            admitted.append((slot, req))
        if self._metrics is not None:
            reg, lbl = self._metrics, self._metric_labels
            if admitted:
                adm = reg.counter(
                    "repro_scheduler_admitted_total",
                    "Requests admitted into a slot, by traffic class.")
                for _, req in admitted:
                    adm.inc(traffic_class=req.traffic_class,
                            guided=str(req.guided).lower(), **lbl)
            reg.gauge(
                "repro_scheduler_queue_depth",
                "Requests waiting in the admission queue."
            ).set(len(self.queue), **lbl)
        return admitted

    def advance(self) -> None:
        for slot in self.slots:
            if slot.busy:
                slot.step += 1

    def harvest(self) -> List[Tuple[Slot, DiffusionRequest]]:
        """Pop (slot, request) pairs whose budget is exhausted; frees slots."""
        out = []
        for slot in self.slots:
            if slot.done:
                out.append((slot, slot.request))
                slot.request = None
                slot.step = 0
                slot.admit_tick = -1
        return out

    # -- views ----------------------------------------------------------
    @property
    def num_slots(self) -> int:
        return len(self.slots)

    def active_mask(self) -> List[bool]:
        return [s.busy for s in self.slots]

    def steps(self) -> List[int]:
        return [s.step for s in self.slots]

    def any_busy(self) -> bool:
        return any(s.busy for s in self.slots)

    def idle(self) -> bool:
        return not self.any_busy() and not self.queue
