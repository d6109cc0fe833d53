"""DiffusionServingEngine — step-interleaved continuous batching of latent
generation with per-slot cache states; the port of the JAX
`serving/diffusion/engine.py` in its row-compacted mode.

Every tick plans which backbone rows the per-slot policies want (a slot's
cond row iff its policy computes, its uncond row iff it is guided), pads
them to a power-of-two bucket, runs the DiT over that batch, scatters the
outputs back to the slot layout and takes each slot's policy step
(compute / reuse / forecast selected per slot by masks over the slot axis,
on exactly the decision the plan made), then the per-slot DDIM update.  A
tick with no wanted rows runs no backbone at all.  The host-side
SlotScheduler refills finished slots mid-flight and resets the slot's
cache state (reset-on-refill).

The plan.  A policy that decides from the step alone (its
`want_compute(None, step, None)` answers for every step: JAX's probe rule)
is planned on the host from a table, with no device round trip.  Any other
(TeaCache, MagCache, EasyCache, Foresight, LazyDiT) is planned by one
batched pass over all slots on the device (`slot_want_fns`: TeaCache's
signal over the slot batch, then every slot's want and metric), read back
in ONE device-to-host copy a tick.

The state lives on the engine's device; ticks update the latent batch and
the cache state in place where that saves a copy (admission writes one
slot's rows).  One `torch.cuda.synchronize` a tick prices the tick.

Not ported yet (ROADMAP.md §A): the dense `row_compaction=False` mode,
`cfg_policy` (FasterCacheCFG), vector null labels, text prompts, tick
hooks, metrics registries and latent capture; CUDA-graph capture per
bucket comes in a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import (CachePolicy, SlotBatchedPolicy,
                              cache_state_bytes, make_policy, stack_slots)
from repro_torch.device import DeviceLike, resolve_device, tree_device
from repro_torch.diffusion.pipeline import (slot_compact_denoise_fns,
                                            slot_want_fns)
from repro_torch.diffusion.schedules import NoiseSchedule, linear_schedule
from repro_torch.obs.clock import monotonic

from .scheduler import DiffusionRequest, SlotScheduler
from .telemetry import RequestRecord, ServingTelemetry

NoiseFn = Callable[[DiffusionRequest], torch.Tensor]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet; "
                               f"see ROADMAP.md §A")


def compact_rows(want_c: np.ndarray, want_u: np.ndarray, slots: int):
    """Plan one row-compacted tick from the per-slot want masks.

    Returns (bucket, row_slot, row_uncond, row_dest): the wanted cond rows
    first, then the wanted uncond rows, padded to the next power-of-two
    bucket (capped at the tick's dense batch — `slots` for cond-only ticks,
    `2*slots` otherwise).  `row_slot[b]` is the source slot of compacted
    row b, `row_uncond[b]` selects the null label, and `row_dest[b]` is the
    scatter target in the (2*slots + 1)-row buffer: cond row of slot i -> i,
    uncond row -> slots+i, padding -> the 2*slots dump row.  bucket == 0
    means a pure skip tick."""
    c_rows = np.nonzero(want_c)[0].astype(np.int32)
    u_rows = np.nonzero(want_u)[0].astype(np.int32)
    n = len(c_rows) + len(u_rows)
    if n == 0:
        z = np.zeros((0,), np.int32)
        return 0, z, np.zeros((0,), bool), z
    cap = 2 * slots if len(u_rows) else slots
    bucket = min(1 << (int(n) - 1).bit_length(), cap)
    row_slot = np.zeros((bucket,), np.int32)
    row_uncond = np.zeros((bucket,), bool)
    row_dest = np.full((bucket,), 2 * slots, np.int32)
    row_slot[:len(c_rows)] = c_rows
    row_dest[:len(c_rows)] = c_rows
    row_slot[len(c_rows):n] = u_rows
    row_uncond[len(c_rows):n] = True
    row_dest[len(c_rows):n] = u_rows + slots
    return bucket, row_slot, row_uncond, row_dest


@dataclass
class DiffusionResult:
    """One served request: final latent sample + its telemetry record."""
    request_id: int
    x0: np.ndarray
    record: RequestRecord


class ServeSession:
    """One in-flight batch of requests, advanced one tick at a time."""

    def __init__(self, engine: "DiffusionServingEngine",
                 requests: Sequence[DiffusionRequest],
                 telemetry: Optional[ServingTelemetry] = None):
        for r in requests:
            engine._check_request(r)
        if engine._session_active:
            raise RuntimeError(
                "engine already has a session in flight; finish() it first")
        engine._session_active = True
        self.engine = engine
        self.requests = list(requests)
        self.tele = telemetry if telemetry is not None else ServingTelemetry()
        self.tele.cache_state_bytes_per_slot = cache_state_bytes(engine._fresh)
        self.tele.start()
        self.sched = SlotScheduler(engine.slots, engine.align)
        self.recs: Dict[int, RequestRecord] = {
            r.request_id: RequestRecord(r.request_id, r.num_steps,
                                        r.traffic_class,
                                        cfg_scale=r.cfg_scale,
                                        modality=r.modality,
                                        enqueue_time=monotonic())
            for r in requests}
        self.sched.submit_all(requests)
        self.xs = torch.zeros((engine.slots, engine.tokens, engine.in_dim),
                              dtype=torch.float32, device=engine.device)
        self.states = stack_slots(engine._fresh, engine.slots)
        self.results: Dict[int, DiffusionResult] = {}
        self.ticks = 0
        self._finished = False

    @property
    def done(self) -> bool:
        return self.sched.idle()

    def tick(self) -> None:
        """One engine tick: refill free slots, plan the wanted rows,
        dispatch the matching backbone bucket, advance and harvest."""
        if self._finished:
            raise RuntimeError("session already finished")
        eng, sched, tele = self.engine, self.sched, self.tele

        for slot, req in sched.admit(self.ticks):
            self.xs[slot.index] = eng._initial_noise(req)
            SlotBatchedPolicy.reset_slot(self.states, slot.index, eng._fresh)
            eng._install_request(slot.index, req)
            rec = self.recs[req.request_id]
            rec.admit_time = monotonic()
            rec.admit_tick = self.ticks
            rec.slot = slot.index

        active = np.asarray(sched.active_mask())
        steps = np.asarray(sched.steps(), np.int32)
        idx = np.minimum(steps, eng.max_steps - 1)
        rows = np.arange(eng.slots)
        tvals = eng._tv[rows, idx]
        ab_t = eng._ab[rows, idx]
        ab_n = eng._ab[rows, idx + 1]

        plan_c, want_u, _, signal = eng._plan_all(self.states, idx, self.xs,
                                                  tvals)
        want_c = plan_c & active
        want_u = want_u & active
        n_c, n_u = int(want_c.sum()), int(want_u.sum())
        kind = "full" if n_u else ("cond" if n_c else "skip")
        dense_rows = {"full": 2 * eng.slots, "cond": eng.slots,
                      "skip": 0}[kind]
        bucket, row_slot, row_uncond, row_dest = compact_rows(
            want_c, want_u, eng.slots)
        t0 = monotonic()
        self.xs, self.states = eng._tick(self.states, idx, self.xs, tvals,
                                         ab_t, ab_n, row_slot, row_uncond,
                                         row_dest, plan_c, signal)
        eng._sync()
        tick_s = monotonic() - t0
        tele.record_tick(kind, tick_s, rows_computed=n_c + n_u,
                         rows_padding=bucket - n_c - n_u,
                         rows_saved=dense_rows - n_c - n_u)
        tele.uncond_rows_computed += n_u
        tele.uncond_rows_saved += int((active & eng._guided & ~want_u).sum())

        for slot in sched.slots:
            if slot.busy and want_c[slot.index]:
                self.recs[slot.request.request_id].computed_steps += 1
            if slot.busy and want_u[slot.index]:
                self.recs[slot.request.request_id].uncond_computed_steps += 1

        sched.advance()
        for slot, req in sched.harvest():
            rec = self.recs[req.request_id]
            rec.finish_time = monotonic()
            rec.finish_tick = self.ticks + 1
            tele.finish_request(rec)
            self.results[req.request_id] = DiffusionResult(
                req.request_id,
                self.xs[slot.index].to("cpu", copy=True).numpy(), rec)
        self.ticks += 1

    def finish(self) -> List[DiffusionResult]:
        """Close the session: preempted accounting, telemetry stop, results
        in request order.  Idempotent."""
        if not self._finished:
            for r in self.requests:
                if r.request_id not in self.results:
                    self.tele.preempt_request(self.recs[r.request_id])
            self.tele.stop()
            self.engine.telemetry = self.tele
            self.engine._session_active = False
            self._finished = True
        return [self.results[r.request_id] for r in self.requests
                if r.request_id in self.results]


class DiffusionServingEngine:
    """Fixed-slot continuous-batching server over one DiT backbone.

    `noise_fn(request) -> (tokens, in_dim)` tensor supplies each request's
    initial latent; the default draws it from a torch.Generator seeded from
    (request.seed, request.request_id), so requests left at the default
    seed still get distinct noise.  Runs on the GPU unless the caller
    passes device="cpu"; params must live on that device."""

    def __init__(self, params, cfg, policy: Union[CachePolicy, str, None] = None,
                 *, slots: int = 8, max_steps: int = 64,
                 noise_schedule: Optional[NoiseSchedule] = None,
                 align: Optional[int] = None,
                 cfg_policy: Union[CachePolicy, str, None] = None,
                 row_compaction: bool = True, conditioner=None,
                 noise_fn: Optional[NoiseFn] = None,
                 device: DeviceLike = None):
        if cfg_policy is not None:
            raise _not_ported("cfg_policy (FasterCacheCFG)")
        if not row_compaction:
            raise _not_ported("the dense row_compaction=False engine")
        if conditioner is not None:
            raise _not_ported("text conditioning (conditioner)")
        self.device = resolve_device(device)
        if tree_device(params) != self.device:
            raise ValueError(f"params live on {tree_device(params)}, the "
                             f"engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.slots = slots
        self.max_steps = max_steps
        self.row_compaction = True
        self.sched = noise_schedule or linear_schedule(1000)
        if isinstance(policy, str):
            policy = make_policy(policy, num_steps=max_steps)
        self.policy = policy if policy is not None else make_policy("none")
        self.cfg_policy = None
        self.align = (align if align is not None
                      else max(int(getattr(self.policy, "interval", 1)), 1))
        self.tokens, self.in_dim = cfg.dit_tokens, cfg.dit_in_dim
        self.batched = SlotBatchedPolicy(self.policy, slots)
        self._compact_backbone, self._apply = slot_compact_denoise_fns(
            params, cfg, self.policy)
        self._want_all = slot_want_fns(params, cfg, self.policy)
        self._fresh = {
            "policy": self.batched.init_slot_state(
                (self.tokens, self.in_dim),
                signal_shape=(self.tokens, cfg.d_model), device=self.device),
            "cfg": {},
        }
        # host plan table when the policy decides from the step alone,
        # else None: the device want pass plans every tick
        self._static_plan = self._probe_static_plan(self.policy)
        self._noise_fn = noise_fn
        # host-side per-slot tables, padded to max_steps (+1 for the
        # terminal alpha-bar = 1.0 that closes the DDIM update)
        self._ab = np.ones((slots, max_steps + 1), np.float32)
        self._tv = np.zeros((slots, max_steps), np.float32)
        self._labels = np.zeros((slots,), np.int32)
        self._nulls = np.full((slots,), cfg.dit_num_classes, np.int32)
        self._scales = np.zeros((slots,), np.float32)
        self._nsteps = np.ones((slots,), np.int32)
        self._guided = np.zeros((slots,), bool)
        #: ServingTelemetry of the most recent serve() call
        self.telemetry: Optional[ServingTelemetry] = None
        self._session_active = False

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _initial_noise(self, req: DiffusionRequest) -> torch.Tensor:
        shape = (self.tokens, self.in_dim)
        if self._noise_fn is not None:
            noise = torch.as_tensor(self._noise_fn(req))
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise_fn gave {tuple(noise.shape)} for "
                                 f"request {req.request_id}, want {shape}")
            return noise.to(device=self.device, dtype=torch.float32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(req.seed) * 2**32 + int(req.request_id)) % 2**63)
        return torch.randn(shape, generator=gen, device=self.device)

    def _tick(self, states, steps, xs, tvals, ab_t, ab_n, row_slot,
              row_uncond, row_dest, want, signal):
        """One tick on the device: the bucket's backbone rows (none on a
        skip tick), the per-slot policy step on the plan's `want` and
        `signal`, and the per-slot DDIM update."""
        dev = self.device
        if len(row_slot) == 0:
            y_c = y_u = torch.zeros_like(xs)
        else:
            y_c, y_u = self._compact_backbone(
                xs, torch.as_tensor(tvals, device=dev),
                torch.as_tensor(self._labels, device=dev).long(),
                torch.as_tensor(self._nulls, device=dev).long(),
                torch.as_tensor(row_slot, device=dev).long(),
                torch.as_tensor(row_uncond, device=dev),
                torch.as_tensor(row_dest, device=dev).long())
        eps, states = self._apply(states, steps, xs,
                                  torch.as_tensor(self._scales, device=dev),
                                  y_c, y_u, want, signal)
        a_t = torch.as_tensor(ab_t, device=dev)[:, None, None]
        a_n = torch.as_tensor(ab_n, device=dev)[:, None, None]
        x0_hat = (xs - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_n) * x0_hat + torch.sqrt(1.0 - a_n) * eps, states

    def _warmup_buckets(self) -> List[int]:
        """Every bucket a tick can request, mirroring compact_rows."""
        S = self.slots
        return sorted(
            {0}
            | {min(1 << (n - 1).bit_length(), S) for n in range(1, S + 1)}
            | {min(1 << (n - 1).bit_length(), 2 * S)
               for n in range(1, 2 * S + 1)})

    def warmup(self) -> List[int]:
        """Run the plan and every bucket's tick once on dummy operands
        (this builds the CUDA kernels on first use and touches every batch
        shape), so the first live ticks pay no set-up.  Returns the buckets
        run."""
        S = self.slots
        xs = torch.zeros((S, self.tokens, self.in_dim), device=self.device)
        states = stack_slots(self._fresh, S)
        steps = np.ones((S,), np.int32)   # forecast branch for interval > 1
        zf = np.zeros((S,), np.float32)
        ab = np.full((S,), 0.5, np.float32)
        want, _, _, signal = self._plan_all(states, steps, xs, zf)
        buckets = self._warmup_buckets()
        for bucket in buckets:
            row_slot = np.zeros((bucket,), np.int32)
            row_uncond = np.zeros((bucket,), bool)
            row_dest = np.full((bucket,), 2 * S, np.int32)
            self._tick(states, steps, xs, zf, ab, ab, row_slot, row_uncond,
                       row_dest, want, signal)
        self._sync()
        return buckets

    # ------------------------------------------------------------------
    def _check_request(self, req: DiffusionRequest) -> None:
        if req.num_steps > self.max_steps:
            raise ValueError(f"request {req.request_id}: num_steps="
                             f"{req.num_steps} > max_steps={self.max_steps}")
        if req.null_label is not None and np.ndim(req.null_label) > 0:
            raise _not_ported("a vector null_label (negative prompt)")
        if req.prompt_tokens is not None or req.neg_prompt_tokens is not None:
            raise _not_ported("text prompts")

    def _install_request(self, slot: int, req: DiffusionRequest) -> None:
        self._check_request(req)
        ts = self.sched.spaced(req.num_steps)
        self._ab[slot, :] = 1.0
        self._ab[slot, :req.num_steps] = self.sched.alpha_bars[ts]
        self._tv[slot, :] = 0.0
        self._tv[slot, :req.num_steps] = ts.astype(np.float32)
        self._labels[slot] = req.class_label
        self._nulls[slot] = (self.cfg.dit_num_classes if req.null_label is None
                             else int(req.null_label))
        self._scales[slot] = req.cfg_scale
        self._nsteps[slot] = req.num_steps
        self._guided[slot] = req.guided

    def _probe_static_plan(self, policy: CachePolicy) -> Optional[np.ndarray]:
        """want_compute(None, s, None) for every step, or None when the
        policy needs its state (or x) to decide (JAX's probe rule)."""
        try:
            return np.asarray([bool(policy.want_compute(None, s, None))
                               for s in range(self.max_steps)], bool)
        except (AttributeError, TypeError):
            return None

    def _plan_all(self, states, steps, xs, tvals):
        """Per-slot (want_cond, want_uncond, metric, signal) before active
        masking; the uncond mask is the guided flag (naive two-branch CFG).
        A step-only policy is planned from the host table: no device round
        trip, metric None.  Any other runs the fused device pass, ONE
        device-to-host copy; its signal stays on the device for the tick."""
        if self._static_plan is not None:
            return (self._static_plan[steps], self._guided.copy(), None, None)
        plan = self._want_all(states, steps, xs, tvals, self._labels,
                              self._guided)
        return plan.want_cond, plan.want_uncond, plan.metric, plan.signal

    # ------------------------------------------------------------------
    def start_session(self, requests: Sequence[DiffusionRequest],
                      telemetry: Optional[ServingTelemetry] = None
                      ) -> ServeSession:
        return ServeSession(self, requests, telemetry)

    def serve(self, requests: Sequence[DiffusionRequest],
              telemetry: Optional[ServingTelemetry] = None,
              max_ticks: Optional[int] = None) -> List[DiffusionResult]:
        """Run every request through the slot pool; results in request
        order.  With max_ticks, unfinished requests are recorded as
        preempted in telemetry."""
        session = self.start_session(requests, telemetry)
        try:
            while not session.done:
                session.tick()
                if max_ticks is not None and session.ticks >= max_ticks:
                    break
        finally:
            session.finish()
        return session.finish()
