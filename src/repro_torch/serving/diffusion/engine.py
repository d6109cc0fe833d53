"""DiffusionServingEngine — step-interleaved continuous batching of latent
generation with per-slot cache states, including classifier-free guidance
with per-slot CFG-branch reuse (FasterCacheCFG, survey §III-C); the port of
the JAX `serving/diffusion/engine.py`.

Every tick plans which backbone rows the per-slot policies want (a slot's
cond row iff its policy computes, its uncond row iff it is guided and its
CFG policy wants an uncond refresh), pads them to a power-of-two bucket,
runs the DiT over that batch, scatters the outputs back to the slot layout
and takes each slot's policy steps (compute / reuse / forecast selected per
slot by masks over the slot axis, on exactly the decisions the plan made),
then the per-slot DDIM update.  A tick with no wanted rows runs no backbone
at all.  `row_compaction=False` is the dense engine instead: each tick runs
one of three whole-pool kinds (full over 2S rows, cond over S rows, skip),
kept as the equivalence baseline.

A request's `null_label` may be a (d_model,) conditioning VECTOR (a
negative prompt) in place of a class id: the engine threads it through the
slot's uncond rows as an embedding override.  The per-slot vector table
lives on the device and is uploaded once per admission wave.

The plan.  A policy that decides from the step alone (its
`want_compute(None, step, None)` answers for every step: JAX's probe rule)
is planned on the host from a table, with no device round trip; so is the
CFG policy.  When either is not (TeaCache, MagCache, EasyCache, Foresight,
LazyDiT), one batched pass over all slots on the device (`slot_want_fns`)
decides, read back in ONE device-to-host copy a tick; a branch that is
step-only keeps its host table.

The host-side SlotScheduler refills finished slots mid-flight and resets
the slot's combined cache state — main policy and CFG branch — to fresh
(reset-on-refill).  The state lives on the engine's device; ticks update
the latent batch and the cache state in place where that saves a copy.  One
`torch.cuda.synchronize` a tick prices the tick.  Sessions take observer
hooks (`TickEvent`), an opt-in metrics registry (`repro_torch.obs`) and
mid-session submission.

The engine serves every modality: pool rows are (cfg.dit_tokens,
cfg.dit_in_dim), frames x patches for the video DiT.  A text-enabled config
(dit-t2i, dit-t2v) takes a `conditioner` (a repro_torch.conditioning
PromptCache) that resolves `DiffusionRequest.prompt_tokens` and
`neg_prompt_tokens` at admission.  The slots' prompt and negative-prompt
embeddings sit in host tables; each admission wave copies them to the
device in one host-to-device copy and projects every layer's cross-
attention K/V for all slots at once (`_build_text_tables`), so no tick
projects text.  A negative prompt's pooled embedding rides the
null-vector path.

Programs.  Every program of the engine reads and writes static buffers
that live outside any graph pool: the latents and cache states, the text
tables, the plan's packed decisions and signal, and `StaticInputs` for the
tick's host values (per-slot timesteps, alpha-bars, progress weights,
steps, the plan's masks and a bucket's gather rows, refilled before each
tick; labels, nulls, scales and negative-prompt vectors, refilled per
admission wave).  `warmup()` compiles each program once
(`repro_torch.obs.profiling.compile_program`): on the card a CUDA graph on
the engine's one memory pool, the counterpart of JAX's AOT compile per
bucket; on the CPU nothing is captured and the same function runs.  The
programs: every tick bucket (or the dense engine's three kinds), "want"
(the device half of the plan: its one host read stays outside the graph,
inside the plan), "text_kv" and the conditioner's encoder.  An engine that
was never warmed runs every program eagerly (JAX compiles lazily there).

A graph's key is the bucket (or kind) AND the host branches its policies
took: `want.any()` / `want.all()` of the plan's cond and uncond masks and,
for ToCa, `(steps % interval == 0).any()` / `.all()`.  A policy asks
through `repro_torch.device.Staged`, which records each answer; a graph
replays only where every recorded answer holds again, and warmup captures,
per bucket, a graph for each class of inputs (none / some / all of each
mask, steps all on / none on / some on the interval) that no earlier graph
covers.  Keys per policy, for each bucket: fora, delta_dit, pab,
blockcache, clusca, the predictive family (taylorseer, newtonseer,
hicache, abcache, foca, freqca, speca) and the gated ones (teacache,
magcache, easycache, foresight, lazydit, teacache_video) the none / some
/ all class of want_c the bucket allows; FasterCacheCFG adds that of
want_u; naive guidance (no cfg_policy) and none add nothing; ToCa keys on
its steps class alone.  A tick whose branches no graph covers runs
eagerly and `_note_program` reports it.

Verification.  `warmup(verify=True)` also runs each program once under the
program verifier (`repro_torch.analysis.ir`): tick and text programs make
no host sync, the device plan exactly its one priced read, none a float64
tensor; findings land on `engine.ir_findings` and the programs' profiles.
Every program a session runs is checked against the keys warmup ran, so a
`RetraceSentinel` sees a program that first runs inside a live tick.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import (CachePolicy, SlotBatchedPolicy,
                              cache_state_bytes, make_policy, stack_slots,
                              static_plan)
from repro_torch.device import (DeviceLike, StaticInputs, branch_log,
                                guards_hold, resolve_device, to_device,
                                tree_copy_, tree_device)
from repro_torch.diffusion.pipeline import (slot_compact_denoise_fns,
                                            slot_want_fns)
from repro_torch.diffusion.schedules import NoiseSchedule, linear_schedule
from repro_torch.models import dit
from repro_torch.obs import watch
from repro_torch.obs.clock import monotonic
from repro_torch.obs.profiling import (ProgramProfile, capture_ir,
                                       compile_program)
from repro_torch.tree import tree_leaves

from .scheduler import DiffusionRequest, SlotScheduler
from .telemetry import RequestRecord, ServingTelemetry

NoiseFn = Callable[[DiffusionRequest], torch.Tensor]


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


@dataclass
class TickEvent:
    """Everything one engine tick decided and produced, for observer hooks.

    All arrays are host-side copies indexed by slot; slots not active this
    tick carry request_id -1.  `metric` is the per-slot `want_metric` the
    device plan read back, None when the tick was planned from host tables.
    `plan_seconds` is the host time spent deciding the tick (the fused want
    pass and its read for state-dependent policies, a table lookup
    otherwise).  `latents` is the pre-tick (slots, tokens, in_dim) latent
    batch, filled only when the session captures latents (one
    device-to-host copy a tick)."""
    tick: int
    modality: str
    kind: str                       # "full" | "cond" | "skip"
    seconds: float                  # wall time of this tick's device work
    rows_computed: int
    rows_padding: int
    active: np.ndarray              # (S,) bool
    request_ids: np.ndarray         # (S,) int64, -1 = free slot
    steps: np.ndarray               # (S,) int32 per-slot step index
    tvals: np.ndarray               # (S,) float32 model-facing timesteps
    labels: np.ndarray              # (S,) int32 class conditioning
    guided: np.ndarray              # (S,) bool
    want_cond: np.ndarray           # (S,) bool, after active masking
    want_uncond: np.ndarray         # (S,) bool, after active masking
    plan_seconds: float = 0.0
    metric: Optional[np.ndarray] = None     # (S,) float32 or None
    latents: Optional[np.ndarray] = None    # (S, T, D) pre-tick, opt-in
    admitted: List[DiffusionRequest] = field(default_factory=list)
    finished: List[RequestRecord] = field(default_factory=list)


#: observer hook signature: called once per tick, must not mutate the engine
TickHook = Callable[[TickEvent], None]


class ServeSession:
    """One in-flight batch of requests, advanced one tick at a time.

    `hooks` observe every tick (TickEvent); `capture_latents` copies the
    pre-tick latents into each event; `modality` labels the events and
    metrics (default: the first request's); `metrics` (a
    `repro_torch.obs.MetricsRegistry`) opts into the repro_engine_* and
    repro_scheduler_* instruments, under JAX's names."""

    def __init__(self, engine: "DiffusionServingEngine",
                 requests: Sequence[DiffusionRequest],
                 telemetry: Optional[ServingTelemetry] = None,
                 hooks: Optional[Sequence[TickHook]] = None,
                 capture_latents: bool = False,
                 modality: Optional[str] = None, metrics=None):
        for r in requests:
            self._validate(engine, r)
        if engine._session_active:
            raise RuntimeError(
                "engine already has a session in flight; finish() it first")
        engine._session_active = True
        self.engine = engine
        self.requests = list(requests)
        self.hooks: List[TickHook] = list(hooks or ())
        self.capture_latents = bool(capture_latents)
        self.modality = (modality if modality is not None
                         else (requests[0].modality if requests else "image"))
        self.tele = telemetry if telemetry is not None else ServingTelemetry()
        self.tele.cache_state_bytes_per_slot = cache_state_bytes(engine._fresh)
        self.tele.start()
        self.metrics = metrics
        self.sched = SlotScheduler(engine.slots, engine.align)
        if metrics is not None:
            self.sched.bind_metrics(metrics, modality=self.modality)
        self.recs: Dict[int, RequestRecord] = {
            r.request_id: self._record(r) for r in requests}
        self.sched.submit_all(requests)
        # the engine's static latents, cache states and (all-masked until
        # the first admission wave builds them; {} on a text-free engine)
        # per-slot text K/V tables, reset in place: the captured programs
        # read these buffers
        engine._reset_static()
        self.xs, self.states = engine._xs, engine._states
        self.results: Dict[int, DiffusionResult] = {}
        self.ticks = 0
        self._finished = False

    @staticmethod
    def _validate(engine: "DiffusionServingEngine",
                  r: DiffusionRequest) -> None:
        """Reject a malformed request before any work runs (the admission
        contract, `engine._check_request`)."""
        engine._check_request(r)

    @staticmethod
    def _record(r: DiffusionRequest) -> RequestRecord:
        return RequestRecord(r.request_id, r.num_steps, r.traffic_class,
                             cfg_scale=r.cfg_scale, modality=r.modality,
                             enqueue_time=monotonic())

    @property
    def done(self) -> bool:
        return self.sched.idle()

    def submit(self, request: DiffusionRequest) -> None:
        """Enqueue one more request on a live session; it is admitted at
        the next phase-aligned tick with a free slot."""
        if self._finished:
            raise RuntimeError("session already finished; submit to a new "
                               "session instead")
        if request.request_id in self.recs:
            raise ValueError(f"request id {request.request_id} already "
                             f"submitted to this session")
        self._validate(self.engine, request)
        self.requests.append(request)
        self.recs[request.request_id] = self._record(request)
        self.sched.submit(request)

    def transfer_queued(self) -> List[DiffusionRequest]:
        """Pop every request still waiting for a slot and drop its
        bookkeeping here, so the caller can submit it to another session."""
        moved = self.sched.queue.pop_many(len(self.sched.queue))
        for r in moved:
            del self.recs[r.request_id]
            self.requests.remove(r)
        return moved

    def tick(self) -> None:
        """One engine tick: refill free slots, plan the wanted rows,
        dispatch the matching backbone batch, advance and harvest."""
        if self._finished:
            raise RuntimeError("session already finished")
        eng, sched, tele = self.engine, self.sched, self.tele

        admitted = sched.admit(self.ticks)
        for slot, req in admitted:
            self.xs[slot.index] = eng._initial_noise(req)
            SlotBatchedPolicy.reset_slot(self.states, slot.index, eng._fresh)
            eng._install_request(slot.index, req)
            rec = self.recs[req.request_id]
            rec.admit_time = monotonic()
            rec.admit_tick = self.ticks
            rec.slot = slot.index
        if admitted:
            eng._upload_tables()
            if eng.text_enabled:
                # one projection of every slot's text K/V per admission wave
                eng._build_text_tables()
                eng.text_table_builds += 1

        active = np.asarray(sched.active_mask())
        steps = np.asarray(sched.steps(), np.int32)
        idx = np.minimum(steps, eng.max_steps - 1)
        rows = np.arange(eng.slots)
        tvals = eng._tv[rows, idx]
        ab_t = eng._ab[rows, idx]
        ab_n = eng._ab[rows, idx + 1]
        # per-slot trajectory progress for FasterCacheCFG's blend
        cfg_ws = idx.astype(np.float32) / np.maximum(eng._nsteps - 1, 1)
        rids = np.asarray([s.request.request_id if s.busy else -1
                           for s in sched.slots], np.int64)
        latents = (self.xs.to("cpu", copy=True).numpy()
                   if self.capture_latents else None)

        t_plan = monotonic()
        plan_c, plan_u, metric, signal = eng._plan_all(self.states, idx,
                                                       self.xs, tvals)
        plan_s = monotonic() - t_plan
        want_c = plan_c & active
        want_u = plan_u & active
        n_c, n_u = int(want_c.sum()), int(want_u.sum())
        kind = "full" if n_u else ("cond" if n_c else "skip")
        dense_rows = {"full": 2 * eng.slots, "cond": eng.slots,
                      "skip": 0}[kind]
        if eng.row_compaction:
            bucket, *gather = compact_rows(want_c, want_u, eng.slots)
            rows_done, rows_pad = n_c + n_u, bucket - n_c - n_u
        else:
            bucket, gather, rows_done, rows_pad = None, None, dense_rows, 0
        t0 = monotonic()
        eng._run_tick(kind, bucket, gather, idx, tvals, cfg_ws, ab_t, ab_n,
                      plan_c, plan_u)
        eng._sync()
        tick_s = monotonic() - t0
        if eng.row_compaction:
            tele.record_tick(kind, tick_s, rows_computed=rows_done,
                             rows_padding=rows_pad,
                             rows_saved=dense_rows - rows_done)
        else:
            tele.record_tick(kind, tick_s, rows_computed=dense_rows)
        tele.uncond_rows_computed += n_u
        tele.uncond_rows_saved += int((active & eng._guided & ~want_u).sum())

        for slot in sched.slots:
            if slot.busy and want_c[slot.index]:
                self.recs[slot.request.request_id].computed_steps += 1
            if slot.busy and want_u[slot.index]:
                self.recs[slot.request.request_id].uncond_computed_steps += 1

        sched.advance()
        finished: List[RequestRecord] = []
        for slot, req in sched.harvest():
            rec = self.recs[req.request_id]
            rec.finish_time = monotonic()
            rec.finish_tick = self.ticks + 1
            tele.finish_request(rec)
            finished.append(rec)
            self.results[req.request_id] = DiffusionResult(
                req.request_id,
                self.xs[slot.index].to("cpu", copy=True).numpy(), rec)

        if self.metrics is not None:
            self._publish_tick(kind, tick_s, plan_s, rows_done, rows_pad,
                               dense_rows - rows_done
                               if eng.row_compaction else 0,
                               n_u, int(active.sum()), len(finished))
        if self.hooks:
            event = TickEvent(
                tick=self.ticks, modality=self.modality, kind=kind,
                seconds=tick_s, plan_seconds=plan_s, rows_computed=rows_done,
                rows_padding=rows_pad, active=active, request_ids=rids,
                steps=steps, tvals=np.asarray(tvals, np.float32),
                labels=eng._labels.copy(), guided=eng._guided.copy(),
                want_cond=want_c, want_uncond=want_u, metric=metric,
                latents=latents, admitted=[req for _, req in admitted],
                finished=finished)
            for hook in self.hooks:
                hook(event)
        self.ticks += 1

    def _publish_tick(self, kind: str, tick_s: float, plan_s: float,
                      rows_done: int, rows_pad: int, rows_saved: int,
                      n_u: int, occupancy: int, finished: int) -> None:
        """One tick's registry updates (names follow JAX's
        repro_<subsystem>_<metric>_<unit>; labels carry dimensions)."""
        m, mod = self.metrics, self.modality
        m.counter("repro_engine_ticks_total",
                  "engine ticks by program kind").inc(
            kind=kind, modality=mod)
        m.counter("repro_engine_tick_seconds_total",
                  "device seconds of dispatched tick programs").inc(
            tick_s, kind=kind, modality=mod)
        m.counter("repro_engine_plan_seconds_total",
                  "host seconds spent deciding ticks (want pass)").inc(
            plan_s, modality=mod)
        m.counter("repro_engine_rows_computed_total",
                  "backbone rows carrying real per-slot work").inc(
            rows_done, modality=mod)
        m.counter("repro_engine_rows_padding_total",
                  "pow-2 bucket padding rows dispatched").inc(
            rows_pad, modality=mod)
        m.counter("repro_engine_rows_saved_total",
                  "rows a dense whole-pool tick would have added").inc(
            rows_saved, modality=mod)
        m.counter("repro_engine_uncond_rows_computed_total",
                  "uncond rows refreshing a CFG cache").inc(
            n_u, modality=mod)
        m.counter("repro_engine_requests_finished_total",
                  "requests completed").inc(finished, modality=mod)
        m.gauge("repro_engine_occupancy_slots",
                "busy slots at the latest tick").set(occupancy, modality=mod)
        m.histogram("repro_engine_tick_seconds",
                    "device tick time distribution").observe(
            tick_s, modality=mod)

    def finish(self) -> List[DiffusionResult]:
        """Close the session: preempted accounting, telemetry stop, results
        in request order.  Idempotent."""
        if not self._finished:
            for r in self.requests:
                if r.request_id not in self.results:
                    self.tele.preempt_request(self.recs[r.request_id])
                    if self.metrics is not None:
                        self.metrics.counter(
                            "repro_engine_requests_preempted_total",
                            "requests cut off before completion").inc(
                            modality=self.modality)
            self.tele.stop()
            self.engine.telemetry = self.tele
            self.engine._session_active = False
            self._finished = True
        return [self.results[r.request_id] for r in self.requests
                if r.request_id in self.results]


class DiffusionServingEngine:
    """Fixed-slot continuous-batching server over one DiT backbone.

    `policy` and `cfg_policy` (the uncond-branch gate of guided requests;
    None: naive two-branch guidance) are instances or registry names, a
    name built with num_steps=max_steps and, for a video config, the
    config's frame count (teacache_video groups its signal by it).
    Admission is phase-aligned to the lcm of the two intervals unless
    `align` is given.  `noise_fn(request)
    -> (tokens, in_dim)` tensor supplies each request's initial latent; the
    default draws it from a torch.Generator seeded from (request.seed,
    request.request_id), so requests left at the default seed still get
    distinct noise.  Runs on the GPU unless the caller passes device="cpu";
    params must live on that device."""

    def __init__(self, params, cfg, policy: Union[CachePolicy, str, None] = None,
                 *, slots: int = 8, max_steps: int = 64,
                 noise_schedule: Optional[NoiseSchedule] = None,
                 align: Optional[int] = None,
                 cfg_policy: Union[CachePolicy, str, None] = None,
                 row_compaction: bool = True, conditioner=None,
                 noise_fn: Optional[NoiseFn] = None,
                 device: DeviceLike = None):
        # text conditioning (T2I/T2V): a PromptCache resolving the requests'
        # prompts at admission; needs a text-enabled config
        self.text_enabled = cfg.dit_text_len > 0
        if conditioner is not None and not self.text_enabled:
            raise ValueError(f"conditioner given but config '{cfg.name}' is "
                             f"not text-enabled (dit_text_len == 0)")
        self.conditioner = conditioner
        self.device = resolve_device(device)
        if tree_device(params) != self.device:
            raise ValueError(f"params live on {tree_device(params)}, the "
                             f"engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.slots = slots
        self.max_steps = max_steps
        self.row_compaction = bool(row_compaction)
        self.sched = noise_schedule or linear_schedule(1000)
        policy_kw = {"num_steps": max_steps}
        if cfg.dit_num_frames > 0:
            policy_kw["frames"] = cfg.dit_num_frames
        if isinstance(policy, str):
            policy = make_policy(policy, **policy_kw)
        self.policy = policy if policy is not None else make_policy("none")
        if isinstance(cfg_policy, str):
            cfg_policy = make_policy(cfg_policy, **policy_kw)
        self.cfg_policy = cfg_policy
        if align is not None:
            self.align = align
        else:
            a = max(int(getattr(self.policy, "interval", 1)), 1)
            b = max(int(getattr(cfg_policy, "interval", 1)), 1)
            self.align = a * b // math.gcd(a, b)
        self.tokens, self.in_dim = cfg.dit_tokens, cfg.dit_in_dim
        self.batched = SlotBatchedPolicy(self.policy, slots)
        (self._compact_backbone, self._backbone2, self._backbone,
         self._apply) = slot_compact_denoise_fns(params, cfg, self.policy,
                                                 cfg_policy)
        self._want = slot_want_fns(params, cfg, self.policy, cfg_policy)
        feat = (self.tokens, self.in_dim)
        self._fresh = {
            "policy": self.batched.init_slot_state(
                feat, signal_shape=(self.tokens, cfg.d_model),
                device=self.device),
            "cfg": (cfg_policy.init_state(feat, device=self.device)
                    if cfg_policy is not None else {}),
        }
        # host plan tables of the branches that decide from the step alone,
        # else None: the device want pass plans every tick (the uncond
        # branch is all True in naive two-branch guidance)
        self._static_plan = self._probe_static_plan(self.policy)
        self._static_cfg_plan = (self._probe_static_plan(cfg_policy)
                                 if cfg_policy is not None
                                 else np.ones((max_steps,), bool))
        self._noise_fn = noise_fn
        # host-side per-slot tables, padded to max_steps (+1 for the
        # terminal alpha-bar = 1.0 that closes the DDIM update)
        self._ab = np.ones((slots, max_steps + 1), np.float32)
        self._tv = np.zeros((slots, max_steps), np.float32)
        self._labels = np.zeros((slots,), np.int32)
        self._nulls = np.full((slots,), cfg.dit_num_classes, np.int32)
        # negative-prompt conditioning vectors (per slot) and their mask
        self._null_vecs = np.zeros((slots, cfg.d_model), np.float32)
        self._null_mask = np.zeros((slots,), bool)
        # the slots' prompt (rows [0, S)) and negative-prompt (rows [S, 2S))
        # embeddings, each row's mask packed as a last 0/1 column so one
        # host-to-device copy carries both (zero-size without text)
        self._txt_host = np.zeros(
            (2 * slots, cfg.dit_text_len, cfg.d_model + 1), np.float32)
        #: text K/V table projections by serving sessions (one per
        #: admission wave; warmup's is not counted)
        self.text_table_builds = 0
        self._scales = np.zeros((slots,), np.float32)
        self._nsteps = np.ones((slots,), np.int32)
        self._guided = np.zeros((slots,), bool)
        #: ServingTelemetry of the most recent serve() call
        self.telemetry: Optional[ServingTelemetry] = None
        #: per-program first-run seconds and FLOPs, filled by warmup():
        #: keyed by bucket (compacted) or tick kind (dense), plus "want"
        #: for the device plan pass
        self.program_profile: Dict[object, ProgramProfile] = {}
        #: one OpRecord per program (same keys), from warmup(verify=True)
        #: or `_capture_program_records()`
        self.program_records: Dict[object, object] = {}
        #: findings of the last warmup(verify=True): None = never verified,
        #: [] = verified clean
        self.ir_findings: Optional[List] = None
        self._warm_keys: set = set()
        self._warm_runs: List = []
        self._session_active = False
        self._alloc_static()

    # -- static buffers -------------------------------------------------
    def _alloc_static(self) -> None:
        """The buffers every program reads and writes, outside any graph
        pool: a replay reads nothing another graph allocated, so the
        graphs share one pool and replay in any order."""
        S, cfg, dev = self.slots, self.cfg, self.device
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        self._in = StaticInputs(dev)
        for name, dtype in (("tvals", f32), ("cfg_ws", f32), ("ab_t", f32),
                            ("ab_n", f32), ("scales", f32), ("steps", i32),
                            ("want_c", torch.bool), ("want_u", torch.bool),
                            ("labels", i64), ("nulls", i64),
                            ("null_mask", torch.bool)):
            self._in.alloc(name, (S,), dtype)
        self._in.alloc("null_vecs", (S, cfg.d_model), f32)
        self._xs = torch.zeros((S, self.tokens, self.in_dim), device=dev)
        self._states = stack_slots(self._fresh, S)
        self._plan_buf = torch.zeros((self._want.rows, S), device=dev)
        #: the plan's signal (S, T, d_model), made by the first plan of a
        #: policy that reads one (never inside a capture)
        self._signal: Optional[torch.Tensor] = None
        self._txt: Dict[str, torch.Tensor] = {}
        if self.text_enabled:
            self._in.alloc("txt_host", self._txt_host.shape, f32)
            kv = (2 * S, cfg.num_layers, cfg.dit_text_len,
                  cfg.num_heads * cfg.head_dim)
            self._txt = {"k": torch.zeros(kv, device=dev),
                         "v": torch.zeros(kv, device=dev),
                         "mask": torch.zeros((2 * S, cfg.dit_text_len),
                                             dtype=torch.bool, device=dev)}
        #: compiled programs by key: [(guards, Program, ProgramProfile)]
        self._programs: Dict[object, List] = {}
        #: one ProgramIR per program key from warmup(verify=True)
        self.program_ir: Dict[object, object] = {}
        #: runs of each program key that warmup executed on the device
        #: (each compile's eager run and each recorded run; a capture
        #: executes nothing)
        self.warmup_runs: Dict[object, int] = {}
        self._pool = None

    def _reset_static(self) -> None:
        """A fresh pool in place: zero latents, fresh cache states, the
        per-request tables as the host holds them, all-masked text."""
        self._xs.zero_()
        tree_copy_(self._states, stack_slots(self._fresh, self.slots))
        self._upload_tables()
        self._empty_txt()

    def _upload_tables(self) -> None:
        """The per-request tables on the device (once per admission wave,
        never per tick)."""
        for name, tab in (("labels", self._labels), ("nulls", self._nulls),
                          ("scales", self._scales),
                          ("null_vecs", self._null_vecs),
                          ("null_mask", self._null_mask)):
            self._in.put(name, tab)

    def static_buffers(self) -> List[torch.Tensor]:
        """Every tensor the programs may read besides the params: the
        static inputs, latents, states, text tables and plan outputs."""
        out = list(self._in.dev.values()) + [self._xs, self._plan_buf]
        out += tree_leaves(self._states) + list(self._txt.values())
        if self._signal is not None:
            out.append(self._signal)
        return out

    def release_programs(self) -> None:
        """Drop every compiled program; the engine's graph pool is freed
        with its last graph (the engine then runs eagerly)."""
        self._programs = {}
        self._pool = None
        self._warm_keys = set()

    def graph_stats(self) -> Dict:
        """Programs compiled, CUDA graphs among them, capture seconds per
        program (key and guard classes) and the bytes the captures added
        to the engine's pool."""
        progs = [(k, g, p, prof) for k, lst in self._programs.items()
                 for g, p, prof in lst]
        return {"programs": len(progs),
                "graphs": sum(p.graph is not None for _, _, p, _ in progs),
                "capture_seconds": {
                    f"{k!r}{sorted(g)}": prof.compile_seconds
                    for k, g, _, prof in progs},
                "pool_bytes": sum(p.pool_bytes for _, _, p, _ in progs),
                "replays": sum(p.replays for _, _, p, _ in progs)}

    # -- programs ----------------------------------------------------------
    def _find_program(self, key):
        for guards, prog, _ in self._programs.get(key, ()):
            if guards_hold(guards, self._in.host):
                return prog
        return None

    def _run_program(self, key, fn: Callable[[], None]) -> None:
        """Replay the program of `key` whose branches the staged inputs
        take; with none, announce a cold program and run fn eagerly."""
        prog = self._find_program(key)
        if prog is not None:
            prog.run()
            return
        self._note_program(key if key not in self._warm_keys
                           else (key, "branches no program took"))
        fn()

    def _compile(self, key, fn: Callable[[], None], record: bool,
                 record_fn: Optional[Callable] = None) -> None:
        """Compile fn at `key` for the branches the staged inputs take
        now, unless a program of `key` already takes them.  The first
        program of a key is its profile; with `record` also its operator
        record (of `record_fn` where the program's contract covers more
        than the captured part)."""
        self._warm_keys.add(key)
        runs = 0
        prog = self._find_program(key)
        if prog is None:
            runs = 1
            guards: set = set()

            def logged():
                with branch_log() as log:
                    fn()
                guards.update(log)

            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            prog, prof = compile_program(logged, key=key, device=self.device,
                                         pool=self._pool)
            self._programs.setdefault(key, []).append(
                (frozenset(guards), prog, prof))
            self.program_profile.setdefault(key, prof)
        if record and key not in self.program_records:
            runs += 1
            ir = capture_ir(record_fn or fn, key=key,
                            declared_param_specs=self.param_leaf_specs(),
                            pool_bytes=prog.pool_bytes)
            self.program_ir[key] = ir
            self.program_records[key] = ir.record
        self.warmup_runs[key] = self.warmup_runs.get(key, 0) + runs

    def param_leaf_specs(self):
        """(shape, dtype-name) of the param leaves the programs read."""
        from repro_torch.analysis.ir.verify import param_leaf_specs
        return param_leaf_specs(self.params)

    def _want_all(self, steps, tvals, guided):
        """The plan's device pass: steps and timesteps into their static
        buffers, the "want" program over the engine's static latents and
        states (its graph, when warmup compiled it), then the one priced
        read."""
        self._in.put("steps", steps)
        self._in.put("tvals", tvals)
        self._run_program("want", self._want_static)
        return self._want.read(watch.host_read(self._plan_buf), steps,
                               guided, self._signal)

    def _want_static(self) -> None:
        """The "want" program: the device half of the plan over the static
        buffers into the packed plan and the signal."""
        i = self._in
        packed, sig = self._want.device(self._states, i.staged("steps"),
                                        self._xs, i.dev["tvals"],
                                        i.dev["labels"])
        self._plan_buf.copy_(packed)
        if sig is not None:
            if self._signal is None:
                self._signal = torch.empty_like(sig)
            self._signal.copy_(sig)

    def _run_tick(self, kind, bucket, gather, steps, tvals, cfg_ws, ab_t,
                  ab_n, want_c, want_u) -> None:
        """Stage one tick's host values and run its program."""
        i = self._in
        for name, a in (("steps", steps), ("tvals", tvals),
                        ("cfg_ws", cfg_ws), ("ab_t", ab_t), ("ab_n", ab_n),
                        ("want_c", want_c), ("want_u", want_u)):
            i.put(name, a)
        if gather is not None and bucket:
            self._put_rows(bucket, gather)
        self._run_program(bucket if self.row_compaction else kind,
                          lambda: self._tick_static(kind, bucket))

    def _put_rows(self, bucket: int, gather) -> None:
        for name, a, dtype in zip(("row_slot", "row_uncond", "row_dest"),
                                  gather, (torch.int64, torch.bool,
                                           torch.int64)):
            self._in.alloc(f"{name}/{bucket}", (bucket,), dtype)
            self._in.put(f"{name}/{bucket}", a)

    def _tick_static(self, kind, bucket) -> None:
        """The tick program: `_tick` over the static buffers, its latents
        and states written back in place."""
        i = self._in
        gather = None
        if self.row_compaction and bucket:
            gather = tuple(i.dev[f"{n}/{bucket}"]
                           for n in ("row_slot", "row_uncond", "row_dest"))
        xs, states = self._tick(
            kind, gather, self._states, i.staged("steps"), self._xs,
            i.dev["tvals"], i.dev["cfg_ws"], i.dev["ab_t"], i.dev["ab_n"],
            i.dev["null_vecs"], i.dev["null_mask"], self._txt,
            i.staged("want_c"), i.staged("want_u"), self._signal)
        # one copy over both: a new state leaf may be the old latents
        # (ToCa's prev_in), which the latents' own copy would overwrite
        tree_copy_((self._xs, self._states), (xs, states))

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            # the one synchronize a tick: it prices the tick, and it keeps
            # the host from refilling a pinned input buffer whose copy to
            # the device may still be pending (StaticInputs)
            # repro-lint: disable-next-line=host-sync-in-hot-path -- priced: the one synchronize a tick, which times the tick
            torch.cuda.synchronize(self.device)

    def _initial_noise(self, req: DiffusionRequest) -> torch.Tensor:
        shape = (self.tokens, self.in_dim)
        if self._noise_fn is not None:
            noise = torch.as_tensor(self._noise_fn(req))
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise_fn gave {tuple(noise.shape)} for "
                                 f"request {req.request_id}, want {shape}")
            return to_device(noise, self.device, torch.float32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(req.seed) * 2**32 + int(req.request_id)) % 2**63)
        return torch.randn(shape, generator=gen, device=self.device)

    # -- text conditioning ---------------------------------------------
    def _empty_txt(self) -> Dict[str, torch.Tensor]:
        """The static per-slot text tables all-masked in place (zero K/V,
        False masks): the exact no-op of the cross-attention branch.  {} on
        a text-free engine, whose ticks then take no text operand at
        all."""
        for t in self._txt.values():
            t.zero_()
        return self._txt

    def _build_text_tables(self) -> Dict[str, torch.Tensor]:
        """The live per-slot text tables of a text-enabled engine from the
        host embedding tables: one host-to-device copy into the static
        input, then the "text_kv" program.  Runs once per admission wave,
        never in a tick."""
        self._in.put("txt_host", self._txt_host)
        self._run_program("text_kv", self._text_kv_static)
        return self._txt

    def _text_kv_static(self) -> None:
        """The "text_kv" program: the embeddings re-zeroed under their
        masks (the no-op branch must hold bit-exactly), then every layer's
        K/V for all 2S rows in one `text_kv`, into the static tables."""
        packed = self._in.dev["txt_host"]
        tm = packed[..., -1] > 0.5
        te = torch.where(tm[..., None], packed[..., :-1], 0.0)
        tk, tv = dit.text_kv(self.params, te, self.cfg)
        self._txt["k"].copy_(tk)
        self._txt["v"].copy_(tv)
        self._txt["mask"].copy_(tm)

    def _tick(self, kind, gather, states, steps, xs, tvals, cfg_ws, ab_t,
              ab_n, null_vecs, null_mask, txt, want_c, want_u, signal):
        """One tick on the device: the backbone rows (the compacted bucket
        `gather` = (row_slot, row_uncond, row_dest), or with gather None
        the dense batch of `kind`; none on a skip tick) over the slots'
        text tables `txt`, both branches' slot steps on the plan's
        decisions, and the per-slot DDIM update."""
        dev = self.device

        def dev_t(a):   # host tables in, without a stream sync
            return to_device(a, dev)

        if kind == "skip":
            y_c = y_u = torch.zeros_like(xs)
        else:
            t_dev = dev_t(tvals)
            labels, nulls = self._in.dev["labels"], self._in.dev["nulls"]
            if gather is not None:
                row_slot, row_uncond, row_dest = gather
                y_c, y_u = self._compact_backbone(
                    xs, t_dev, labels, nulls, null_vecs, null_mask, txt,
                    dev_t(row_slot).long(), dev_t(row_uncond),
                    dev_t(row_dest).long())
            elif kind == "full":
                y_c, y_u = self._backbone2(xs, t_dev, labels, nulls,
                                           null_vecs, null_mask, txt)
            else:
                y_c = self._backbone(xs, t_dev, labels, txt)
                y_u = torch.zeros_like(xs)
        eps, states = self._apply(states, steps, xs, self._in.dev["scales"],
                                  dev_t(cfg_ws), y_c, y_u, want=want_c,
                                  want_u=want_u, signal=signal)
        a_t = dev_t(ab_t)[:, None, None]
        a_n = dev_t(ab_n)[:, None, None]
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

    def _note_program(self, key) -> None:
        """A program is about to run at `key`: announce it to a retrace
        sentinel when warmup never ran that key."""
        if key not in self._warm_keys:
            watch.emit("program", f"{self.cfg.name}[{key!r}]")

    def warmup(self, verify: bool = False) -> List:
        """Compile every program once on dummy operands — each bucket of
        the compacted engine, or the dense engine's three kinds, for every
        class of host branches its policies can take there (module
        docstring), and "want" when the engine plans on the device — so
        the kernels are built and every batch shape is captured before the
        first live tick; a text-enabled engine also compiles its text
        tables' program ("text_kv") and its conditioner's encoder
        ("text_encoder"), neither counted as a build, hit or miss.  On the
        card each program is a CUDA graph on the engine's one pool
        (`repro_torch.obs.profiling.compile_program`); on the CPU nothing
        is captured.  Returns the buckets (or kinds) run, then those text
        programs.

        The first warmup also profiles each key's first program into
        `self.program_profile` (`repro_torch.obs.ProgramProfile`), keyed
        by bucket (compacted) or tick kind (dense), plus "want" for the
        device plan pass when the engine has one and the text programs'
        keys: `compile_seconds` is the capture's synced seconds (on the
        CPU the first run's, kernel builds included), `flops` the products
        of its eager run under `repro_torch.obs.profiling.count_flops`,
        `bytes_accessed` nan.  `graph_stats()` counts every program.  A
        later warmup finds every program compiled, runs none and leaves the
        profiles as they are.  (JAX's warmup returns the profiles; the port keeps returning
        the runs and holds the profiles on the engine.)

        `verify=True` also runs each key's program once under the operator
        recorder (`repro_torch.analysis.ir.op_checks`; the "want" record
        covers the plan's priced read too) and checks the records
        (`verify_programs_by_key`): `self.ir_findings` becomes the findings
        ([] = clean) and each profile carries its program's.  A warmup with
        verify=True after one that recorded verifies from the records and
        runs nothing again.  Without verify, no dispatch mode is
        entered."""
        if not (verify and self.program_records):
            self._run_programs(record=verify)
        if verify:
            self._run_verification()
        return list(self._warm_runs)

    def _tick_candidates(self, key):
        """(want_c, want_u, steps, active) host inputs covering every class
        of branches a tick at `key` can take.  The tick's policies step on
        the plan's masks before active masking (as JAX's do), so a free
        slot may want a row the bucket does not hold: for each pair of
        active row counts that makes the bucket (or kind), the masks of
        the first slots, then with the last slot wanting too, then with
        every slot wanting; each with steps all on, none on and some on an
        interval (all on an interval > 1 first: the forecast branch).
        `active` is the pair of masks after active masking."""
        S = self.slots
        one = np.ones((S,), np.int32)
        out = []
        steps = (one, np.zeros((S,), np.int32),
                 np.concatenate([[0], one[1:]]).astype(np.int32))
        last, every = np.arange(S) == S - 1, np.ones((S,), bool)
        for n_c in range(S + 1):
            for n_u in range(S + 1):
                c, u = np.arange(S) < n_c, np.arange(S) < n_u
                if self.row_compaction:
                    at = compact_rows(c, u, S)[0]
                else:
                    at = "full" if n_u else ("cond" if n_c else "skip")
                if at != key:
                    continue
                for pc in (c, c | last, every):
                    for pu in (u, u | last, every):
                        out += [(pc, pu, st, (c, u)) for st in steps]
        return out

    def _run_programs(self, record: bool) -> None:
        """warmup's body: compile (profile on the first time; record when
        asked) every program not compiled before."""
        S = self.slots
        self._reset_static()
        i = self._in
        zf = np.zeros((S,), np.float32)
        ab = np.full((S,), 0.5, np.float32)
        for name, a in (("tvals", zf), ("cfg_ws", zf), ("ab_t", ab),
                        ("ab_n", ab)):
            i.put(name, a)
        # forecast branch for interval > 1
        i.put("steps", np.ones((S,), np.int32))

        def read_plan():
            self._want_static()
            return watch.host_read(self._plan_buf)

        # the programs hold the engine weakly: no reference cycle keeps a
        # dropped engine (its params, buffers and graph pool) alive
        me = weakref.proxy(self)
        if self._static_plan is None or self._static_cfg_plan is None:
            self._compile("want", lambda: me._want_static(), record,
                          read_plan)
        if self.row_compaction:
            runs = self._warmup_buckets()
        else:
            runs = ["full", "cond", "skip"]
        for key in runs:
            kind = key if not self.row_compaction else (
                "full" if key else "skip")
            if self.row_compaction and key:
                self._put_rows(key, (np.zeros((key,), np.int64),
                                     np.zeros((key,), bool),
                                     np.full((key,), 2 * S, np.int64)))
            for c, u, st, _ in self._tick_candidates(key):
                for name, a in (("want_c", c), ("want_u", u), ("steps", st)):
                    i.put(name, a)
                self._compile(key, lambda k=kind, b=key:
                              me._tick_static(k, b), record)
        if self.text_enabled:
            self._compile("text_kv", lambda: me._text_kv_static(), record)
            runs = runs + ["text_kv"]
            if self.conditioner is not None:
                self._warm_keys.add("text_encoder")
                rec = self.conditioner.warmup(verify=record)
                if record:
                    self.program_records["text_encoder"] = rec
                self.program_profile.setdefault(
                    "text_encoder", self.conditioner.program_profile)
                runs.append("text_encoder")
        self._sync()
        self._reset_static()
        self._warm_runs = runs

    def _capture_program_records(self) -> Dict[object, object]:
        """One OpRecord per warmup program key, recording them now when no
        warmup did."""
        if not self.program_records:
            self._run_programs(record=True)
        return self.program_records

    def _program_sites(self) -> Dict[object, Callable]:
        """The function each program key runs (the fallback anchor of a
        finding without a user frame)."""
        sites = {k: self._tick for k in self.program_records}
        sites.update(want=self._plan_all, text_kv=self._build_text_tables)
        if self.conditioner is not None:
            sites["text_encoder"] = self.conditioner._encode_program
        return sites

    def _run_verification(self) -> None:
        """verify_programs_by_key over the records: findings land on
        self.ir_findings and on the matching program profiles.  The
        analysis package is imported here only: serving without verify
        never loads it."""
        from repro_torch.analysis.ir.verify import verify_programs_by_key
        by_key = verify_programs_by_key(self)
        self.ir_findings = [
            f for _, fs in sorted(by_key.items(), key=lambda kv: str(kv[0]))
            for f in fs]
        for k, prof in list(self.program_profile.items()):
            self.program_profile[k] = dataclasses.replace(
                prof, ir_findings=tuple(by_key.get(k, ())))

    # ------------------------------------------------------------------
    def _check_request(self, req: DiffusionRequest) -> None:
        """The one request-shape contract, shared by session submission and
        slot admission."""
        if req.num_steps > self.max_steps:
            raise ValueError(f"request {req.request_id}: num_steps="
                             f"{req.num_steps} > max_steps={self.max_steps}")
        if req.null_label is not None and np.ndim(req.null_label) > 0:
            shape = np.shape(req.null_label)
            if shape != (self.cfg.d_model,):
                raise ValueError(
                    f"request {req.request_id}: null_label vector shape "
                    f"{shape} != (d_model={self.cfg.d_model},)")
        if req.prompt_tokens is not None or req.neg_prompt_tokens is not None:
            if not self.text_enabled:
                raise ValueError(
                    f"request {req.request_id}: prompt on non-text config "
                    f"'{self.cfg.name}' (dit_text_len == 0)")
            if self.conditioner is None:
                raise ValueError(
                    f"request {req.request_id}: prompt given but the engine "
                    f"has no conditioner (pass conditioner=PromptCache(...))")
        if (req.neg_prompt_tokens is not None and req.null_label is not None
                and np.ndim(req.null_label) > 0):
            raise ValueError(
                f"request {req.request_id}: neg_prompt_tokens conflicts "
                f"with a vector-valued null_label — both claim the uncond "
                f"conditioning vector")

    def _install_request(self, slot: int, req: DiffusionRequest) -> None:
        self._check_request(req)
        ts = self.sched.spaced(req.num_steps)
        self._ab[slot, :] = 1.0
        self._ab[slot, :req.num_steps] = self.sched.alpha_bars[ts]
        self._tv[slot, :] = 0.0
        self._tv[slot, :req.num_steps] = ts.astype(np.float32)
        self._labels[slot] = req.class_label
        null = req.null_label
        self._nulls[slot] = self.cfg.dit_num_classes
        self._null_vecs[slot, :] = 0.0
        self._null_mask[slot] = False
        if null is not None and np.ndim(null) == 0:
            self._nulls[slot] = int(null)
        elif null is not None:
            # a negative prompt overrides the class-embedding lookup on this
            # slot's uncond rows
            self._null_vecs[slot, :] = np.asarray(null, np.float32)
            self._null_mask[slot] = True
        if self.text_enabled:
            # reset-on-refill covers the text tables: a refilled slot never
            # sees its previous request's prompt
            neg_row = self.slots + slot
            self._txt_host[[slot, neg_row]] = 0.0
            if req.prompt_tokens is not None:
                self._put_text(slot, self.conditioner.get(req.prompt_tokens))
            if req.neg_prompt_tokens is not None:
                ne = self.conditioner.get(req.neg_prompt_tokens)
                self._put_text(neg_row, ne)
                # the pooled negative-prompt embedding rides the null-vector
                # path: the uncond rows condition on it in place of the
                # null-class embedding, and cross-attend its K/V
                self._nulls[slot] = self.cfg.dit_num_classes
                self._null_vecs[slot, :] = ne.pooled
                self._null_mask[slot] = True
        self._scales[slot] = req.cfg_scale
        self._nsteps[slot] = req.num_steps
        self._guided[slot] = req.guided

    def _put_text(self, row: int, pe) -> None:
        """A PromptEmbedding into host text-table row `row`."""
        self._txt_host[row, :, :-1] = pe.embed
        self._txt_host[row, :, -1] = pe.mask

    def _probe_static_plan(self, policy: CachePolicy) -> Optional[np.ndarray]:
        """want_compute(None, s, None) for every step, or None when the
        policy needs its state (or x) to decide (JAX's probe rule: any
        exception)."""
        return static_plan(policy, self.max_steps)

    def _plan_all(self, states, steps, xs, tvals):
        """Per-slot (want_cond, want_uncond, metric, signal) before active
        masking; want_uncond is masked by the guided flag.  When both
        branches have host tables the plan costs no device round trip
        (metric None).  Otherwise the fused device pass decides in ONE
        device-to-host copy, a branch with a host table keeps it, and the
        signal stays on the device for the tick; that pass reads the
        engine's static buffers, so `states` and `xs` must be them (the
        session's)."""
        if self._static_plan is not None and self._static_cfg_plan is not None:
            return (self._static_plan[steps],
                    self._static_cfg_plan[steps] & self._guided, None, None)
        if states is not self._states or xs is not self._xs:
            raise ValueError("the device plan reads the engine's static "
                             "latents and states only")
        plan = self._want_all(steps, tvals, self._guided)
        wc = (plan.want_cond if self._static_plan is None
              else self._static_plan[steps])
        return wc, plan.want_uncond, plan.metric, plan.signal

    # ------------------------------------------------------------------
    def start_session(self, requests: Sequence[DiffusionRequest],
                      telemetry: Optional[ServingTelemetry] = None,
                      hooks: Optional[Sequence[TickHook]] = None,
                      capture_latents: bool = False,
                      modality: Optional[str] = None,
                      metrics=None) -> ServeSession:
        """Begin a tick-granular session (at most one per engine: the
        per-slot tables live on the engine)."""
        return ServeSession(self, requests, telemetry, hooks=hooks,
                            capture_latents=capture_latents,
                            modality=modality, metrics=metrics)

    def serve(self, requests: Sequence[DiffusionRequest],
              telemetry: Optional[ServingTelemetry] = None,
              max_ticks: Optional[int] = None,
              hooks: Optional[Sequence[TickHook]] = None,
              capture_latents: bool = False,
              metrics=None) -> List[DiffusionResult]:
        """Run every request through the slot pool; results in request
        order.  With max_ticks, unfinished requests are recorded as
        preempted in telemetry."""
        session = self.start_session(requests, telemetry, hooks=hooks,
                                     capture_latents=capture_latents,
                                     metrics=metrics)
        try:
            while not session.done:
                session.tick()
                if max_ticks is not None and session.ticks >= max_ticks:
                    break
        finally:
            session.finish()
        return session.finish()
