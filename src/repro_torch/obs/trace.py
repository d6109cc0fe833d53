"""TraceRecorder — structured tracing for the serving engines; the port of
the JAX `obs/trace.py`.

A TickHook (`ServeSession(..., hooks=[recorder.observe])`, or one entry per
modality for MixedModalityEngine) that turns the engine's TickEvent stream
into two durable artifacts:

  * A Chrome/Perfetto `trace_event` JSON file (`write_chrome_trace`): one
    process (pid) per modality sub-pool, with a "plan" track (host time
    deciding each tick: the fused want pass and its one read back), a
    "backbone" track (the synced time of the tick's device work,
    annotated with kind / bucket / rows; the row gather and scatter of the
    compacted tick run inside that one timed span, so they appear as
    instant markers on it rather than separately timed phases), and one
    track per slot carrying cache-lifecycle spans: admit -> per-tick
    compute / reuse / cond-only events annotated with the policy's signal
    value and threshold -> finish or preempt.  Open with
    https://ui.perfetto.dev or chrome://tracing.

  * A cache-event JSONL log (`write_cache_events`): one line per active
    slot per tick — slot, request id, step, t, policy, want_compute,
    want_uncond, signal distance, rows in bucket.  This is the durable
    counterpart of the control plane's in-memory SignalTraceLog ring:
    `signal_trace_from_files` rebuilds a SignalTraceLog from it (plus the
    optional probe-latents sidecar from `write_probes`), so
    `probe_training_set` / `fit_want_gate` can train from files long
    after the serving process exited.

The recorder is engine-agnostic (it duck-types TickEvent and never touches
the engine), host-side, and O(slots) per tick.  Its timestamps come from
`repro_torch.obs.clock.monotonic`.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .clock import monotonic

__all__ = ["TraceRecorder", "policy_signature", "load_cache_events",
           "load_probes", "signal_trace_from_files", "validate_chrome_trace"]


def policy_signature(policy) -> Dict[str, Optional[float]]:
    """(name, threshold) metadata for annotating trace events.

    `threshold` is the scalar the policy's refresh decision compares its
    signal against, taken from the first of the conventional attribute
    names; None for policies without one (interval schedules)."""
    if policy is None:
        return {"policy": "none", "threshold": None}
    if isinstance(policy, str):
        return {"policy": policy, "threshold": None}
    name = getattr(policy, "name", type(policy).__name__)
    threshold = None
    for attr in ("delta", "threshold"):
        v = getattr(policy, attr, None)
        if isinstance(v, (int, float)):
            threshold = float(v)
            break
    return {"policy": str(name), "threshold": threshold}


class TraceRecorder:
    """Record TickEvents into a Chrome trace + cache-event JSONL.

    Parameters
    ----------
    policy: the pool's main CachePolicy (or its name) — stamped on every
        cache event together with its threshold, so the log answers "why
        did this slot skip" without joining against config files.
    probe_every: like SignalTraceLog — every Nth admitted request also
        records its pre-tick latent trajectory (requires the session to
        run with capture_latents=True); `write_probes` persists them.
    """

    def __init__(self, policy=None, *, probe_every: int = 0,
                 max_probes: int = 8, max_probe_steps: int = 64):
        sig = policy_signature(policy)
        self.policy_name: str = sig["policy"]
        self.threshold: Optional[float] = sig["threshold"]
        #: chrome trace_event dicts (the "traceEvents" array)
        self.events: List[Dict] = []
        #: cache-event dicts, one per active slot per tick
        self.cache_events: List[Dict] = []
        self.probe_every = int(probe_every)
        self.max_probes = int(max_probes)
        self.max_probe_steps = int(max_probe_steps)
        #: request_id -> {"label", "steps", "tvals", "xs"}
        self.probes: Dict[int, Dict] = {}
        self._admitted = 0
        self._t0 = monotonic()
        self._pids: Dict[str, int] = {}          # modality -> pid
        self._named_tids: Dict[tuple, bool] = {}  # (pid, tid) named yet?
        #: (modality, slot) -> request_id with an open lifecycle span
        self._open: Dict[tuple, Dict] = {}
        self.ticks_seen = 0

    @property
    def wants_latents(self) -> bool:
        """Should sessions feeding this recorder run capture_latents?"""
        return self.probe_every > 0

    # -- chrome plumbing ----------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _pid(self, modality: str) -> int:
        pid = self._pids.get(modality)
        if pid is None:
            pid = self._pids[modality] = len(self._pids) + 1
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0,
                                "args": {"name": f"pool:{modality}"}})
        return pid

    def _tid(self, pid: int, tid: int, name: str) -> int:
        if not self._named_tids.get((pid, tid)):
            self._named_tids[(pid, tid)] = True
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": pid, "tid": tid,
                                "args": {"name": name}})
        return tid

    # slot tracks start at tid 2 (0 = plan, 1 = backbone)
    _TID_PLAN, _TID_BACKBONE, _TID_SLOT0 = 0, 1, 2

    # -- the hook ------------------------------------------------------
    def observe(self, event) -> None:
        """TickHook entry point: fold one TickEvent into both artifacts."""
        t_now = monotonic()
        pid = self._pid(event.modality)
        seconds = float(event.seconds)
        plan_s = float(event.plan_seconds)
        t_start = t_now - seconds - plan_s       # tick began planning here
        t_dev = t_now - seconds                  # device program began here
        bucket = int(event.rows_computed) + int(event.rows_padding)

        if plan_s > 0.0:
            self.events.append({
                "ph": "X", "name": "plan", "cat": "plan", "pid": pid,
                "tid": self._tid(pid, self._TID_PLAN, "plan"),
                "ts": self._us(t_start), "dur": plan_s * 1e6,
                "args": {"tick": event.tick,
                         "on_device": event.metric is not None}})
        tid_bb = self._tid(pid, self._TID_BACKBONE, "backbone")
        self.events.append({
            "ph": "X", "name": f"tick:{event.kind}", "cat": "backbone",
            "pid": pid, "tid": tid_bb,
            "ts": self._us(t_dev), "dur": seconds * 1e6,
            "args": {"tick": event.tick, "kind": event.kind,
                     "rows_computed": int(event.rows_computed),
                     "rows_padding": int(event.rows_padding),
                     "bucket": bucket}})
        if event.kind != "skip":
            # gather/scatter run inside the one synced tick span — no
            # separate device timing exists, so they are instant markers
            # bracketing the span, not separately-timed phases
            self.events.append({
                "ph": "i", "name": "gather", "cat": "backbone", "pid": pid,
                "tid": tid_bb, "ts": self._us(t_dev), "s": "t",
                "args": {"rows": int(event.rows_computed)}})
            self.events.append({
                "ph": "i", "name": "scatter", "cat": "backbone", "pid": pid,
                "tid": tid_bb, "ts": self._us(t_now), "s": "t",
                "args": {"rows": int(event.rows_computed)}})

        rids = np.asarray(event.request_ids)
        active = np.asarray(event.active, bool)
        metric = (np.asarray(event.metric, np.float32)
                  if event.metric is not None else None)

        # -- slot lifecycle: admit opens a span on the slot's track -----
        for req in event.admitted:
            self._admitted += 1
            if (self.probe_every > 0
                    and (self._admitted - 1) % self.probe_every == 0
                    and len(self.probes) < self.max_probes):
                self.probes.setdefault(req.request_id, {
                    "label": int(getattr(req, "class_label", 0)),
                    "steps": [], "tvals": [], "xs": []})
            slots = np.nonzero(rids == req.request_id)[0]
            if len(slots) == 0:
                continue
            s = int(slots[0])
            tid = self._tid(pid, self._TID_SLOT0 + s, f"slot {s}")
            self.events.append({
                "ph": "B", "name": f"req {req.request_id}", "cat": "slot",
                "pid": pid, "tid": tid, "ts": self._us(t_start),
                "args": {"request_id": int(req.request_id),
                         "num_steps": int(req.num_steps),
                         "guided": bool(getattr(req, "guided", False))}})
            self._open[(event.modality, s)] = {
                "request_id": int(req.request_id)}

        # -- per-slot, per-tick cache decisions -------------------------
        for s in np.nonzero(active)[0]:
            s = int(s)
            rid = int(rids[s])
            wc = bool(event.want_cond[s])
            wu = bool(event.want_uncond[s])
            sig = float(metric[s]) if metric is not None else None
            if wc and wu:
                name = "compute+cfg"
            elif wc:
                name = "compute"
            elif wu:
                name = "cond-only"   # uncond-branch refresh rides alone
            else:
                name = "reuse"
            tid = self._tid(pid, self._TID_SLOT0 + s, f"slot {s}")
            self.events.append({
                "ph": "X", "name": name, "cat": "cache", "pid": pid,
                "tid": tid, "ts": self._us(t_dev), "dur": seconds * 1e6,
                "args": {"step": int(event.steps[s]),
                         "t": float(event.tvals[s]),
                         "signal": sig, "threshold": self.threshold}})
            self.cache_events.append({
                "tick": int(event.tick), "modality": event.modality,
                "slot": s, "request_id": rid,
                "step": int(event.steps[s]), "t": float(event.tvals[s]),
                "policy": self.policy_name, "want_compute": wc,
                "want_uncond": wu, "guided": bool(event.guided[s]),
                "signal": sig, "threshold": self.threshold,
                "rows_in_bucket": bucket, "kind": event.kind})
            probe = self.probes.get(rid)
            if (probe is not None and event.latents is not None
                    and len(probe["steps"]) < self.max_probe_steps):
                probe["steps"].append(int(event.steps[s]))
                probe["tvals"].append(float(event.tvals[s]))
                probe["xs"].append(np.asarray(event.latents[s]))

        # -- finishes close their slot spans ----------------------------
        for rec in event.finished:
            self._close(event.modality, pid, t_now, rec.request_id,
                        preempted=False,
                        computed_steps=int(rec.computed_steps))
        self.ticks_seen += 1

    #: the recorder IS a TickHook: hooks=[recorder] and hooks=[recorder.observe]
    #: are equivalent
    __call__ = observe

    def _close(self, modality: str, pid: int, t: float, rid: int,
               preempted: bool, computed_steps: Optional[int] = None) -> None:
        for key, info in list(self._open.items()):
            if key[0] == modality and info["request_id"] == rid:
                tid = self._TID_SLOT0 + key[1]
                args = {"request_id": rid, "preempted": preempted}
                if computed_steps is not None:
                    args["computed_steps"] = computed_steps
                self.events.append({"ph": "E", "name": f"req {rid}",
                                    "cat": "slot", "pid": pid, "tid": tid,
                                    "ts": self._us(t), "args": args})
                del self._open[key]
                return

    def finish(self) -> None:
        """Close lifecycle spans still open (preempted / cut-off requests)
        so the trace has no dangling "B" events.  Idempotent."""
        t = monotonic()
        for (modality, s), info in list(self._open.items()):
            pid = self._pid(modality)
            self._close(modality, pid, t, info["request_id"],
                        preempted=True)

    # -- artifacts -----------------------------------------------------
    def chrome_trace(self) -> Dict:
        """The Chrome `trace_event` JSON object (displayTimeUnit ms)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms",
                "otherData": {"policy": self.policy_name,
                              "threshold": self.threshold}}

    def write_chrome_trace(self, path: str) -> None:
        self.finish()
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=float)

    def write_cache_events(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.cache_events:
                f.write(json.dumps(ev, default=float) + "\n")

    def write_probes(self, path: str) -> None:
        """Persist probed latent trajectories as an .npz sidecar keyed by
        request id (xs_<rid>, tvals_<rid>, steps_<rid>, label_<rid>)."""
        arrays = {}
        for rid, p in self.probes.items():
            if not p["xs"]:
                continue
            arrays[f"xs_{rid}"] = np.stack(p["xs"])
            arrays[f"tvals_{rid}"] = np.asarray(p["tvals"], np.float32)
            arrays[f"steps_{rid}"] = np.asarray(p["steps"], np.int32)
            arrays[f"label_{rid}"] = np.asarray(p["label"], np.int32)
        np.savez(path, **arrays)

    # -- views ---------------------------------------------------------
    def computed_steps_by_request(self) -> Dict[int, int]:
        """want_compute tick count per request id, from the cache-event
        log — must reconcile exactly with RequestRecord.computed_steps."""
        out: Dict[int, int] = {}
        for ev in self.cache_events:
            out.setdefault(ev["request_id"], 0)
            if ev["want_compute"]:
                out[ev["request_id"]] += 1
        return out

    def uncond_steps_by_request(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for ev in self.cache_events:
            out.setdefault(ev["request_id"], 0)
            if ev["want_uncond"]:
                out[ev["request_id"]] += 1
        return out


# ----------------------------------------------------------------------
# file consumers: JSONL / probes -> SignalTraceLog (durable ring)
# ----------------------------------------------------------------------

def load_cache_events(path: str) -> List[Dict]:
    """Parse a cache-event JSONL file back into dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_probes(path: str) -> Dict[int, Dict]:
    """Parse a `write_probes` .npz back into {request_id: probe dict}."""
    probes: Dict[int, Dict] = {}
    with np.load(path) as z:
        for key in z.files:
            kind, rid = key.rsplit("_", 1)
            p = probes.setdefault(int(rid), {})
            p[kind] = z[key]
    return {rid: {"label": int(p.get("label", 0)),
                  "steps": [int(s) for s in p.get("steps", [])],
                  "tvals": [float(t) for t in p.get("tvals", [])],
                  "xs": list(p["xs"])}
            for rid, p in probes.items() if "xs" in p}


def signal_trace_from_files(cache_events_path: str,
                            probes_path: Optional[str] = None):
    """Rebuild a SignalTraceLog from a cache-event JSONL (+ optional probe
    sidecar): the durable alternative to keeping the in-memory ring alive.
    The result feeds `probe_training_set` / `fit_want_gate` unchanged."""
    # lazy import: repro_torch.obs must stay importable without the serving
    # stack
    from repro_torch.serving.control.trace import SignalTraceLog, TraceEntry
    events = load_cache_events(cache_events_path)
    log = SignalTraceLog(max_entries=max(len(events), 1))
    for ev in events:
        log.entries.append(TraceEntry(
            tick=int(ev["tick"]), modality=ev.get("modality", "image"),
            request_id=int(ev["request_id"]), step=int(ev["step"]),
            want_cond=bool(ev["want_compute"]),
            want_uncond=bool(ev["want_uncond"]),
            metric=float(ev["signal"]) if ev.get("signal") is not None
            else 0.0,
            guided=bool(ev.get("guided", False))))
        log.entries_seen += 1
    if probes_path is not None:
        log.probes.update(load_probes(probes_path))
    return log


# ----------------------------------------------------------------------
# schema validation (the golden-file test's checker, usable standalone)
# ----------------------------------------------------------------------

_REQUIRED = {"ph", "name", "pid", "tid"}


def validate_chrome_trace(trace: Dict) -> List[str]:
    """Structural validation of a Chrome trace object.  Returns a list of
    problems (empty == valid): required keys per event, non-negative
    timestamps, per-track monotonic event starts, and B/E span nesting
    (every begin closed by a matching end, never crossed)."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts: Dict[tuple, float] = {}
    open_spans: Dict[tuple, List[str]] = {}
    for i, ev in enumerate(events):
        missing = _REQUIRED - set(ev)
        if missing:
            problems.append(f"event {i}: missing keys {sorted(missing)}")
            continue
        if ev["ph"] == "M":
            continue
        ts = ev.get("ts")
        if ts is None:
            problems.append(f"event {i}: non-metadata event without ts")
            continue
        if ts < 0:
            problems.append(f"event {i}: negative ts {ts}")
        track = (ev["pid"], ev["tid"])
        if ev["ph"] in ("X", "B", "i") and ts + 1e-6 < last_ts.get(
                track, 0.0):
            problems.append(f"event {i}: ts {ts} went backwards on track "
                            f"{track} (last {last_ts[track]})")
        if ev["ph"] in ("X", "B", "i"):
            last_ts[track] = max(last_ts.get(track, 0.0), ts)
        if ev["ph"] == "B":
            open_spans.setdefault(track, []).append(ev["name"])
        elif ev["ph"] == "E":
            stack = open_spans.get(track, [])
            if not stack:
                problems.append(f"event {i}: E without open B on {track}")
            elif stack[-1] != ev["name"]:
                problems.append(f"event {i}: E '{ev['name']}' crosses open "
                                f"span '{stack[-1]}' on {track}")
            else:
                stack.pop()
    for track, stack in open_spans.items():
        if stack:
            problems.append(f"track {track}: unclosed spans {stack}")
    return problems
