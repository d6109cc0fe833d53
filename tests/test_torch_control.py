"""The port's online control plane against the JAX package, on the CPU:
gate training (`lazy_trajectory_loss`, `train_lazy_gate`, `fit_want_gate`),
`TelemetryWindow`, SmoothCache's calibration profile and schedule,
`SignalTraceLog` with its probes and `probe_training_set`, and the
`OnlineTuner` (a forced blue/green swap, the priced pick, the tuned-point
key) with `ControlPlane`.

Both packages get the same bridged weights at the SMALL DiT and the same
inputs (numpy seeds; JAX's initial noise through `noise_fn`, JAX's
calibration latent through the split-out `_profile_from`, JAX's initial
gate through a monkeypatched `init_gate`).  Tolerances: the loss and its
gradient 1e-5 relative (the gradient relative to its largest element);
training histories and gates 1e-4 relative; the calibration profile and
trace metrics 1e-5 abs; served x0 1e-4 abs / 1e-3 rel; decisions, steps,
window summaries and schedules exact (each thresholded TeaCache decision
first checked >= 1e-4 relative from its threshold)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.core.learned import init_gate as jax_init_gate  # noqa: E402
from repro.core.learned import \
    lazy_trajectory_loss as jax_lazy_loss  # noqa: E402
from repro.core.learned import train_lazy_gate as jax_train  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.serving import control as jctl  # noqa: E402
from repro.serving.control import smoothcache as jsc  # noqa: E402
from repro.serving.diffusion import SLA as JaxSLA  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import TickEvent as JaxTickEvent  # noqa: E402
from repro.serving.diffusion import price_and_pick as jax_price  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro.serving.diffusion.telemetry import \
    RequestRecord as JaxRecord  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.core import learned as tlearned  # noqa: E402
from repro_torch.modalities import make_workload  # noqa: E402
from repro_torch.serving import control as tctl  # noqa: E402
from repro_torch.serving.control import smoothcache as tsc  # noqa: E402
from repro_torch.serving.control import trace as ttrace  # noqa: E402
from repro_torch.serving.control.tuner import _policy_key  # noqa: E402
from repro_torch.serving.diffusion import (SLA, DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine, TickEvent,
                                           TunedPolicy, price_and_pick)
from repro_torch.serving.diffusion.telemetry import RequestRecord  # noqa: E402

NUM_STEPS = 8
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)
TEACACHE_DELTA = 0.5
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_gate(key, dim, scale=30.0):
    """JAX's init_gate, its weights scaled so that the scores move."""
    g = jax_init_gate(jax.random.PRNGKey(key), dim)
    return {"w": g["w"] * scale, "b": g["b"]}


def _to_t(gate):
    return {k: torch.from_numpy(np.array(v)) for k, v in gate.items()}


def _trajectory(seed, T=6, tokens=8, D=4):
    rng = np.random.default_rng(seed)
    ins = rng.standard_normal((T, tokens, D)).astype(np.float32)
    outs = (0.5 * ins + 0.2 * rng.standard_normal(ins.shape)).astype(
        np.float32)
    return ins, outs


# ----------------------------------------------------------------------
# gate training
# ----------------------------------------------------------------------

def test_lazy_trajectory_loss_value_and_grad_match_jax():
    """The soft rollout's loss within 1e-5 relative of
    jax.value_and_grad's, and its gradient within 1e-5 of the gradient's
    largest element."""
    ins, outs = _trajectory(0)
    jg = _jax_gate(2, ins.shape[-1])
    jloss, jgrad = jax.value_and_grad(
        lambda g: jax_lazy_loss(g, jnp.asarray(ins), jnp.asarray(outs),
                                rho=0.1))(jg)
    tg = {k: v.requires_grad_(True) for k, v in _to_t(jg).items()}
    tloss = tlearned.lazy_trajectory_loss(tg, torch.from_numpy(ins),
                                          torch.from_numpy(outs), rho=0.1)
    grads = torch.autograd.grad(tloss, [tg["w"], tg["b"]])
    assert _rel(float(tloss.detach()), float(jloss)) <= 1e-5
    scale = max(float(np.abs(np.asarray(jgrad["w"])).max()),
                abs(float(jgrad["b"])))
    for got, k in zip(grads, ("w", "b")):
        err = float(np.abs(got.numpy() - np.asarray(jgrad[k])).max())
        assert err <= 1e-5 * scale, (k, err, scale)


def test_train_lazy_gate_matches_jax(monkeypatch):
    """40 SGD steps from JAX's initial gate (injected through init_gate):
    loss history and final gate within 1e-4 relative; the gate comes back
    detached."""
    ins, outs = _trajectory(1)
    jgate, jhist = jax_train(jax.random.PRNGKey(3), jnp.asarray(ins),
                             jnp.asarray(outs), steps=40, lr=0.5)
    init = _to_t(jax_init_gate(jax.random.PRNGKey(3), ins.shape[-1]))
    monkeypatch.setattr(tlearned, "init_gate", lambda gen, dim, device=None:
                        {k: v.clone() for k, v in init.items()})
    tgate, thist = tlearned.train_lazy_gate(
        torch.Generator().manual_seed(0), torch.from_numpy(ins),
        torch.from_numpy(outs), steps=40, lr=0.5)
    assert len(thist) == len(jhist) == 40
    assert _rel(thist, jhist) <= 1e-4
    for k in ("w", "b"):
        assert not tgate[k].requires_grad
        assert _rel(tgate[k].numpy(), np.asarray(jgate[k])) <= 1e-4
    assert thist[-1] < thist[0]


def test_fit_want_gate_matches_jax(monkeypatch):
    """Two trajectories of different lengths (one loss each, averaged):
    loss history and final gate within 1e-4 relative of JAX's from JAX's
    initial gate; no trajectory raises JAX's error."""
    pairs = [_trajectory(4), _trajectory(5, T=4)]
    jgate, jhist = jctl.fit_want_gate(
        jax.random.PRNGKey(1), [(jnp.asarray(i), jnp.asarray(o))
                                for i, o in pairs], steps=30, lr=0.5)
    init = _to_t(jax_init_gate(jax.random.PRNGKey(1), 4))
    monkeypatch.setattr(ttrace, "init_gate", lambda gen, dim, device=None:
                        {k: v.clone() for k, v in init.items()})
    tgate, thist = tctl.fit_want_gate(
        torch.Generator().manual_seed(0),
        [(torch.from_numpy(i), torch.from_numpy(o)) for i, o in pairs],
        steps=30, lr=0.5)
    assert _rel(thist, jhist) <= 1e-4
    for k in ("w", "b"):
        assert _rel(tgate[k].numpy(), np.asarray(jgate[k])) <= 1e-4
    with pytest.raises(ValueError) as je:
        jctl.fit_want_gate(jax.random.PRNGKey(0), [])
    with pytest.raises(ValueError) as te:
        tctl.fit_want_gate(torch.Generator(), [])
    assert str(te.value) == str(je.value)


def test_init_gate_is_the_generators_draw_on_any_device():
    """The gate is drawn on the generator's device and moved: one seed
    gives one gate wherever it is placed."""
    a = tlearned.init_gate(torch.Generator().manual_seed(5), 16)
    b = tlearned.init_gate(torch.Generator().manual_seed(5), 16,
                           device="cpu")
    assert torch.equal(a["w"], b["w"]) and float(a["b"]) == 0.0


# ----------------------------------------------------------------------
# TelemetryWindow
# ----------------------------------------------------------------------

def _events(tick_cls, rec_cls, n=14, S=3):
    """Synthetic tick events: kinds cycling full/cond/skip, device metrics
    on every third tick, one finished request every other tick."""
    rng = np.random.default_rng(7)
    out = []
    for t in range(n):
        kind = ("full", "cond", "skip")[t % 3]
        active = rng.random(S) < 0.8
        metric = (rng.random(S).astype(np.float32) if t % 3 == 1 else None)
        fin = []
        if t % 2:
            r = rec_cls(100 + t, 8, cfg_scale=2.0 if t % 4 == 1 else 0.0)
            r.computed_steps = int(rng.integers(1, 9))
            r.uncond_computed_steps = int(rng.integers(0, 9))
            fin = [r]
        rows = 0 if kind == "skip" else int(rng.integers(1, 2 * S + 1))
        out.append(tick_cls(
            tick=t, modality="image", kind=kind,
            seconds=float(rng.random() * 1e-2),
            rows_computed=rows, rows_padding=int(rng.integers(0, 2)),
            active=active, request_ids=np.arange(S, dtype=np.int64),
            steps=np.full((S,), t, np.int32),
            tvals=np.full((S,), 900.0 - t, np.float32),
            labels=np.zeros((S,), np.int32), guided=np.zeros((S,), bool),
            want_cond=active, want_uncond=np.zeros((S,), bool),
            plan_seconds=float(rng.random() * 1e-3), metric=metric,
            finished=fin))
    return out


@pytest.mark.parametrize("max_ticks", [256, 8])
def test_telemetry_window_matches_jax(max_ticks):
    """The same synthetic TickEvents (evicting at max_ticks 8): equal
    summaries, row times, occupancy, plan time and published gauges."""
    from repro.obs import MetricsRegistry as JaxRegistry
    from repro_torch.obs import MetricsRegistry
    jw = jctl.TelemetryWindow(max_ticks=max_ticks, max_requests=4)
    tw = tctl.TelemetryWindow(max_ticks=max_ticks, max_requests=4)
    for je, te in zip(_events(JaxTickEvent, JaxRecord),
                      _events(TickEvent, RequestRecord)):
        jw.observe(je)
        tw.observe(te)
    jw.note_psnr(3, 21.5)
    tw.note_psnr(3, 21.5)
    assert tw.summary() == jw.summary()
    assert tw.row_time_ms() == jw.row_time_ms()
    assert tw.occupancy() == jw.occupancy()
    assert tw.plan_time_ms() == jw.plan_time_ms()
    assert [tuple(vars(s).values()) for s in tw.ticks] == \
        [tuple(vars(s).values()) for s in jw.ticks]
    jr, tr = JaxRegistry(), MetricsRegistry()
    jw.publish(jr, modality="image")
    tw.publish(tr, modality="image")
    assert tr.prometheus_text() == jr.prometheus_text()


# ----------------------------------------------------------------------
# SmoothCache
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg_scale", [0.0, 2.0])
def test_calibration_profile_matches_jax(setup, cfg_scale):
    """The profile along JAX's calibration latent, fed to the port, within
    1e-5 abs; `calibrate` draws its own latent and keeps the shape."""
    jcfg, tcfg, jp, tp = setup
    jprof = jsc.calibration_profile(jp, jcfg, NUM_STEPS, seed=2,
                                    cfg_scale=cfg_scale, class_label=3)
    xT = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                    (1, jcfg.dit_tokens, jcfg.dit_in_dim)))
    tprof = tsc._profile_from(tp, tcfg, torch.from_numpy(xT), NUM_STEPS,
                              class_label=3, cfg_scale=cfg_scale)
    assert len(tprof) == len(jprof) == NUM_STEPS and tprof[0] == 0.0
    np.testing.assert_allclose(tprof, jprof, atol=1e-5, rtol=0)
    own = tctl.SmoothCacheSchedule.calibrate(tp, tcfg, NUM_STEPS, seed=2)
    assert len(own._schedule) == NUM_STEPS and own._schedule[0]


@pytest.mark.parametrize("alpha", [0.02, 0.05, 0.1, 0.3])
def test_smoothcache_schedule_matches_jax(setup, alpha):
    """From one profile, the same static schedule, compute fraction and
    host plan (no device plan) as JAX's."""
    profile = [0.0, 0.24, 0.071, 0.049, 0.069, 0.081, 0.064, 0.075]
    js = jctl.SmoothCacheSchedule(profile, alpha)
    ts = tctl.SmoothCacheSchedule(profile, alpha)
    assert ts.static_schedule(10) == js.static_schedule(10)
    assert ts.compute_fraction == js.compute_fraction
    assert ts.name == js.name == "smoothcache"
    _, tcfg, _, tp = setup
    eng = DiffusionServingEngine(tp, tcfg, ts, slots=2, max_steps=NUM_STEPS,
                                 device="cpu")
    assert eng._static_plan is not None


def test_smoothcache_for_modality(setup):
    """A workload's schedule is its backbone's calibration."""
    _, tcfg, _, tp = setup
    wl = make_workload("image", cfg=tcfg, params=tp)
    sc = tctl.smoothcache_for_modality(wl, NUM_STEPS, alpha=0.1, seed=4)
    ref = tctl.SmoothCacheSchedule.calibrate(tp, tcfg, NUM_STEPS, alpha=0.1,
                                             seed=4)
    assert sc.profile == ref.profile and sc._schedule == ref._schedule


# ----------------------------------------------------------------------
# SignalTraceLog, probes, probe_training_set
# ----------------------------------------------------------------------

def _trace_requests(cls, n=5):
    """Budgets 8 and 6 alternating, request 1 guided; 5 requests through 2
    slots, so slots are refilled."""
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5, cfg_scale=2.0 if i == 1 else 0.0)
            for i in range(n)]


@pytest.fixture(scope="module")
def traced(setup):
    """One served TeaCache queue per package, each with a probing
    SignalTraceLog; JAX's plan margins recorded."""
    jcfg, tcfg, jp, tp = setup
    jeng = JaxEngine(jp, jcfg, jax_make_policy("teacache",
                                               delta=TEACACHE_DELTA),
                     slots=2, max_steps=NUM_STEPS)
    teng = DiffusionServingEngine(tp, tcfg, make_policy(
        "teacache", delta=TEACACHE_DELTA), slots=2, max_steps=NUM_STEPS,
        noise_fn=_jax_noise(tcfg), device="cpu")
    margins = []

    def on_tick(ev):
        if ev.metric is not None:
            margins.extend(abs(float(ev.metric[s]) - TEACACHE_DELTA)
                           / TEACACHE_DELTA
                           for s in np.nonzero(ev.active)[0])

    jlog = jctl.SignalTraceLog(probe_every=2, max_probe_steps=NUM_STEPS)
    tlog = tctl.SignalTraceLog(probe_every=2, max_probe_steps=NUM_STEPS)
    jres = jeng.serve(_trace_requests(JaxRequest),
                      hooks=[jlog.observe, on_tick], capture_latents=True)
    tres = teng.serve(_trace_requests(DiffusionRequest), hooks=[tlog.observe],
                      capture_latents=True)
    return jlog, tlog, jres, tres, margins


def test_signal_trace_log_matches_jax(traced):
    """Equal entries (tick, request, step, wants, guided; metric within
    1e-5 abs), summaries and probes (steps and t exact, latents at the
    served tolerance)."""
    jlog, tlog, jres, tres, margins = traced
    assert margins and min(margins) >= MARGIN
    assert len(tlog.entries) == len(jlog.entries) > 0
    for a, b in zip(tlog.entries, jlog.entries):
        assert (a.tick, a.modality, a.request_id, a.step, a.want_cond,
                a.want_uncond, a.guided) == (b.tick, b.modality,
                                             b.request_id, b.step,
                                             b.want_cond, b.want_uncond,
                                             b.guided)
        assert abs(a.metric - b.metric) <= 1e-5
    ts, js = tlog.summary(), jlog.summary()
    assert abs(ts.pop("metric_mean") - js.pop("metric_mean")) <= 1e-5
    assert ts == js
    assert sorted(tlog.probes) == sorted(jlog.probes) == [0, 2, 4]
    for rid, p in tlog.probes.items():
        q = jlog.probes[rid]
        assert p["label"] == q["label"] and p["steps"] == q["steps"]
        assert p["tvals"] == q["tvals"]
        np.testing.assert_allclose(np.stack(p["xs"]), np.stack(q["xs"]),
                                   atol=1e-4, rtol=1e-3)
    assert [r.record.computed_steps for r in tres] == \
        [r.record.computed_steps for r in jres]
    assert tlog.by_request(1) and all(e.guided for e in tlog.by_request(1))


def test_probe_training_set_matches_jax(setup, traced):
    """The teacher pairs of the two logs: the same trajectories, inputs at
    the served tolerance and exact outputs within 1e-4 abs / 1e-3 rel."""
    jcfg, tcfg, jp, tp = setup
    jlog, tlog, *_ = traced
    jpairs = jctl.probe_training_set(jp, jcfg, jlog)
    tpairs = tctl.probe_training_set(tp, tcfg, tlog)
    assert len(tpairs) == len(jpairs) == 3
    for (ti, to), (ji, jo) in zip(tpairs, jpairs):
        assert tuple(ti.shape) == tuple(ji.shape)
        assert not to.requires_grad
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                   rtol=1e-3)
    short = tctl.probe_training_set(tp, tcfg, tlog, min_steps=NUM_STEPS + 1)
    assert short == []


# ----------------------------------------------------------------------
# OnlineTuner, ControlPlane
# ----------------------------------------------------------------------

MENU = [("none", {}), ("fora", {"interval": 2})]
SWAP_TICK = 3


def _tuner_requests(cls, n=6):
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5) for i in range(n)]


def _forced(tuner, requests, pick_of):
    """Submit, tick to SWAP_TICK, force the swap onto the swept FORA point,
    drain."""
    tuner.submit_all(requests)
    for _ in range(SWAP_TICK):
        tuner.tick()
    pick = pick_of(tuner)
    assert tuner.maybe_retune(force_to=pick) is pick
    return tuner.drain()


@pytest.fixture(scope="module")
def tuned(setup):
    jcfg, tcfg, jp, tp = setup
    fora = lambda t: next(s for s in t.swept  # noqa: E731
                          if s.policy_name == "fora")
    jt = jctl.OnlineTuner(jp, jcfg, JaxSLA(min_psnr=-100.0), slots=2,
                          max_steps=NUM_STEPS, candidates=MENU,
                          retune_every=0, initial=("none", {}))
    tt = tctl.OnlineTuner(tp, tcfg, SLA(min_psnr=-100.0), slots=2,
                          max_steps=NUM_STEPS, candidates=MENU,
                          retune_every=0, initial=("none", {}),
                          engine_kw={"noise_fn": _jax_noise(tcfg)})
    jres = _forced(jt, _tuner_requests(JaxRequest), fora)
    tres = _forced(tt, _tuner_requests(DiffusionRequest), fora)
    return jt, tt, jres, tres


def test_forced_swap_matches_jax(tuned):
    """A forced blue/green swap at tick 3: the same per-request computed
    steps and admit ticks, x0 within 1e-4 abs / 1e-3 rel; requests
    admitted before the swap keep the policy that admitted them, the
    backlog moves to the new one."""
    jt, tt, jres, tres = tuned
    assert [r.request_id for r in tres] == [r.request_id for r in jres] \
        == list(range(6))
    fora = make_policy("fora", interval=2)
    for a, b in zip(tres, jres):
        assert a.record.computed_steps == b.record.computed_steps
        assert a.record.admit_tick == b.record.admit_tick
        np.testing.assert_allclose(a.x0, b.x0, atol=1e-4, rtol=1e-3)
        n = a.record.num_steps
        before = a.request_id < 2            # 2 slots filled at tick 0
        want = n if before else sum(fora.static_schedule(n))
        assert a.record.computed_steps == want, a.request_id
    assert len(tt.swaps) == len(jt.swaps) == 1
    assert tt.swaps[0]["from"] == jt.swaps[0]["from"]
    assert tt.swaps[0]["to"] == jt.swaps[0]["to"]
    assert tt.swaps[0]["tick"] == jt.swaps[0]["tick"] == SWAP_TICK
    ts, js = tt.summary(), jt.summary()
    for k in ("policy", "policy_kwargs", "swaps", "ticks",
              "draining_sessions", "requests_completed"):
        assert ts[k] == js[k], k
    # one engine per tuned point, each released by its finished session
    engines = [e for es in tt._engines.values() for e in es]
    assert len(engines) == 2 and not any(e._session_active for e in engines)


def test_tuner_reuses_a_released_engine_and_publishes(tuned, setup):
    """After the drain a second forced swap back to `none` reuses the
    engine that served it; registry counters and the control.swap event
    are published."""
    from repro_torch.obs import MetricsRegistry
    _, tt, _, _ = tuned
    _, tcfg, _, tp = setup
    reg = MetricsRegistry()
    t2 = tctl.OnlineTuner(tp, tcfg, SLA(min_psnr=-100.0), slots=2,
                          max_steps=NUM_STEPS, candidates=MENU,
                          retune_every=0, initial=("none", {}),
                          registry=reg)
    first = t2.active.engine
    t2.submit_all(_tuner_requests(DiffusionRequest, 3))
    t2.tick()
    fora = next(s for s in t2.swept if s.policy_name == "fora")
    t2.maybe_retune(force_to=fora)
    t2.drain()
    t2.maybe_retune(force_to=next(s for s in t2.swept
                                  if s.policy_name == "none"))
    assert t2.active.engine is first
    snap = reg.snapshot()
    assert any(e["event"] == "control.swap" for e in snap["events"])
    assert "repro_control_swaps_total" in reg.prometheus_text()


def test_prewarm_warms_an_engine_per_candidate(tuned):
    """prewarm: one free engine per swept point, each warmed (its program
    profiles filled), reusing the engines the drained sessions released."""
    _, tt, _, _ = tuned
    before = {k: list(v) for k, v in tt._engines.items()}
    tt.prewarm()
    assert set(tt._engines) == {_policy_key(t) for t in tt.swept}
    for key, engines in tt._engines.items():
        assert engines == before.get(key, engines)
        assert all(e.program_profile and not e._session_active
                   for e in engines)


def test_priced_pick_matches_jax(tuned):
    """The same sweep (JAX's, in both packages) priced against the same
    window: the same pick and estimated latency."""
    jt, _, _, _ = tuned
    swept_t = [TunedPolicy(t.policy_name, dict(t.kwargs), psnr=t.psnr,
                           compute_fraction=t.compute_fraction,
                           cond_compute_fraction=t.cond_compute_fraction,
                           uncond_compute_fraction=t.uncond_compute_fraction,
                           static_plan=t.static_plan) for t in jt.swept]
    jw = jctl.TelemetryWindow()
    tw = tctl.TelemetryWindow()
    for je, te in zip(_events(JaxTickEvent, JaxRecord),
                      _events(TickEvent, RequestRecord)):
        jw.observe(je)
        tw.observe(te)
    for sla_psnr in (-100.0, 1e9):
        jp = jax_price(jt.swept, JaxSLA(min_psnr=sla_psnr),
                       num_steps=NUM_STEPS, row_time_ms=jw.row_time_ms(),
                       occupancy=jw.occupancy(), plan_ms=jw.plan_time_ms())
        tp = price_and_pick(swept_t, SLA(min_psnr=sla_psnr),
                            num_steps=NUM_STEPS,
                            row_time_ms=tw.row_time_ms(),
                            occupancy=tw.occupancy(),
                            plan_ms=tw.plan_time_ms())
        assert (tp.policy_name, tp.feasible) == (jp.policy_name,
                                                 jp.feasible)
        assert tp.est_latency_ms == pytest.approx(jp.est_latency_ms,
                                                  rel=1e-12)


def test_policy_key_is_stable_across_devices_and_sizes():
    """A tuned point whose kwargs hold a gate keys by the gate's values:
    equal gates key equal, a gate that differs past repr's elision keys
    apart, and the key holds no device."""
    w = torch.arange(2000, dtype=torch.float32) * 1e-3
    a = TunedPolicy("lazydit", {"gate": {"w": w, "b": torch.zeros(())},
                                "threshold": 0.5})
    b = TunedPolicy("lazydit", {"gate": {"w": w.clone(),
                                         "b": torch.zeros(())},
                                "threshold": 0.5})
    w2 = w.clone()
    w2[1500] += 1.0
    c = TunedPolicy("lazydit", {"gate": {"w": w2, "b": torch.zeros(())},
                                "threshold": 0.5})
    assert _policy_key(a) == _policy_key(b) != _policy_key(c)
    assert "cpu" not in repr(_policy_key(a))
    assert _policy_key(TunedPolicy("fora", {"interval": 2})) != \
        _policy_key(TunedPolicy("fora", {"interval": 4}))


def test_control_plane_routes_by_modality(tuned, setup):
    """ControlPlane: JAX's errors for no tuner and an unknown modality;
    the image tuner serves its requests, in submission order."""
    _, tt, _, _ = tuned
    with pytest.raises(ValueError, match="at least one tuner"):
        tctl.ControlPlane({})
    plane = tctl.ControlPlane({"image": tt})
    with pytest.raises(KeyError, match="no tuner for modality 'video'"):
        plane.submit(DiffusionRequest(50, num_steps=4, modality="video"))
    plane.submit_all([DiffusionRequest(60 + i, num_steps=4, seed=i)
                      for i in range(3)])
    res = plane.drain()
    assert [r.request_id for r in res] == [60, 61, 62]
    assert set(plane.summary()) == {"image"}
