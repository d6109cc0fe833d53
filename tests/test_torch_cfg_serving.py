"""Guided serving in the port against the JAX package, on the CPU:
FasterCacheCFG (both modes, scalar and per slot), CachedDenoiser and
cfg_denoise_fn with a negative-prompt vector, the serving engine under
FasterCacheCFG (compacted and dense), the session API (TickEvent hooks,
submit, transfer_queued, captured latents, the metrics registry) and the
two repairs of the port (the static-plan probe catches any exception; the
TeaCache signal is computed only for a policy that reads it).

Both packages get the same bridged weights at the SMALL DiT and the same
inputs (numpy seeds; the JAX engine's own initial noise is injected into
the port).  Cache decisions and row counts must agree exactly; policy
trajectories within 1e-5, denoiser outputs within 1e-3, served x0 within
1e-4 abs / 1e-3 rel (f32 sums in another order over 8 DDIM steps that
scale x0 up)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FasterCacheCFG as JaxFasterCacheCFG  # noqa: E402
from repro.core import FixedIntervalPolicy as JaxFixedInterval  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.diffusion import CachedDenoiser as JaxCachedDenoiser  # noqa: E402
from repro.diffusion import ddim_step as jax_ddim_step  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear_schedule  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro.diffusion.pipeline import \
    cfg_denoise_fn as jax_cfg_denoise_fn  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.obs import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (FasterCacheCFG, FixedIntervalPolicy,  # noqa: E402
                              SlotWant, interval_pred, make_policy)
from repro_torch.diffusion import (CachedDenoiser, ddim_step,  # noqa: E402
                                   linear_schedule, sample)
from repro_torch.diffusion.pipeline import cfg_denoise_fn  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving.diffusion import (DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine, TickEvent)
from repro_torch.serving.diffusion.autotune import \
    _plans_on_host  # noqa: E402

NUM_STEPS = 8
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)
MODES = ["extrapolate", "lowfreq"]
TEACACHE_DELTA = 0.5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    vec = np.random.default_rng(3).standard_normal(
        (jcfg.d_model,)).astype(np.float32)
    return jcfg, tcfg, jp, tp, vec


def _requests(cls, vec, n=5):
    """Budgets 8 and 6 alternating; requests 0, 1 and 3 guided (so both
    budgets are), request 3 with a negative-prompt vector; 5 requests
    through 2 slots, so slots are refilled."""
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5,
                cfg_scale=2.5 if i in (0, 1, 3) else 0.0,
                null_label=vec if i == 3 else None)
            for i in range(n)]


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


def _engines(setup, policy, cfg_mode, slots=2, **kw):
    """(JAX engine, port engine) under `policy` and FasterCacheCFG(3)."""
    jcfg, tcfg, jp, tp, _ = setup
    jcp = (None if cfg_mode is None
           else JaxFasterCacheCFG(3, NUM_STEPS, mode=cfg_mode))
    tcp = None if cfg_mode is None else FasterCacheCFG(3, NUM_STEPS,
                                                       mode=cfg_mode)
    jpol, tpol = policy, policy
    if policy == "teacache":
        jpol = jax_make_policy("teacache", delta=TEACACHE_DELTA)
        tpol = make_policy("teacache", delta=TEACACHE_DELTA)
    jeng = JaxEngine(jp, jcfg, jpol, slots=slots, max_steps=NUM_STEPS,
                     cfg_policy=jcp)
    teng = DiffusionServingEngine(tp, tcfg, tpol, slots=slots,
                                  max_steps=NUM_STEPS, cfg_policy=tcp,
                                  noise_fn=_jax_noise(tcfg), device="cpu",
                                  **kw)
    return jeng, teng


def _check_margins(jeng):
    """Wrap the JAX engine's plan: every thresholded TeaCache decision of
    an active slot lies at least 1e-4 relative from delta."""
    plan, margins = jeng._plan_all, []

    def checked(states, steps, xs, tvals):
        wc, wu, metric = plan(states, steps, xs, tvals)
        if metric is not None:
            n = np.asarray(states["policy"]["n"])
            margins.extend(abs(float(metric[s]) - TEACACHE_DELTA)
                           / TEACACHE_DELTA
                           for s in range(len(n)) if n[s] > 0)
        return wc, wu, metric

    jeng._plan_all = checked
    return margins


def _assert_same_serving(tres, jres, ts, js):
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert a.record.computed_steps == b.record.computed_steps, a.request_id
        assert (a.record.uncond_computed_steps
                == b.record.uncond_computed_steps), a.request_id
        assert a.record.admit_tick == b.record.admit_tick
        assert a.record.finish_tick == b.record.finish_tick
        assert np.isfinite(a.x0).all()
        np.testing.assert_allclose(a.x0, b.x0, atol=1e-4, rtol=1e-3)
    for f in ("backbone_rows_computed", "backbone_rows_padding",
              "backbone_rows_saved", "uncond_rows_computed",
              "uncond_rows_saved", "ticks_full", "ticks_cond", "ticks_skip",
              "cache_state_bytes_per_slot"):
        assert getattr(ts, f) == getattr(js, f), f


# ----------------------------------------------------------------------
# FasterCacheCFG
# ----------------------------------------------------------------------

def _fc_inputs(S=3, T=8, D=4, steps=9):
    rng = np.random.default_rng(5)
    ys = rng.standard_normal((steps, S, T, D)).astype(np.float32)
    conds = rng.standard_normal((steps, S, T, D)).astype(np.float32)
    return ys, conds


@pytest.mark.parametrize("mode", MODES)
def test_fastercache_cfg_trajectory_matches_jax(mode):
    """The scalar apply over a 9-step trajectory (interval 3): every
    step's output and the final state within 1e-5."""
    ys, conds = _fc_inputs()
    jpol = JaxFasterCacheCFG(3, 9, mode=mode)
    tpol = FasterCacheCFG(3, 9, mode=mode)
    shape = ys.shape[1:]
    jst = jpol.init_state(shape)
    tst = tpol.init_state(shape, device="cpu")
    for i in range(ys.shape[0]):
        x = jnp.zeros(shape)
        jy, jst = jpol.apply(jst, i, x, lambda _, i=i: jnp.asarray(ys[i]),
                             cond_out=jnp.asarray(conds[i]))
        ty, tst = tpol.apply(tst, i, torch.zeros(shape),
                             lambda _, i=i: torch.from_numpy(ys[i]),
                             cond_out=torch.from_numpy(conds[i]))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
    for k in jst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_fastercache_cfg_slots_match_jax(mode):
    """apply_slots over 3 slots at different steps with their own blend
    weights cfg_w, against JAX's apply per slot (what JAX's vmap runs),
    over 9 ticks, within 1e-5."""
    ys, conds = _fc_inputs()
    S = ys.shape[1]
    jpol = JaxFasterCacheCFG(3, 16, mode=mode)
    tpol = FasterCacheCFG(3, 16, mode=mode)
    one = ys.shape[2:]
    jst = [jpol.init_state((1,) + one) for _ in range(S)]
    tst = {k: torch.stack([v] * S)
           for k, v in tpol.init_state(one, device="cpu").items()}
    offsets, budgets = np.array([0, 1, 4]), np.array([16, 8, 12])
    for i in range(ys.shape[0]):
        steps = (offsets + i).astype(np.int32)
        cfg_w = (steps / np.maximum(budgets - 1, 1)).astype(np.float32)
        ty, tst = tpol.apply_slots(
            tst, steps, torch.zeros((S,) + one), torch.from_numpy(ys[i]),
            cfg_w=torch.from_numpy(cfg_w), cond_out=torch.from_numpy(conds[i]))
        for s in range(S):
            jy, jst[s] = jpol.apply(
                jst[s], int(steps[s]), jnp.zeros((1,) + one),
                lambda _, i=i, s=s: jnp.asarray(ys[i, s][None]),
                cfg_w=cfg_w[s], cond_out=jnp.asarray(conds[i, s][None]))
            np.testing.assert_allclose(ty[s].numpy(), np.asarray(jy)[0],
                                       atol=1e-5, rtol=1e-5)
    for k in tst:
        for s in range(S):
            np.testing.assert_allclose(tst[k][s].numpy(),
                                       np.asarray(jst[s][k])[0],
                                       atol=1e-5, rtol=1e-5)


def test_fastercache_cfg_registry_and_plan():
    pol = make_policy("fastercache_cfg")
    jpol = jax_make_policy("fastercache_cfg")
    for attr in ("interval", "num_steps", "mode", "cutoff"):
        assert getattr(pol, attr) == getattr(jpol, attr)
    assert pol.static_schedule(10) == jpol.static_schedule(10)
    steps = np.array([0, 1, 4, 7, 8])
    np.testing.assert_array_equal(pol.step_want(steps), steps % 4 == 0)
    assert _plans_on_host(pol, 16)
    with pytest.raises(ValueError, match="cond_out"):
        FasterCacheCFG(2, 8, mode="lowfreq").apply(
            {"delta_low": torch.zeros(2)}, 1, torch.zeros(2), lambda x: x)


# ----------------------------------------------------------------------
# CachedDenoiser and cfg_denoise_fn
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_cached_denoiser_cfg_policy_matches_jax(setup, mode):
    """8 DDIM steps of CachedDenoiser(taylorseer, cfg_scale 3,
    FasterCacheCFG(3), null_embed=vector) within 1e-3, and the same
    computes on both branches."""
    jcfg, tcfg, jp, tp, vec = setup
    x_T = np.random.default_rng(2).standard_normal(
        (2, jcfg.dit_tokens, jcfg.dit_in_dim)).astype(np.float32)
    sched = jax_linear_schedule(1000)
    ts = sched.spaced(NUM_STEPS)
    jden = JaxCachedDenoiser(jp, jcfg, jax_make_policy("taylorseer"),
                             cfg_scale=3.0,
                             cfg_policy=JaxFasterCacheCFG(3, NUM_STEPS,
                                                          mode=mode),
                             class_label=4, null_embed=vec)
    jx0, jst = jax_sample(jden, jnp.asarray(x_T), ts, sched,
                          step_fn=jax_ddim_step,
                          denoiser_state=jden.init_state(2))
    den = CachedDenoiser(tp, tcfg, make_policy("taylorseer"), cfg_scale=3.0,
                         cfg_policy=FasterCacheCFG(3, NUM_STEPS, mode=mode),
                         class_label=4, null_embed=vec, device="cpu")
    x0, st = sample(den, torch.from_numpy(x_T), ts, linear_schedule(1000),
                    step_fn=ddim_step, denoiser_state=den.init_state(2))
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=1e-3,
                               rtol=1e-3)
    assert set(st) == set(jst) == {"policy", "cfg"}
    assert int(st["policy"]["n_valid"]) == int(jst["policy"]["n_valid"])
    for k in st["cfg"]:
        np.testing.assert_allclose(st["cfg"][k].numpy(),
                                   np.asarray(jst["cfg"][k]), atol=1e-3,
                                   rtol=1e-3)


def test_cfg_denoise_fn_null_embed_matches_jax(setup):
    """The exact guided denoiser with a negative-prompt vector, within
    1e-3, and different from the null class."""
    jcfg, tcfg, jp, tp, vec = setup
    x_T = np.random.default_rng(4).standard_normal(
        (2, jcfg.dit_tokens, jcfg.dit_in_dim)).astype(np.float32)
    sched = jax_linear_schedule(1000)
    ts = sched.spaced(NUM_STEPS)
    jx0, _ = jax_sample(jax_cfg_denoise_fn(jp, jcfg, 3.0, 2, null_embed=vec),
                        jnp.asarray(x_T), ts, sched, step_fn=jax_ddim_step)
    x0, _ = sample(cfg_denoise_fn(tp, tcfg, 3.0, 2, null_embed=vec),
                   torch.from_numpy(x_T), ts, linear_schedule(1000),
                   step_fn=ddim_step)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=1e-3,
                               rtol=1e-3)
    x0_class, _ = sample(cfg_denoise_fn(tp, tcfg, 3.0, 2),
                         torch.from_numpy(x_T), ts, linear_schedule(1000),
                         step_fn=ddim_step)
    assert float((x0 - x0_class).abs().max()) > 1e-3


def test_cached_denoiser_signal_only_for_signal_policies(setup):
    """Repair: TeaCache's signal (the patch embed and first-block AdaLN) is
    computed on no step of a policy that does not read it, and on every
    step of TeaCache."""
    _, tcfg, _, tp, _ = setup
    x_T = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, tcfg.dit_tokens, tcfg.dit_in_dim)).astype(np.float32))
    sched = linear_schedule(1000)
    for name, want in (("taylorseer", 0), ("fora", 0),
                       ("teacache", NUM_STEPS)):
        den = CachedDenoiser(tp, tcfg, make_policy(name), device="cpu")
        calls, signal = [], den._signal
        den._signal = lambda *a: calls.append(1) or signal(*a)
        sample(den, x_T, sched.spaced(NUM_STEPS), sched, step_fn=ddim_step,
               denoiser_state=den.init_state(1))
        assert len(calls) == want, name


# ----------------------------------------------------------------------
# the engine under FasterCacheCFG
# ----------------------------------------------------------------------

@pytest.mark.parametrize("policy,mode", [("taylorseer", "extrapolate"),
                                         ("fora", "lowfreq"),
                                         ("teacache", "extrapolate")])
def test_cfg_serving_matches_jax_engine(setup, policy, mode):
    """Mixed budgets, guided and unguided slots, one vector null, refills:
    exact computed and uncond steps, admit/finish ticks and row counters;
    x0 within 1e-4 abs / 1e-3 rel.  The plan reads the device once a tick
    under TeaCache (the uncond branch from its host table) and never under
    two static branches."""
    vec = setup[4]
    jeng, teng = _engines(setup, policy, mode)
    margins = _check_margins(jeng)
    jres = jeng.serve(_requests(JaxRequest, vec))
    calls, want_all = [], teng._want_all
    teng._want_all = lambda *a: calls.append(1) or want_all(*a)
    tres = teng.serve(_requests(DiffusionRequest, vec))
    _assert_same_serving(tres, jres, teng.telemetry, jeng.telemetry)
    assert teng.align == jeng.align
    assert teng.telemetry.uncond_rows_saved > 0
    assert teng.telemetry.ticks_cond > 0
    if policy == "teacache":
        assert min(margins) >= 1e-4, margins
        assert len(calls) == teng.telemetry.summary()["ticks"]
    else:
        assert calls == []


def test_negative_prompt_vector_reaches_uncond_rows(setup):
    """Request 3 served with its vector differs from it served with the
    class null; unguided requests are unchanged."""
    _, tcfg, _, tp, vec = setup
    out = {}
    for null in (vec, None):
        reqs = [DiffusionRequest(i, NUM_STEPS, seed=i, class_label=i,
                                 cfg_scale=2.5 if i == 0 else 0.0,
                                 null_label=null if i == 0 else None)
                for i in range(2)]
        eng = DiffusionServingEngine(tp, tcfg, "taylorseer", slots=2,
                                     max_steps=NUM_STEPS,
                                     cfg_policy="fastercache_cfg",
                                     noise_fn=_jax_noise(tcfg), device="cpu")
        out[null is None] = eng.serve(reqs)
    assert float(np.abs(out[False][0].x0 - out[True][0].x0).max()) > 1e-3
    np.testing.assert_array_equal(out[False][1].x0, out[True][1].x0)
    with pytest.raises(ValueError, match="d_model"):
        eng.serve([DiffusionRequest(0, 4, cfg_scale=2.0,
                                    null_label=np.zeros(3, np.float32))])


@pytest.mark.parametrize("policy,mode", [("taylorseer", "extrapolate"),
                                         ("teacache", "lowfreq"),
                                         ("fora", None)])
def test_dense_engine_matches_compacted(setup, policy, mode):
    """row_compaction=False (whole-pool full / cond / skip ticks): the same
    computed and uncond steps and tick kinds as the compacted engine, x0
    within 5e-4 abs / 1e-3 rel (JAX's bound for the same comparison)."""
    vec = setup[4]
    out = {}
    for compact in (True, False):
        _, teng = _engines(setup, policy, mode, row_compaction=compact)
        if not compact:
            assert teng.warmup() == ["full", "cond", "skip"]
        out[compact] = teng.serve(_requests(DiffusionRequest, vec)), \
            teng.telemetry
    (cres, ctel), (dres, dtel) = out[True], out[False]
    for a, b in zip(cres, dres):
        assert a.record.computed_steps == b.record.computed_steps
        assert a.record.uncond_computed_steps == b.record.uncond_computed_steps
        np.testing.assert_allclose(a.x0, b.x0, atol=5e-4, rtol=1e-3)
    for f in ("ticks_full", "ticks_cond", "ticks_skip",
              "uncond_rows_computed", "uncond_rows_saved"):
        assert getattr(ctel, f) == getattr(dtel, f), f
    S = 2
    assert dtel.backbone_rows_computed == (2 * S * dtel.ticks_full
                                           + S * dtel.ticks_cond)
    assert dtel.backbone_rows_padding == dtel.backbone_rows_saved == 0


def test_refill_resets_both_branches(setup):
    """A guided request served after another through one slot equals it
    served alone: refill resets the cond and the CFG cache."""
    _, tcfg, _, tp, vec = setup
    reqs = [DiffusionRequest(i, NUM_STEPS, seed=i, class_label=i,
                             cfg_scale=2.5, null_label=vec if i else None)
            for i in range(2)]
    eng = DiffusionServingEngine(tp, tcfg, "taylorseer", slots=1,
                                 max_steps=NUM_STEPS,
                                 cfg_policy=FasterCacheCFG(3, NUM_STEPS),
                                 noise_fn=_jax_noise(tcfg), device="cpu")
    both = eng.serve(reqs)
    alone = eng.serve(reqs[1:])
    assert both[1].record.uncond_computed_steps == \
        alone[0].record.uncond_computed_steps
    np.testing.assert_array_equal(both[1].x0, alone[0].x0)


# ----------------------------------------------------------------------
# the session API
# ----------------------------------------------------------------------

EVENT_ARRAYS = ("active", "request_ids", "steps", "tvals", "labels",
                "guided", "want_cond", "want_uncond")


@pytest.mark.parametrize("policy", ["taylorseer", "teacache"])
def test_tick_events_match_jax(setup, policy):
    """Every TickEvent field against JAX's over the same run: kinds, rows,
    per-slot arrays, admissions, finishes, the device metric (None when
    planned from host tables), the captured pre-tick latents."""
    vec = setup[4]
    jeng, teng = _engines(setup, policy, "extrapolate")
    jev, tev = [], []
    jeng.serve(_requests(JaxRequest, vec), hooks=[jev.append],
               capture_latents=True)
    teng.serve(_requests(DiffusionRequest, vec), hooks=[tev.append],
               capture_latents=True)
    assert len(tev) == len(jev) > 0
    for a, b in zip(tev, jev):
        assert isinstance(a, TickEvent)
        for f in ("tick", "modality", "kind", "rows_computed",
                  "rows_padding"):
            assert getattr(a, f) == getattr(b, f), (a.tick, f)
        for f in EVENT_ARRAYS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"tick {a.tick} {f}")
        assert [r.request_id for r in a.admitted] == \
            [r.request_id for r in b.admitted]
        assert [r.request_id for r in a.finished] == \
            [r.request_id for r in b.finished]
        assert (a.metric is None) == (b.metric is None) == \
            (policy == "taylorseer")
        if a.metric is not None:
            np.testing.assert_allclose(a.metric, b.metric, rtol=1e-4,
                                       atol=1e-6)
        np.testing.assert_allclose(a.latents, b.latents, atol=1e-4,
                                   rtol=1e-3)
        assert a.seconds > 0 and a.plan_seconds >= 0


def test_submit_and_transfer_queued_match_jax(setup):
    """Mid-session submit, then transfer_queued of the backlog into a
    second session: the same moved requests, ticks and results as JAX."""
    vec = setup[4]
    out = {}
    for eng, cls in zip(_engines(setup, "taylorseer", "extrapolate"),
                        (JaxRequest, DiffusionRequest)):
        reqs = _requests(cls, vec)
        session = eng.start_session(reqs[:2])
        session.tick()
        for r in reqs[2:]:
            session.submit(r)
        with pytest.raises(ValueError, match="already submitted"):
            session.submit(reqs[2])
        session.tick()
        moved = session.transfer_queued()
        while not session.done:
            session.tick()
        first = session.finish()
        with pytest.raises(RuntimeError):
            session.submit(reqs[0])
        second = eng.serve(moved)
        out[cls] = ([r.request_id for r in moved], first + second,
                    session.ticks)
    (jm, jres, jt), (tm, tres, tt) = out[JaxRequest], out[DiffusionRequest]
    assert tm == jm and len(tm) > 0 and tt == jt
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert a.record.computed_steps == b.record.computed_steps
        assert a.record.uncond_computed_steps == b.record.uncond_computed_steps
        np.testing.assert_allclose(a.x0, b.x0, atol=1e-4, rtol=1e-3)


def _values(reg, name):
    inst = reg._instruments[name]
    return {k: (v if not isinstance(v, list) else v[2])
            for k, v in inst.values.items()}


def test_metrics_registry_matches_jax(setup):
    """The same traffic publishes the same repro_engine_* and
    repro_scheduler_* counters, gauges and histogram counts as JAX (time
    sums excepted), preempted requests included; the registry's ticks and
    rows agree with the telemetry."""
    vec = setup[4]
    jeng, teng = _engines(setup, "fora", "lowfreq")
    jreg, treg = JaxMetricsRegistry(), MetricsRegistry()
    jeng.serve(_requests(JaxRequest, vec), metrics=jreg, max_ticks=14)
    teng.serve(_requests(DiffusionRequest, vec), metrics=treg, max_ticks=14)
    assert sorted(treg._instruments) == sorted(jreg._instruments)
    for name in treg._instruments:
        if name.endswith("seconds_total"):
            assert (set(_values(treg, name)) == set(_values(jreg, name)))
            continue
        assert _values(treg, name) == _values(jreg, name), name
    tel = teng.telemetry
    ticks = sum(_values(treg, "repro_engine_ticks_total").values())
    assert ticks == tel.summary()["ticks"] == 14
    assert (sum(_values(treg, "repro_engine_rows_computed_total").values())
            == tel.backbone_rows_computed)
    assert tel.requests_preempted > 0
    assert "repro_engine_requests_preempted_total" in treg.prometheus_text()


# ----------------------------------------------------------------------
# the static-plan probe (repair)
# ----------------------------------------------------------------------

class _StateGated(FixedIntervalPolicy):
    """FORA whose want_compute needs its state: it raises RuntimeError on
    the probe's None state, and decides on the device from the step."""

    def want_compute(self, state, step, x=None, **signals):
        if state is None:
            raise RuntimeError("decides from its state")
        return interval_pred(step, self.interval)

    def want_slots(self, states, steps, xs, signal=None):
        want = torch.as_tensor(interval_pred(np.asarray(steps),
                                             self.interval))
        z = torch.zeros(want.shape)
        return SlotWant(want, z, z, z, torch.zeros_like(want))


class _JaxStateGated(JaxFixedInterval):
    def want_compute(self, state, step, x=None, **signals):
        if state is None:
            raise RuntimeError("decides from its state")
        return super().want_compute(state, step, x, **signals)


def test_probe_falls_back_to_the_device_plan(setup):
    """Repair: a policy whose want_compute(None, s, None) raises anything
    (here RuntimeError) builds an engine that plans on the device, as
    JAX's does, and serves FORA's schedule through it."""
    jcfg, tcfg, jp, tp, vec = setup
    jeng = JaxEngine(jp, jcfg, _JaxStateGated(2), slots=2,
                     max_steps=NUM_STEPS)
    teng = DiffusionServingEngine(tp, tcfg, _StateGated(2), slots=2,
                                  max_steps=NUM_STEPS,
                                  noise_fn=_jax_noise(tcfg), device="cpu")
    assert jeng._static_plan is None and teng._static_plan is None
    assert not _plans_on_host(_StateGated(2), NUM_STEPS)
    res = teng.serve(_requests(DiffusionRequest, vec))
    ref = DiffusionServingEngine(tp, tcfg, "fora", slots=2,
                                 max_steps=NUM_STEPS,
                                 noise_fn=_jax_noise(tcfg),
                                 device="cpu").serve(
        _requests(DiffusionRequest, vec))
    for a, b in zip(res, ref):
        assert a.record.computed_steps == b.record.computed_steps
        np.testing.assert_array_equal(a.x0, b.x0)
