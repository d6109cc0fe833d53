"""The port's serving engine under the state-dependent, token-wise and
frequency policies against the JAX engine, on the CPU.

Both engines serve the same requests (guided and unguided, budgets 8 and
6) at the SMALL DiT with the same bridged weights, 2 slots, and the JAX
engine's own initial noise injected into the port.  TeaCache, MagCache,
EasyCache, Foresight and LazyDiT are planned by the device want pass (one
read a tick); ToCa, FoCa and FreqCa from the host table.

Cache decisions must agree exactly (per-request computed steps, admit and
finish ticks, every row and tick counter, cache bytes per slot); x0 within
1e-4 abs / 1e-3 rel (f32 sums in another order over 8 DDIM steps).  Each
exact comparison of a thresholded decision is first made well posed: at
every tick the JAX engine plans, each active slot's thresholded value must
lie at least 1e-4 relative from its threshold (`_margins`, printed).  The
thresholds in THRESHOLDS were chosen so that the slots diverge (some ticks
compute fewer rows than there are active slots) with that margin on these
weights and this noise; a draw that lost it would fail, not be re-seeded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.core import metrics as jm  # noqa: E402
from repro.core.learned import init_gate as jax_init_gate  # noqa: E402
from repro.diffusion import CachedDenoiser as JaxCachedDenoiser  # noqa: E402
from repro.diffusion import ddim_step as jax_ddim_step  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear_schedule  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro.diffusion.pipeline import backbone_fns as jax_backbone_fns  # noqa: E402
from repro.diffusion.pipeline import slot_want_fns as jax_slot_want_fns  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.diffusion import (CachedDenoiser, ddim_step,  # noqa: E402
                                   linear_schedule, sample)
from repro_torch.diffusion.pipeline import slot_want_fns  # noqa: E402
from repro_torch.serving.diffusion import (DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine)

NUM_STEPS = 8
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)
GATED = ["teacache", "magcache", "easycache", "foresight", "lazydit"]
# thresholds for these weights and this noise (see the module docstring)
THRESHOLDS = {"teacache": {"delta": 0.5}, "magcache": {"delta": 0.05},
              "easycache": {"tau": 5.0}, "foresight": {"gamma": 1.0},
              "lazydit": {"threshold": 0.3}}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _gate(cfg):
    """A LazyDiT gate over the latent's features (what the engine's per-slot
    x is), from JAX's init_gate, scaled so that its score moves with the
    latents."""
    g = jax_init_gate(jax.random.PRNGKey(7), cfg.dit_in_dim)
    return {"w": g["w"] * 1.0, "b": g["b"]}


def _policies(name, jcfg):
    kw = dict(THRESHOLDS.get(name, {}), num_steps=NUM_STEPS)
    tkw = dict(kw)
    if name == "lazydit":
        kw["gate"] = _gate(jcfg)
        tkw["gate"] = {k: torch.from_numpy(np.array(v))
                       for k, v in kw["gate"].items()}
    return jax_make_policy(name, **kw), make_policy(name, **tkw)


def _requests(cls, n=5):
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5, cfg_scale=2.5 if i % 2 == 0 else 0.0)
            for i in range(n)]


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


def _gate_value(name, pol, state, metric, x):
    """(forced, value, threshold) of one JAX slot's decision."""
    st = {k: np.asarray(v) for k, v in state.items()}
    if name in ("teacache", "magcache"):
        return st["n"] == 0, metric, pol.delta
    if name == "lazydit":
        return st["n"] == 0, metric, pol.threshold
    if name == "easycache":
        xf = np.asarray(x, np.float32)
        dx = np.linalg.norm((xf - st["prev_x"]).ravel())
        vn = np.linalg.norm(st["prev_v"].ravel()) + 1e-8
        return (st["n"] < pol.warmup,
                float(st["acc"] + st["k"] * dx / vn * 100.0), pol.tau)
    d = float(jm.rel_l1_block(jnp.asarray(x), state["prev_in"]))
    return st["n"] < pol.warmup, d, pol.gamma * float(st["lam"])


def _margins(name, pol, states, xs, metric, active):
    """Each active slot's relative distance from its threshold (forced
    decisions excluded); asserts every one is at least 1e-4."""
    out = []
    for s in np.nonzero(active)[0]:
        st = jax.tree_util.tree_map(lambda a, s=s: a[s], states["policy"])
        forced, v, thr = _gate_value(name, pol, st, float(metric[s]),
                                     xs[s][None])
        if not forced:
            out.append(abs(v - thr) / max(abs(thr), 1e-12))
    assert all(m >= 1e-4 for m in out), (name, out)
    return out


def _serve_jax(jeng, reqs, name, pol):
    """Serve through a JAX session, checking every plan's margins."""
    session = jeng.start_session(reqs)
    plan, margins = jeng._plan_all, []

    def checked(states, steps, xs, tvals):
        wc, wu, metric = plan(states, steps, xs, tvals)
        if metric is not None:
            margins.extend(_margins(name, pol, states, np.asarray(xs), metric,
                                    np.asarray(session.sched.active_mask())))
        return wc, wu, metric

    jeng._plan_all = checked
    while not session.done:
        session.tick()
    return session.finish(), margins


@pytest.mark.parametrize("name", GATED + ["toca", "foca", "freqca"])
def test_adaptive_serving_matches_jax_engine(setup, name):
    jcfg, tcfg, jp, tp = setup
    jpol, tpol = _policies(name, jcfg)
    jeng = JaxEngine(jp, jcfg, jpol, slots=2, max_steps=NUM_STEPS)
    jres, margins = _serve_jax(jeng, _requests(JaxRequest), name, jpol)
    teng = DiffusionServingEngine(tp, tcfg, tpol, slots=2,
                                  max_steps=NUM_STEPS,
                                  noise_fn=_jax_noise(tcfg), device="cpu")
    assert (teng._static_plan is None) == (name in GATED)
    tres = teng.serve(_requests(DiffusionRequest))
    if name in GATED:
        print(f"{name}: {len(margins)} decisions, least margin "
              f"{min(margins):.3e} relative")

    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert a.record.computed_steps == b.record.computed_steps, a.request_id
        assert (a.record.uncond_computed_steps
                == b.record.uncond_computed_steps)
        assert a.record.admit_tick == b.record.admit_tick
        assert a.record.finish_tick == b.record.finish_tick
        assert np.isfinite(a.x0).all()
        np.testing.assert_allclose(a.x0, b.x0, atol=1e-4, rtol=1e-3)
    ts, js = teng.telemetry, jeng.telemetry
    for field in ("backbone_rows_computed", "backbone_rows_padding",
                  "backbone_rows_saved", "uncond_rows_computed",
                  "uncond_rows_saved", "ticks_full", "ticks_cond",
                  "ticks_skip", "cache_state_bytes_per_slot"):
        assert getattr(ts, field) == getattr(js, field), field
    if name != "toca":          # ToCa's want is always True
        assert ts.backbone_rows_saved > 0
    if name in GATED:           # a request both reuses and recomputes
        assert any(a.record.computed_steps not in (1, a.record.num_steps)
                   for a in tres)


@pytest.mark.parametrize("name", GATED)
def test_slot_want_fns_match_jax(setup, name):
    """The fused want pass on the same mid-session states: equal want,
    metric within 1e-6 relative, one signal over the slot batch."""
    jcfg, tcfg, jp, tp = setup
    jpol, tpol = _policies(name, jcfg)
    jeng = JaxEngine(jp, jcfg, jpol, slots=2, max_steps=NUM_STEPS)
    session = jeng.start_session(_requests(JaxRequest, n=2))
    for _ in range(3):
        session.tick()
    rows = np.arange(2)
    steps = np.minimum(np.asarray(session.sched.steps(), np.int32),
                       NUM_STEPS - 1)
    tvals = jeng._tv[rows, steps]
    labels, guided = jeng._labels.copy(), jeng._guided.copy()
    jstates, jxs = session.states, session.xs
    jw, ju, jmetric = jax_slot_want_fns(jp, jcfg, jpol)(
        jstates, jnp.asarray(steps), jxs, jnp.asarray(tvals),
        jnp.asarray(labels), jnp.asarray(guided))
    session.finish()
    _margins(name, jpol, jstates, np.asarray(jxs), np.asarray(jmetric),
             np.ones(2, bool))

    def squeeze(a):      # JAX per-slot leaves carry a singleton batch axis
        a = np.array(a)
        return torch.from_numpy(a.reshape(a.shape[:1] + a.shape[2:])
                                if a.ndim >= 4 else a)

    tstates = {"policy": {k: squeeze(v)
                          for k, v in jstates["policy"].items()}, "cfg": {}}
    plan = slot_want_fns(tp, tcfg, tpol)(tstates, steps,
                                         torch.from_numpy(np.array(jxs)),
                                         tvals, labels, guided)
    np.testing.assert_array_equal(plan.want_cond, np.asarray(jw))
    np.testing.assert_array_equal(plan.want_uncond, np.asarray(ju))
    np.testing.assert_allclose(plan.metric, np.asarray(jmetric), rtol=1e-6,
                               atol=0)
    assert (plan.signal is not None) == (name == "teacache")
    if plan.signal is not None:
        assert tuple(plan.signal.shape) == (2, tcfg.dit_tokens, tcfg.d_model)


def test_cached_denoiser_teacache_matches_jax(setup):
    """8 DDIM steps of CachedDenoiser under TeaCache: the same refresh
    steps (n_compute); every step's metric at least 1e-4 relative from
    delta.  x0 within 2e-6 of its largest magnitude, abs: DDIM from t = 999
    scales this random model's x0 up to ~450, and f32 sums in another order
    round at that scale (2e-4 abs on an element of 0.04 here)."""
    jcfg, tcfg, jp, tp = setup
    delta = 0.5
    x_T = np.random.default_rng(2).standard_normal(
        (2, jcfg.dit_tokens, jcfg.dit_in_dim)).astype(np.float32)
    jsched = jax_linear_schedule(1000)
    ts = jsched.spaced(NUM_STEPS)
    jpol = jax_make_policy("teacache", delta=delta)
    jden = JaxCachedDenoiser(jp, jcfg, jpol, granularity="model")
    _, signal_fn = jax_backbone_fns(jp, jcfg)
    margins = []

    def checked(state, i, x, t_vec):
        sig = signal_fn(x, t_vec, jnp.zeros((2,), jnp.int32))
        if int(state["policy"]["n"]) > 0:
            m = float(jpol.want_metric(state["policy"], i, x, signal=sig))
            margins.append(abs(m - delta) / delta)
        return jden(state, i, x, t_vec)

    jx0, jstate = jax_sample(checked, jnp.asarray(x_T), ts, jsched,
                             step_fn=jax_ddim_step,
                             denoiser_state=jden.init_state(2))
    assert min(margins) >= 1e-4, margins
    den = CachedDenoiser(tp, tcfg, make_policy("teacache", delta=delta),
                         device="cpu")
    x0, state = sample(den, torch.from_numpy(x_T),
                       linear_schedule(1000).spaced(NUM_STEPS),
                       linear_schedule(1000), step_fn=ddim_step,
                       denoiser_state=den.init_state(2))
    n = int(jstate["policy"]["n_compute"])
    assert int(state["policy"]["n_compute"]) == n and 1 < n < NUM_STEPS
    scale = float(np.abs(np.asarray(jx0)).max())
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0),
                               atol=2e-6 * scale, rtol=0)


def test_refill_isolation_teacache(setup):
    """A request served after another through one slot equals it served
    alone: the refill resets TeaCache's state (including the zero rows an
    idle slot's own predicate stored)."""
    _, tcfg, _, tp = setup
    noise = _jax_noise(tcfg)
    reqs = _requests(DiffusionRequest, n=2)
    eng = DiffusionServingEngine(tp, tcfg, "teacache", slots=1,
                                 max_steps=NUM_STEPS, noise_fn=noise,
                                 device="cpu")
    both = eng.serve(reqs)
    alone = eng.serve(reqs[1:])
    assert both[1].record.computed_steps == alone[0].record.computed_steps
    np.testing.assert_array_equal(both[1].x0, alone[0].x0)
