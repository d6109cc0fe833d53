"""The port's SLA autotuner against the JAX package, on the CPU.

`evaluate_candidate` runs one candidate of each family of the default
sweep (and guided ones under FasterCacheCFG) on the same initial latent
(JAX's calibration draw, fed to the port) over 8 steps: PSNR within 0.1 dB
and exactly the same compute fractions.
Each exact comparison of a thresholded decision (TeaCache, MagCache) is
first made well posed: every step's JAX metric lies at least 1e-4
relative from its threshold.  `price_and_pick` on identical candidate
lists gives the same pick and estimated latency; the host-plan flags and
`TunedPolicy.align` match JAX's."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FasterCacheCFG as JaxFasterCacheCFG  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.diffusion import CachedDenoiser as JaxCachedDenoiser  # noqa: E402
from repro.diffusion import ddim_step as jax_ddim_step  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro.diffusion.pipeline import backbone_fns as jax_backbone_fns  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FasterCacheCFG, make_policy  # noqa: E402
from repro_torch.core import static_plan as port_static_plan  # noqa: E402
from repro_torch.diffusion import ddim_step, linear_schedule, sample  # noqa: E402
from repro_torch.diffusion.pipeline import cfg_denoise_fn  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402

# the modules (the packages re-export the function `autotune` under the
# same name)
jat = importlib.import_module("repro.serving.diffusion.autotune")
tat = importlib.import_module("repro_torch.serving.diffusion.autotune")

NUM_STEPS = 8
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)
GATED = {"teacache", "magcache"}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ref = {}
    for scale in (0.0, 3.0):
        sched, ts, xT, exact = jat.calibration_reference(
            jp, jcfg, NUM_STEPS, cfg_scale=scale)
        ref[scale] = (sched, ts, xT, exact)
    return jcfg, tcfg, jp, tp, ref


def _margins(name, kwargs, jp, jcfg, ts, sched, xT, scale, cfg_interval):
    """JAX's metric at every non-forced step of the candidate's trajectory,
    as relative distances from its threshold."""
    pol = jax_make_policy(name, **kwargs)
    cfg_pol = (JaxFasterCacheCFG(cfg_interval, len(ts))
               if scale > 0 and cfg_interval else None)
    den = JaxCachedDenoiser(jp, jcfg, pol, cfg_scale=scale,
                            cfg_policy=cfg_pol)
    _, signal_fn = jax_backbone_fns(jp, jcfg)
    out = []

    def checked(state, i, x, t_vec):
        if int(state["policy"]["n"]) > 0:
            sig = signal_fn(x, t_vec, jnp.zeros((x.shape[0],), jnp.int32))
            m = float(pol.want_metric(state["policy"], i, x, signal=sig))
            out.append(abs(m - pol.delta) / pol.delta)
        return den(state, i, x, t_vec)

    jax_sample(checked, xT, ts, sched, step_fn=jax_ddim_step,
               denoiser_state=den.init_state(xT.shape[0]))
    return out


CASES = [("fora", {"interval": 2}, 0.0, None),
         ("taylorseer", {"interval": 4, "order": 2}, 0.0, None),
         ("teacache", {"delta": 0.3}, 0.0, None),
         ("magcache", {"delta": 0.1}, 0.0, None),
         ("freqca", {"interval": 4}, 0.0, None),
         ("taylorseer", {"interval": 2, "order": 1}, 3.0, 2),
         ("teacache", {"delta": 0.3}, 3.0, 4)]


@pytest.mark.parametrize("name,kwargs,scale,cfg_interval", CASES)
def test_evaluate_candidate_matches_jax(setup, name, kwargs, scale,
                                        cfg_interval):
    jcfg, tcfg, jp, tp, ref = setup
    sched, ts, xT, exact = ref[scale]
    kw = dict(kwargs, num_steps=NUM_STEPS)
    if name in GATED:
        margins = _margins(name, kw, jp, jcfg, ts, sched, xT, scale,
                           cfg_interval)
        assert min(margins) >= 1e-4, margins
    jq, jcf, jcfu = jat.evaluate_candidate(name, kw, jp, jcfg, sched, ts, xT,
                                           exact, cfg_scale=scale,
                                           cfg_interval=cfg_interval)
    # the port's own exact trajectory from the same latent
    txT = torch.from_numpy(np.array(xT))
    tsched = linear_schedule(1000)
    tts = tsched.spaced(NUM_STEPS)
    texact, _ = sample(cfg_denoise_fn(tp, tcfg, scale), txT, tts, tsched,
                       step_fn=ddim_step)
    np.testing.assert_allclose(texact.numpy(), exact, atol=1e-3, rtol=1e-3)
    q, cf, cfu = tat.evaluate_candidate(name, kw, tp, tcfg, tsched, tts, txT,
                                        texact.numpy(), cfg_scale=scale,
                                        cfg_interval=cfg_interval)
    assert abs(q - jq) <= 0.1, (q, jq)
    assert (cf, cfu) == (jcf, jcfu)


def test_calibration_reference_draws_on_the_params_device(setup):
    _, tcfg, _, tp, _ = setup
    sched, ts, xT, exact = tat.calibration_reference(tp, tcfg, 4, batch=2,
                                                     seed=5)
    assert xT.device.type == "cpu" and tuple(xT.shape) == (
        2, tcfg.dit_tokens, tcfg.dit_in_dim)
    gen = torch.Generator().manual_seed(5)
    torch.testing.assert_close(xT, torch.randn(xT.shape, generator=gen))
    assert exact.shape == tuple(xT.shape) and np.isfinite(exact).all()
    np.testing.assert_array_equal(ts, sched.spaced(4))


def _candidates(mod):
    """The same hand-made candidate list in either package."""
    rows = [("none", {}, 30.0, 1.0, 1.0, 0.0, None, True),
            ("fora", {"interval": 2}, 22.0, 0.75, 0.5, 1.0, None, True),
            ("taylorseer", {"interval": 4}, 25.0, 0.375, 0.25, 0.5, 2, True),
            ("teacache", {"delta": 0.1}, 26.0, 0.3, 0.35, 0.25, 4, False),
            ("freqca", {"interval": 4}, 18.0, 0.25, 0.25, 0.25, 4, True)]
    return [mod.TunedPolicy(n, kw, psnr=q, compute_fraction=cf,
                            cond_compute_fraction=cc,
                            uncond_compute_fraction=cu, cfg_interval=ci,
                            static_plan=st)
            for n, kw, q, cf, cc, cu, ci, st in rows]


@pytest.mark.parametrize("pricing", [
    {}, {"row_time_ms": (2.0, 0.5), "occupancy": 4},
    {"row_time_ms": (2.0, 0.5), "occupancy": 4, "plan_ms": 3.0},
    {"step_time_ms": (10.0, 1.0)}])
@pytest.mark.parametrize("sla", [("q", 24.0, None), ("lat", 20.0, 60.0),
                                 ("tight", 99.0, None)])
def test_price_and_pick_matches_jax(pricing, sla):
    jpick = jat.price_and_pick(_candidates(jat), jat.SLA(*sla), **pricing)
    reg = MetricsRegistry()
    pick = tat.price_and_pick(_candidates(tat), tat.SLA(*sla), registry=reg,
                              **pricing)
    for f in ("policy_name", "kwargs", "psnr", "compute_fraction",
              "est_latency_ms", "feasible", "cfg_interval", "static_plan"):
        assert getattr(pick, f) == getattr(jpick, f), f
    (ev,) = reg.events
    assert ev["event"] == "autotune.price_and_pick"
    assert ev["picked"] == pick.policy_name and ev["sla"] == sla[0]


@pytest.mark.parametrize("name,kwargs", jat.DEFAULT_CANDIDATES)
def test_host_plan_flags_match_jax(name, kwargs):
    kw = dict(kwargs, num_steps=NUM_STEPS)
    pol, jpol = make_policy(name, **kw), jax_make_policy(name, **kw)
    assert (tat._plans_on_host(pol, NUM_STEPS)
            == jat._plans_on_host(jpol, NUM_STEPS))
    plan = port_static_plan(pol, NUM_STEPS)
    assert (plan is None) == (name in GATED)
    if plan is not None:
        np.testing.assert_array_equal(plan, [bool(jpol.want_compute(
            None, s, None)) for s in range(NUM_STEPS)])
    assert tat._plans_on_host(FasterCacheCFG(3, NUM_STEPS), NUM_STEPS)


@pytest.mark.parametrize("kwargs,ci", [({}, None), ({"interval": 4}, None),
                                       ({"interval": 4}, 3),
                                       ({"interval": 2}, 4), ({}, 5)])
def test_tuned_policy_align_and_cfg_policy(kwargs, ci):
    t = tat.TunedPolicy("fora", kwargs, cfg_interval=ci)
    j = jat.TunedPolicy("fora", kwargs, cfg_interval=ci)
    assert t.align == j.align
    cp = t.make_cfg_policy(16)
    assert (cp is None) == (ci is None)
    if cp is not None:
        assert (cp.interval, cp.num_steps) == (ci, 16)
    assert tat.DEFAULT_CANDIDATES == jat.DEFAULT_CANDIDATES


def test_autotune_traffic_classes_guided(setup):
    """End to end on the port: a guided sweep over two CFG intervals picks
    per SLA; the relaxed class takes the cheapest candidate, the strict
    one stays exact."""
    _, tcfg, _, tp, _ = setup
    cands = [("none", {}), ("fora", {"interval": 2}),
             ("teacache", {"delta": 0.3})]
    picks = tat.autotune_traffic_classes(
        tp, tcfg, {"fast": tat.SLA("fast", min_psnr=-100.0),
                   "exact": tat.SLA("exact", min_psnr=200.0)},
        candidates=cands, num_steps=8, cfg_scale=3.0,
        cfg_intervals=(None, 2))
    fast, exact = picks["fast"], picks["exact"]
    assert fast.feasible and fast.compute_fraction < 1.0
    assert fast.cfg_interval == 2 and fast.make_cfg_policy(8).interval == 2
    assert exact.policy_name == "none" and exact.cfg_interval is None
    assert not exact.feasible        # nothing reaches 200 dB: closest kept
