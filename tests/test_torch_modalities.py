"""The port's modality layer against the JAX package, on the CPU: the
modality specs, DenoiseWorkload, the video pool under teacache_video and
TaylorSeer, and MixedModalityEngine over image, video and audio at SMOKE
size (dit-xl, dit-video, dit-audio SMOKE), with bridged weights and the
JAX engine's own initial noise injected into the port.

Cache decisions must agree exactly (per-request computed steps, admit and
finish ticks, every row and tick counter, per-modality and token-weighted
totals); x0 within 1e-3 rel and 1e-4 abs, or 2e-6 of the request's
largest |x0| where that is larger: DDIM from t = 999 scales these random
models' x0 to ~500, where f32 sums in another order round by ~6e-4.  Each
exact comparison of a thresholded teacache_video decision is first made
well posed: every active slot's accumulated distance lies at least 1e-4
relative from delta at every tick the JAX engine plans.  VIDEO_DELTA was
chosen so that the video slots diverge with that margin on these weights
and this noise; a draw that lost it would fail, not be re-seeded.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import FasterCacheCFG as JaxFasterCacheCFG  # noqa: E402
from repro.modalities import MODALITIES as JAX_MODALITIES  # noqa: E402
from repro.modalities import MixedModalityEngine as JaxMixed  # noqa: E402
from repro.modalities import make_workload as jax_make_workload  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import FasterCacheCFG, make_policy  # noqa: E402
from repro_torch.modalities import (MODALITIES, MixedModalityEngine,  # noqa: E402
                                    autotune_pools, get_modality,
                                    make_workload)
from repro_torch.modalities import serving as mod_serving  # noqa: E402
from repro_torch.serving.diffusion import DiffusionRequest  # noqa: E402

NUM_STEPS = 8
MARGIN = 1e-4
ARCH = {"image": "dit-xl", "video": "dit-video", "audio": "dit-audio"}
# teacache_video's threshold for these weights and this noise (see the
# module docstring)
VIDEO_DELTA = 0.3


@pytest.fixture(scope="module")
def workloads():
    """{modality: (jax workload, port workload)} with the same weights."""
    out = {}
    for i, (m, arch) in enumerate(ARCH.items()):
        jcfg = jax_smoke(arch)
        jp = jax.jit(jax_perturb)(jax_init_params(jax.random.PRNGKey(i),
                                                  jcfg))
        tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        out[m] = (jax_make_workload(m, cfg=jcfg, params=jp),
                  make_workload(m, cfg=get_smoke_config(arch), params=tp))
    return out


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


def _margins(pol, states, metric, active):
    """Every active, unforced slot's accumulated distance (the want metric
    of TeaCache) relative to delta; asserts each is at least MARGIN."""
    n = np.asarray(states["policy"]["n"]).reshape(-1)
    out = [abs(float(metric[s]) - pol.delta) / pol.delta
           for s in np.nonzero(active)[0] if n[s] > 0]
    assert all(m >= MARGIN for m in out), out
    return out


def _check_plans(jeng, session, pol, margins):
    """Wrap the JAX engine's plan so every device plan's margins are
    checked (thresholded policies only)."""
    plan = jeng._plan_all

    def checked(states, steps, xs, tvals):
        wc, wu, metric = plan(states, steps, xs, tvals)
        if metric is not None and pol is not None:
            margins.extend(_margins(pol, states, np.asarray(metric),
                                    np.asarray(session.sched.active_mask())))
        return wc, wu, metric

    jeng._plan_all = checked


def _assert_same(tres, jres, ttel, jtel):
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert a.record.computed_steps == b.record.computed_steps, a.request_id
        assert (a.record.uncond_computed_steps
                == b.record.uncond_computed_steps)
        assert a.record.admit_tick == b.record.admit_tick
        assert a.record.finish_tick == b.record.finish_tick
        ref = np.asarray(b.x0)
        assert a.x0.shape == ref.shape
        np.testing.assert_allclose(
            a.x0, ref, rtol=1e-3,
            atol=max(1e-4, 2e-6 * float(np.abs(ref).max())))
    for field in ("backbone_rows_computed", "backbone_rows_padding",
                  "backbone_rows_saved", "uncond_rows_computed",
                  "uncond_rows_saved", "ticks_full", "ticks_cond",
                  "ticks_skip", "cache_state_bytes_per_slot"):
        assert getattr(ttel, field) == getattr(jtel, field), field


def test_modality_specs_match_jax_and_validate():
    assert set(MODALITIES) == set(JAX_MODALITIES)
    for name, spec in MODALITIES.items():
        js = JAX_MODALITIES[name]
        assert (spec.name, spec.arch_id, spec.temporal, spec.text) == (
            js.name, js.arch_id, js.temporal, js.text)
    image, video = get_modality("image"), get_modality("video")
    image.validate(image.config(smoke=True))
    video.validate(video.config())
    with pytest.raises(ValueError, match="temporal"):
        image.validate(video.config(smoke=True))
    with pytest.raises(ValueError, match="temporal"):
        video.validate(image.config(smoke=True))
    with pytest.raises(ValueError, match="not a DiT"):
        image.validate(get_smoke_config("zamba2-2.7b"))
    for text in ("t2i", "t2v"):
        spec = get_modality(text)
        spec.validate(spec.config(smoke=True))
        assert spec.config().dit_text_len == 77
        with pytest.raises(ValueError, match="text="):
            spec.validate(dataclasses.replace(spec.config(smoke=True),
                                              dit_text_len=0))
    with pytest.raises(KeyError, match="unknown modality"):
        get_modality("3d")


def test_workload_policies_and_entry_points(workloads):
    _, video = workloads["video"]
    _, image = workloads["image"]
    assert video.frames == 4 and image.frames == 1
    assert video.latent_shape(2) == (2, 32, 8)
    pol = video.make_policy("teacache_video", num_steps=NUM_STEPS, delta=0.2)
    assert (pol.frames, pol.delta) == (video.frames, 0.2)
    # the registry default where nothing injects the frame count
    assert image.make_policy("teacache_video").frames == 4
    eng = video.engine("teacache_video", slots=1, max_steps=NUM_STEPS)
    assert eng.policy.frames == video.frames
    for name in ("dbcache", "deepcache", "pab_video"):
        with pytest.raises(KeyError, match="structural"):
            video.make_policy(name)
        with pytest.raises(KeyError, match="structural"):
            make_policy(name)
    assert video.pab_stack().intervals == {"spatial_attn": 2,
                                           "temporal_attn": 4, "mlp": 4}
    with pytest.raises(ValueError, match="temporal"):
        image.pab_stack()
    with pytest.raises(ValueError, match="not text-conditioned"):
        video.conditioner()
    x = video.noise(torch.Generator().manual_seed(0), 1)
    assert tuple(x.shape) == video.latent_shape(1)
    den = video.denoiser(make_policy("fora", interval=2))
    eps, _ = den(None, 0, x, torch.full((1,), 500.0))
    assert tuple(eps.shape) == video.latent_shape(1)
    eps, _ = video.cfg_denoise_fn(2.0)(None, 0, x, torch.full((1,), 500.0))
    assert torch.isfinite(eps).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_workload("audio", smoke=True)


def _video_requests(cls):
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5, modality="video") for i in range(5)]


@pytest.mark.parametrize("name,kw", [
    ("teacache_video", {"delta": VIDEO_DELTA}),
    ("taylorseer", {"interval": 3}),
])
def test_video_pool_matches_jax_engine(workloads, name, kw):
    jwl, twl = workloads["video"]
    jpol = jwl.make_policy(name, num_steps=NUM_STEPS, **kw)
    jeng = jwl.engine(jpol, slots=2, max_steps=NUM_STEPS)
    session = jeng.start_session(_video_requests(JaxRequest))
    margins = []
    _check_plans(jeng, session, jpol if name == "teacache_video" else None,
                 margins)
    while not session.done:
        session.tick()
    jres = session.finish()
    teng = twl.engine(twl.make_policy(name, num_steps=NUM_STEPS, **kw),
                      slots=2, max_steps=NUM_STEPS,
                      noise_fn=_jax_noise(twl.cfg))
    assert (teng._static_plan is None) == (name == "teacache_video")
    tres = teng.serve(_video_requests(DiffusionRequest))
    _assert_same(tres, jres, teng.telemetry, jeng.telemetry)
    assert teng.telemetry.backbone_rows_saved > 0
    if name == "teacache_video":
        print(f"{len(margins)} decisions, least margin {min(margins):.3e}")
        assert any(r.record.computed_steps not in (1, r.record.num_steps)
                   for r in tres)


def _mixed_requests(cls, d_model):
    """The example's queue at NUM_STEPS: modality cycling, budgets 8 and
    6, guided image requests, request 0 with a negative-prompt vector."""
    mods = ("image", "video", "audio")
    neg = np.random.RandomState(0).randn(d_model).astype(np.float32) * 0.1
    return [cls(i, num_steps=NUM_STEPS - 2 * (i % 2), seed=i,
                class_label=i % 5, modality=mods[i % 3],
                cfg_scale=3.0 if mods[i % 3] == "image" else 0.0,
                null_label=neg if i == 0 else None)
            for i in range(9)]


def _mixed_pools(workloads, jax_side, noise=False):
    idx = 0 if jax_side else 1
    pols = {"image": ("taylorseer", {"interval": 2}),
            "video": ("teacache_video", {"delta": VIDEO_DELTA}),
            "audio": ("fora", {"interval": 2})}
    pools = {}
    for m, (name, kw) in pols.items():
        wl = workloads[m][idx]
        cfgp = None
        if m == "image":
            cfgp = (JaxFasterCacheCFG if jax_side else FasterCacheCFG)(
                4, NUM_STEPS)
        extra = {} if jax_side or not noise else {
            "noise_fn": _jax_noise(wl.cfg)}
        pools[m] = wl.engine(wl.make_policy(name, num_steps=NUM_STEPS, **kw),
                             slots=2, max_steps=NUM_STEPS, cfg_policy=cfgp,
                             **extra)
    return pools


def test_mixed_engine_matches_jax(workloads):
    """Image (TaylorSeer + FasterCacheCFG, guided, one vector null), video
    (teacache_video) and audio (FORA) through the mixed pool of each
    package: equal per-modality and token-weighted row totals, equal
    decisions, x0 as in the module docstring."""
    d = workloads["image"][0].cfg.d_model
    jpools = _mixed_pools(workloads, jax_side=True)
    jmix = JaxMixed(jpools)
    jvid = jpools["video"]
    plan, margins = jvid._plan_all, []
    jvideo_pol = jvid.policy

    def checked(states, steps, xs, tvals):
        wc, wu, metric = plan(states, steps, xs, tvals)
        n = np.asarray(states["policy"]["n"]).reshape(-1)
        for s in range(len(n)):
            if n[s] > 0 and int(np.asarray(steps)[s]) > 0:
                margins.append(abs(float(metric[s]) - jvideo_pol.delta)
                               / jvideo_pol.delta)
        return wc, wu, metric

    jvid._plan_all = checked
    jres = jmix.serve(_mixed_requests(JaxRequest, d))
    assert margins and min(margins) >= MARGIN, min(margins)
    tmix = MixedModalityEngine(_mixed_pools(workloads, jax_side=False,
                                            noise=True))
    tres = tmix.serve(_mixed_requests(DiffusionRequest, d))
    for m in ARCH:
        _assert_same([r for r in tres if r.record.modality == m],
                     [r for r in jres if r.record.modality == m],
                     tmix.telemetry.pools[m], jmix.telemetry.pools[m])
    ts, js = tmix.telemetry.summary(), jmix.telemetry.summary()
    for key in ("requests", "backbone_rows_computed", "backbone_rows_saved",
                "backbone_tokens_computed", "backbone_tokens_saved",
                "rows_by_modality", "rows_saved_by_modality"):
        assert ts[key] == js[key], key
    assert ts["backbone_tokens_computed"] > ts["backbone_rows_computed"]
    assert tmix.telemetry.row_tokens == jmix.telemetry.row_tokens


def test_mixed_pool_refill_isolation(workloads):
    """8 requests over 3 pools of 2 slots: each output equals serving the
    request alone on fresh pools (reset-on-refill in every sub-pool)."""
    d = workloads["image"][1].cfg.d_model
    reqs = _mixed_requests(DiffusionRequest, d)[:8]
    res = MixedModalityEngine(_mixed_pools(workloads, False)).serve(reqs)
    assert len(res) == 8
    for req, r in zip(reqs, res):
        solo = MixedModalityEngine(_mixed_pools(workloads, False)).serve(
            [req])[0]
        assert solo.record.computed_steps == r.record.computed_steps
        np.testing.assert_allclose(r.x0, solo.x0, atol=5e-4, rtol=1e-3,
                                   err_msg=f"request {req.request_id}")


def test_mixed_pool_contract(workloads):
    """Unknown modality, a shared engine, warmup, preemption, hooks."""
    pools = _mixed_pools(workloads, False)
    mix = MixedModalityEngine(pools)
    with pytest.raises(KeyError, match="no pool"):
        mix.serve([DiffusionRequest(0, NUM_STEPS, modality="3d")])
    with pytest.raises(ValueError, match="own engine"):
        MixedModalityEngine({"a": pools["image"], "b": pools["image"]})
    with pytest.raises(ValueError, match="at least one"):
        MixedModalityEngine({})
    assert mix.ir_findings is None
    assert set(mix.warmup(verify=True)) == set(ARCH)
    assert mix.ir_findings == []           # every pool's programs clean
    buckets = mix.warmup()
    assert set(buckets) == set(ARCH) and all(buckets.values())
    events = {m: [] for m in ARCH}
    d = workloads["image"][1].cfg.d_model
    res = mix.serve(_mixed_requests(DiffusionRequest, d), max_ticks=3,
                    hooks={m: [events[m].append] for m in ARCH})
    s = mix.telemetry.summary()
    assert len(res) == 0 and s["requests_preempted"] == 9
    assert all(len(e) == 3 and e[0].modality == m
               for m, e in events.items())
    # every engine's session latch was released
    assert len(mix.serve([DiffusionRequest(1, 2, modality="audio")])) == 1
    mixed = MixedModalityEngine.from_workloads(
        {m: w[1] for m, w in workloads.items()},
        policies={"video": "teacache_video"}, slots=1, max_steps=4)
    assert mixed.pools["video"].policy.frames == 4
    assert mixed.pools["image"].policy.name == "none"


def test_autotune_pools_adds_the_temporal_candidate(workloads, monkeypatch):
    """Video sweeps add teacache_video with the clip's frame count; the
    pick is made by the port's autotune on each workload's own model."""
    seen = {}

    def fake_autotune(params, cfg, sla, candidates, num_steps, **kw):
        seen[cfg.name] = list(candidates)
        return cfg.name

    monkeypatch.setattr(mod_serving, "autotune", fake_autotune)
    out = autotune_pools({m: w[1] for m, w in workloads.items()},
                         mod_serving.SLA(min_psnr=12.0), num_steps=4,
                         extra_candidates={"audio": [("fora", {})]})
    assert out == {m: w[1].cfg.name for m, w in workloads.items()}
    base = list(mod_serving.DEFAULT_CANDIDATES)
    assert seen["dit-video-smoke"] == base + [
        ("teacache_video", {"delta": 0.1, "frames": 4})]
    assert seen["dit-xl-smoke"] == base
    assert seen["dit-audio-smoke"] == base + [("fora", {})]
