"""Text-conditioned denoising and serving in the port against the JAX
package, on the CPU, at SMOKE size (dit-t2i: 2 layers, d_model 128, 16
patches; dit-t2v: 4 frames of 8 patches; 8 text tokens): CachedDenoiser
with a prompt and a negative prompt at model, block, deepcache and
pab_video granularity, cfg_denoise_fn with a negative prompt, the serving
engine under TeaCache with FasterCacheCFG (prompts, one negative prompt;
compacted and dense), prompted t2v serving, PAB on the cross_attn branch,
refill isolation of the text tables, the workload and mixed-pool wiring,
and the request and config errors.

Both packages get the same bridged weights (the DiT and its text encoder),
the same prompt embeddings and the JAX engine's own initial noise.  Cache
decisions and row counts must agree exactly (every thresholded TeaCache
decision first checked >= 1e-4 relative from its threshold); denoiser
outputs within 1e-4 abs and 1e-3 rel; served x0 within 1e-3 rel and 1e-4
abs, or 2e-6 of the request's largest |x0| where that is larger (DDIM from
t = 999 scales these random models' x0 to ~500, where f32 sums in another
order round by ~3e-4); the dense engine against the compacted one within
5e-4 abs and 1e-3 rel.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.conditioning import PromptCache as JaxPromptCache  # noqa: E402
from repro.conditioning import init_text_encoder as jax_init_enc  # noqa: E402
from repro.conditioning import \
    text_encoder_config as jax_tc_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import FasterCacheCFG as JaxFasterCacheCFG  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.diffusion import CachedDenoiser as JaxCachedDenoiser  # noqa: E402
from repro.diffusion import ddim_step as jax_ddim_step  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear_schedule  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro.diffusion.pipeline import \
    cfg_denoise_fn as jax_cfg_denoise_fn  # noqa: E402
from repro.modalities import make_workload as jax_make_workload  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.conditioning import (PromptCache,  # noqa: E402
                                      text_encoder_config)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import FasterCacheCFG, make_policy  # noqa: E402
from repro_torch.core.static_policies import PABPolicy  # noqa: E402
from repro_torch.diffusion import (CachedDenoiser, ddim_step,  # noqa: E402
                                   linear_schedule, sample)
from repro_torch.diffusion.pipeline import cfg_denoise_fn  # noqa: E402
from repro_torch.modalities import (MixedModalityEngine,  # noqa: E402
                                    make_workload)
from repro_torch.models import dit  # noqa: E402
from repro_torch.serving.diffusion import (DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine)

NUM_STEPS = 8
TEACACHE_DELTA = 0.3
PROMPT, OTHER, NEG = "a red fox in the snow", "a lighthouse", "blurry"


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax cfg, port cfg, jax params, bridged params, jax PromptCache,
    port PromptCache over the bridged encoder)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax.jit(jax_perturb)(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jtc = jax_tc_config(jcfg)
    jenc = jax_init_enc(jax.random.PRNGKey(1), jtc)
    tenc = to_torch(jax.tree_util.tree_map(np.asarray, jenc), device="cpu")
    return (jcfg, tcfg, jp, tp, JaxPromptCache(jenc, jtc),
            PromptCache(tenc, text_encoder_config(tcfg)))


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


def _requests(cls, n=5):
    """Budgets 8 and 6 alternating; requests 0, 1 and 3 guided, request 0
    with a negative prompt, request 2 without a prompt; 5 requests through
    2 slots, so slots are refilled."""
    prompts = (PROMPT, OTHER, None, PROMPT, OTHER)
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5,
                cfg_scale=2.5 if i in (0, 1, 3) else 0.0,
                prompt_tokens=prompts[i],
                neg_prompt_tokens=NEG if i == 0 else None)
            for i in range(n)]


def _check_margins(jeng, delta):
    """Wrap the JAX engine's plan: every thresholded TeaCache decision of
    an active slot lies at least 1e-4 relative from delta."""
    plan, margins = jeng._plan_all, []

    def checked(states, steps, xs, tvals):
        wc, wu, metric = plan(states, steps, xs, tvals)
        if metric is not None:
            n = np.asarray(states["policy"]["n"])
            margins.extend(abs(float(metric[s]) - delta) / delta
                           for s in range(len(n)) if n[s] > 0)
        return wc, wu, metric

    jeng._plan_all = checked
    return margins


def _assert_same_serving(tres, jres, ts, js):
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert (a.record.computed_steps, a.record.uncond_computed_steps) == (
            b.record.computed_steps, b.record.uncond_computed_steps), \
            a.request_id
        assert (a.record.admit_tick, a.record.finish_tick) == (
            b.record.admit_tick, b.record.finish_tick)
        assert np.isfinite(a.x0).all()
        np.testing.assert_allclose(
            a.x0, b.x0, rtol=1e-3,
            atol=max(1e-4, 2e-6 * float(np.abs(b.x0).max())))
    for f in ("backbone_rows_computed", "backbone_rows_padding",
              "backbone_rows_saved", "uncond_rows_computed",
              "uncond_rows_saved", "ticks_full", "ticks_cond", "ticks_skip"):
        assert getattr(ts, f) == getattr(js, f), f


# ----------------------------------------------------------------------
# CachedDenoiser and cfg_denoise_fn with prompts
# ----------------------------------------------------------------------

_DENOISER_CASES = [
    ("dit-t2i", "model", "fora", {"interval": 2}),
    ("dit-t2i", "block", "fora", {"interval": 2}),
    ("dit-t2i", "deepcache", "delta_dit", {"interval": 2}),
    ("dit-t2v", "block", "taylorseer", {"interval": 3}),
    ("dit-t2v", "pab_video", None, {}),
]


@pytest.mark.parametrize("arch,gran,name,kw", _DENOISER_CASES)
def test_cached_denoiser_with_text_matches_jax(arch, gran, name, kw):
    """4 DDIM steps of a guided CachedDenoiser(text, neg_text) (the same
    PromptEmbeddings on both sides; shallow_n 1): x0 within 1e-4 abs and
    1e-3 rel, with the backbone passes, blocks or branches the port
    computed equal to the count JAX's static schedule gives."""
    jcfg, tcfg, jp, tp, jcache, _ = _setup(arch)
    text, neg = jcache.get(PROMPT), jcache.get(NEG)
    steps = 4
    jpol = jax_make_policy(name, **kw) if name else None
    tpol = make_policy(name, **kw) if name else None
    xT = np.random.default_rng(2).standard_normal(
        (1, jcfg.dit_tokens, jcfg.dit_in_dim)).astype(np.float32)
    jsched = jax_linear_schedule(200)
    jden = JaxCachedDenoiser(jp, jcfg, jpol, granularity=gran, shallow_n=1,
                             cfg_scale=2.0, text=text, neg_text=neg)
    ref, _ = jax_sample(jden, jnp.asarray(xT), jsched.spaced(steps), jsched,
                        step_fn=jax_ddim_step,
                        denoiser_state=jden.init_state(1))
    sched = linear_schedule(200)
    den = CachedDenoiser(tp, tcfg, tpol, granularity=gran, shallow_n=1,
                         cfg_scale=2.0, text=text, neg_text=neg,
                         device="cpu")
    calls = []
    if gran == "pab_video":
        den._stack.branch_fns = {
            k: (lambda *a, f=f, k=k: calls.append(k) or f(*a))
            for k, f in den._stack.branch_fns.items()}
        assert set(den._stack.branch_fns) == set(jden._stack.branch_fns)
        want = round(sum(jden._stack.static_schedule(steps))
                     * len(jden._stack.branch_fns) * jcfg.num_layers)
    elif gran == "model":
        fwd = den._forward
        den._forward = (lambda *a, **k: calls.append(1) or fwd(*a, **k))
        # cond passes on the schedule, plus the uncond pass of every step
        want = sum(jpol.static_schedule(steps)) + steps
    else:
        blk = den._block
        if gran == "block":
            den._stack.block_fn = (lambda *a: calls.append(1) or blk(*a))
        else:
            den._block = (lambda *a: calls.append(1) or blk(*a))
        n_c = sum(jpol.static_schedule(steps))
        deep = jcfg.num_layers - (1 if gran == "deepcache" else 0)
        want = n_c * deep + (steps if gran == "deepcache" else 0)
    x0, _ = sample(den, _t(xT), sched.spaced(steps), sched,
                   step_fn=ddim_step, denoiser_state=den.init_state(1))
    assert len(calls) == want
    np.testing.assert_allclose(x0.numpy(), _np(ref), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ["dit-t2i", "dit-t2v"])
def test_cfg_denoise_fn_with_negative_prompt_matches_jax(arch):
    """The exact guided baseline with a prompt and a negative prompt (whose
    pooled vector becomes the uncond conditioning): eps within 1e-4; the
    negative prompt changes it."""
    jcfg, tcfg, jp, tp, jcache, _ = _setup(arch)
    text, neg = jcache.get(PROMPT), jcache.get(NEG)
    x = np.random.default_rng(3).standard_normal(
        (2, jcfg.dit_tokens, jcfg.dit_in_dim)).astype(np.float32)
    tv = np.array([300.0, 700.0], np.float32)
    ref, _ = jax_cfg_denoise_fn(jp, jcfg, 3.0, class_label=2, text=text,
                                neg_text=neg)(None, 0, jnp.asarray(x),
                                              jnp.asarray(tv))
    out, _ = cfg_denoise_fn(tp, tcfg, 3.0, class_label=2, text=text,
                            neg_text=neg)(None, 0, _t(x), _t(tv))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-4, rtol=1e-3)
    plain, _ = cfg_denoise_fn(tp, tcfg, 3.0, class_label=2, text=text)(
        None, 0, _t(x), _t(tv))
    assert float((plain - out).abs().max()) > 1e-3


# ----------------------------------------------------------------------
# the serving engine with prompts
# ----------------------------------------------------------------------

def _engines(arch, policy, jkw, tkw, **kw):
    """(JAX engine, port engine) with each side's conditioner."""
    jcfg, tcfg, jp, tp, jcache, tcache = _setup(arch)
    jeng = JaxEngine(jp, jcfg, jpol_of(policy, jcfg), slots=2,
                     max_steps=NUM_STEPS, conditioner=jcache, **jkw)
    teng = DiffusionServingEngine(tp, tcfg, tpol_of(policy, tcfg), slots=2,
                                  max_steps=NUM_STEPS, conditioner=tcache,
                                  noise_fn=_jax_noise(tcfg), device="cpu",
                                  **tkw, **kw)
    return jeng, teng


def jpol_of(policy, cfg):
    name, kw = policy
    if name == "teacache_video":
        kw = dict(kw, frames=cfg.dit_num_frames)
    return jax_make_policy(name, num_steps=NUM_STEPS, **kw)


def tpol_of(policy, cfg):
    name, kw = policy
    if name == "teacache_video":
        kw = dict(kw, frames=cfg.dit_num_frames)
    return make_policy(name, num_steps=NUM_STEPS, **kw)


TEACACHE = ("teacache", {"delta": TEACACHE_DELTA})


def test_t2i_engine_matches_jax_under_teacache_and_fastercache_cfg():
    """Prompted guided traffic (one negative prompt, one request without a
    prompt, slots refilled) under TeaCache with FasterCacheCFG(3): exact
    (cond, uncond) computed steps, ticks and rows after the margin check,
    x0 within 1e-4 abs and 1e-3 rel; the text tables are built once per
    admission wave, and the encoder runs once per unique prompt."""
    jeng, teng = _engines("dit-t2i", TEACACHE,
                          {"cfg_policy": JaxFasterCacheCFG(3, NUM_STEPS)},
                          {"cfg_policy": FasterCacheCFG(3, NUM_STEPS)})
    margins = _check_margins(jeng, TEACACHE_DELTA)
    jres = jeng.serve(_requests(JaxRequest))
    waves = []
    teng.text_table_builds = 0
    tres = teng.serve(_requests(DiffusionRequest),
                      hooks=[lambda ev: waves.append(bool(ev.admitted))])
    assert margins and min(margins) >= 1e-4, min(margins)
    _assert_same_serving(tres, jres, teng.telemetry, jeng.telemetry)
    assert sum(r.record.computed_steps for r in tres) < sum(
        r.num_steps for r in _requests(DiffusionRequest))
    assert teng.text_table_builds == sum(waves) >= 2
    tcache = teng.conditioner
    assert tcache.misses == len({PROMPT, OTHER, NEG})


def test_dense_engine_matches_compacted_with_text():
    """The dense engine (whole-pool full / cond / skip ticks over the
    unsliced and halved text tables) against the compacted one (per-row
    gathers): the same counts, x0 within 5e-4 abs and 1e-3 rel."""
    out = {}
    for compact in (True, False):
        _, teng = _engines("dit-t2i", ("taylorseer", {}), {},
                           {"cfg_policy": FasterCacheCFG(3, NUM_STEPS)},
                           row_compaction=compact)
        res = teng.serve(_requests(DiffusionRequest))
        out[compact] = [(r.record.computed_steps,
                         r.record.uncond_computed_steps) for r in res], res
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(b.x0, a.x0, atol=5e-4, rtol=1e-3)


def test_t2v_prompted_serving_matches_jax():
    """dit-t2v served under teacache_video with prompts, one negative
    prompt and guided requests: exact counts after the margin check, x0
    within 1e-4 abs and 1e-3 rel."""
    delta = 0.2
    pol = ("teacache_video", {"delta": delta})
    jeng, teng = _engines("dit-t2v", pol, {}, {})
    margins = _check_margins(jeng, delta)
    jres = jeng.serve(_requests(JaxRequest, 4))
    tres = teng.serve(_requests(DiffusionRequest, 4))
    assert margins and min(margins) >= 1e-4, min(margins)
    _assert_same_serving(tres, jres, teng.telemetry, jeng.telemetry)


def test_refill_isolation_of_text_tables():
    """More prompted requests than slots: each request's x0 equals serving
    it alone on a fresh engine (refill resets the prompt and negative
    tables), within 5e-4 abs and 1e-3 rel."""
    def fresh():
        return _engines("dit-t2i", ("fora", {"interval": 2}), {},
                        {"cfg_policy": FasterCacheCFG(2, NUM_STEPS)})[1]

    reqs = _requests(DiffusionRequest)
    res = fresh().serve(reqs)
    assert len(res) == len(reqs)
    for req, r in zip(reqs, res):
        solo = fresh().serve([req])[0]
        np.testing.assert_allclose(r.x0, solo.x0, atol=5e-4, rtol=1e-3,
                                   err_msg=f"request {req.request_id}")


def test_pab_cross_attn_range_serves_as_jax():
    """The pab registry entry on the cross_attn module type: range 6 as in
    JAX, a schedule that computes some steps and reuses others, and a
    served prompted request with JAX's counts and x0."""
    pol = make_policy("pab", module_type="cross_attn")
    assert isinstance(pol, PABPolicy) and PABPolicy.RANGES["cross_attn"] == 6
    sched = pol.static_schedule(NUM_STEPS)
    assert sched == jax_make_policy(
        "pab", module_type="cross_attn").static_schedule(NUM_STEPS)
    assert sched[0] and 0 < sum(sched) < NUM_STEPS
    jeng, teng = _engines("dit-t2i", ("pab", {"module_type": "cross_attn"}),
                          {}, {})
    reqs = [cls(0, NUM_STEPS, seed=9, prompt_tokens=PROMPT)
            for cls in (JaxRequest, DiffusionRequest)]
    jres, tres = jeng.serve(reqs[:1]), teng.serve(reqs[1:])
    assert tres[0].record.computed_steps == sum(sched) < NUM_STEPS
    _assert_same_serving(tres, jres, teng.telemetry, jeng.telemetry)


def test_warmup_reports_text_programs_and_counts_nothing():
    """A text engine's warmup adds "text_kv" and "text_encoder" and counts
    no build, hit or miss; a text-free engine's has neither; the session
    starts from the empty tables, which are the prompt-less no-op."""
    wl = make_workload("t2i", smoke=True, device="cpu")
    cond = wl.conditioner()
    eng = wl.engine("fora", slots=2, max_steps=NUM_STEPS, conditioner=cond)
    runs = eng.warmup()
    assert runs[-2:] == ["text_kv", "text_encoder"]
    assert (eng.text_table_builds, cond.hits, cond.misses) == (0, 0, 0)
    empty = eng._empty_txt()
    assert set(empty) == {"k", "v", "mask"} and not empty["mask"].any()
    assert tuple(empty["k"].shape) == (4, wl.cfg.num_layers,
                                       wl.cfg.dit_text_len, wl.cfg.d_model)
    image = make_workload("image", smoke=True, device="cpu")
    plain = image.engine("fora", slots=2, max_steps=NUM_STEPS)
    assert not [r for r in plain.warmup() if isinstance(r, str)]
    assert plain._empty_txt() == {}


def test_workloads_and_mixed_pool_with_text():
    """DenoiseWorkload builds the conditioner on its device and the text
    entry points; MixedModalityEngine.from_workloads hands each text pool
    its own conditioner and serves prompted t2i beside class-conditioned
    image requests."""
    t2i = make_workload("t2i", smoke=True, device="cpu")
    image = make_workload("image", smoke=True, device="cpu")
    cond = t2i.conditioner(capacity=4, seed=3)
    assert cond.capacity == 4 and cond.name == "t2i"
    assert cond.device == torch.device("cpu")
    pe = cond.get(PROMPT)
    x = t2i.noise(torch.Generator().manual_seed(0))
    tv = torch.full((1,), 500.0)
    eps, _ = t2i.cfg_denoise_fn(2.0, text=pe, neg_text=cond.get(NEG))(
        None, 0, x, tv)
    den = t2i.denoiser(make_policy("fora", interval=2), text=pe)
    assert torch.isfinite(eps).all() and torch.isfinite(den(None, 0, x,
                                                            tv)[0]).all()
    with pytest.raises(ValueError, match="not text-conditioned"):
        image.conditioner()
    mixed = MixedModalityEngine.from_workloads(
        {"t2i": t2i, "image": image}, policies={"t2i": "fora"},
        conditioners={"t2i": cond}, slots=2, max_steps=NUM_STEPS)
    assert mixed.pools["t2i"].conditioner is cond
    assert mixed.pools["image"].conditioner is None
    reqs = [DiffusionRequest(i, NUM_STEPS, seed=i, modality=m,
                             prompt_tokens=PROMPT if m == "t2i" else None)
            for i, m in enumerate(("t2i", "image", "t2i"))]
    res = mixed.serve(reqs)
    assert len(res) == 3 and all(np.isfinite(r.x0).all() for r in res)


# ----------------------------------------------------------------------
# the request and config contract
# ----------------------------------------------------------------------

def _error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_request_and_config_errors_match_jax():
    """A prompt on a text-free config, a prompt with no conditioner, a
    negative prompt beside a vector null label, and a conditioner on a
    text-free config raise JAX's ValueErrors, message for message."""
    _, _, _, _, jcache, tcache = _setup("dit-t2i")
    jt2i = jax_make_workload("t2i", smoke=True)
    jimg = jax_make_workload("image", smoke=True)
    t2i = make_workload("t2i", smoke=True, device="cpu")
    img = make_workload("image", smoke=True, device="cpu")
    vec = np.zeros((t2i.cfg.d_model,), np.float32)

    def serve(wl, cls, cond, **kw):
        eng = wl.engine("none", slots=1, max_steps=NUM_STEPS,
                        conditioner=cond)
        return lambda: eng.serve([cls(0, NUM_STEPS, cfg_scale=2.0, **kw)])

    cases = [
        (serve(jimg, JaxRequest, None, prompt_tokens="cat"),
         serve(img, DiffusionRequest, None, prompt_tokens="cat")),
        (serve(jt2i, JaxRequest, None, prompt_tokens="cat"),
         serve(t2i, DiffusionRequest, None, prompt_tokens="cat")),
        (serve(jt2i, JaxRequest, jcache, prompt_tokens="cat",
               neg_prompt_tokens="dog", null_label=vec),
         serve(t2i, DiffusionRequest, tcache, prompt_tokens="cat",
               neg_prompt_tokens="dog", null_label=vec)),
        (lambda: jimg.engine("none", slots=1, conditioner=jcache),
         lambda: img.engine("none", slots=1, conditioner=tcache)),
    ]
    for jfn, tfn in cases:
        assert _error(tfn) == _error(jfn)
    with pytest.raises(ValueError, match="not text-enabled"):
        CachedDenoiser(img.params, img.cfg, text=tcache.get(PROMPT),
                       device="cpu")
    bad = (np.zeros((3, t2i.cfg.d_model), np.float32), np.ones(3, bool))
    with pytest.raises(ValueError, match="prompt embedding shape"):
        CachedDenoiser(t2i.params, t2i.cfg, text=bad, device="cpu")
    assert dit.block_branches(t2i.cfg)[1] == "cross_attn"
