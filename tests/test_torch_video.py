"""The port's video DiT, temporal policies, block stacks and the cached
denoiser's block / deepcache / pab_video granularities against the JAX
package, on the CPU, at SMOKE size (dit-video: 2 layers, d_model 128, 4
heads of 32, 4 frames of 8 patches), with weights bridged from JAX params
and inputs from a numpy seed.  Both factorized attentions run the flash
wrapper's plain version here.

Tolerances: forward, branches and signal 1e-4 abs with f32 params, 5e-2
with bf16 params (f32 sums in another order; bf16 weights); attention
1e-5; policy and stack trajectories 1e-5; denoiser x0 1e-4 abs and 1e-3
rel after 6 DDIM steps, with the compute counts exactly equal.  Every
thresholded decision compared exactly is first checked to lie at least
1e-4 relative from its threshold.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import CachedStack as JaxCachedStack  # noqa: E402
from repro.core import DBCacheStack as JaxDBCacheStack  # noqa: E402
from repro.core import SlotBatchedPolicy as JaxSlots  # noqa: E402
from repro.core import TeaCachePolicy as JaxTeaCache  # noqa: E402
from repro.core import TemporalPABStack as JaxPAB  # noqa: E402
from repro.core import TemporalTeaCachePolicy as JaxTTC  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.diffusion import CachedDenoiser as JaxCachedDenoiser  # noqa: E402
from repro.diffusion import ddim_step as jax_ddim_step  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear_schedule  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.models import video_dit as jax_video  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (CachedStack, DBCacheStack,  # noqa: E402
                              TeaCachePolicy, TemporalPABStack,
                              TemporalTeaCachePolicy, compute_fraction,
                              layer_params, make_policy)
from repro_torch.diffusion import (CachedDenoiser, ddim_step,  # noqa: E402
                                   linear_schedule, sample)
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import dit, video_dit  # noqa: E402

NUM_STEPS = 6
MARGIN = 1e-4


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _model(arch, dtype=None):
    """(jax cfg, port cfg, jax params, bridged params) of `arch`'s SMOKE
    config, built once per case (perturb_zero_init runs jitted: one
    compile instead of one per leaf); another params dtype casts the f32
    model's params."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if dtype is None:
        jp = jax.jit(jax_perturb)(jax_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    else:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
        jp = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                    _model(arch)[2])
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def video():
    return _model("dit-video")


def _jit(fn, cfg_arg=4):
    """fn jitted with its config argument static (one compile per function
    instead of one per eager operation)."""
    return jax.jit(fn, static_argnums=(cfg_arg,))


def _inputs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.dit_tokens, cfg.dit_in_dim)).astype(
        np.float32)
    t = np.array([10.0, 600.0][:B], np.float32)
    y = np.array([1, 7][:B], np.int32)
    return x, t, y


def test_bridge_carries_video_params_leaf_for_leaf(video):
    """to_torch carries init_video_dit's tree with the stacked blocks."""
    jcfg, _, jp, tp = video
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["blocks"]["spatial"]["wq"].shape[0] == jcfg.num_layers
    # the port's own init keeps JAX's draw structure
    own = video_dit.init_video_dit(torch.Generator().manual_seed(0),
                                   get_smoke_config("dit-video"),
                                   device="cpu")
    assert _shapes(own) == _shapes(tp)
    assert torch.equal(own["blocks"]["temporal"]["wq"],
                       own["blocks"]["temporal"]["wk"])


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_video_forward_branches_and_signal_match_jax(dtype, tol):
    jcfg, tcfg, jp, tp = _model("dit-video",
                                None if dtype == "float32" else dtype)
    x, t, y = _inputs(jcfg)
    out = video_dit.forward(tp, _t(x), _t(t), _t(y).long(), tcfg)
    ref = _jit(jax_video.forward)(jp, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(y), jcfg)
    assert out.dtype == torch.float32           # f32 token path
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=tol, rtol=0)

    h, c = video_dit.embed_patches(tp, _t(x), _t(t), _t(y).long(), tcfg)
    jh, jc = _jit(jax_video.embed_patches)(jp, jnp.asarray(x),
                                           jnp.asarray(t), jnp.asarray(y),
                                           jcfg)
    np.testing.assert_allclose(h.numpy(), _np(jh), atol=tol, rtol=0)
    np.testing.assert_allclose(c.float().numpy(), _np(jc), atol=tol, rtol=0)
    sig = video_dit.modulated_signal(tp, h, c, tcfg)
    np.testing.assert_allclose(
        sig.numpy(), _np(_jit(jax_video.modulated_signal, 3)(jp, jh, jc,
                                                             jcfg)),
        atol=tol, rtol=0)
    p0 = layer_params(tp["blocks"], 0)
    jp0 = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    for name in video_dit.BRANCHES:
        got = video_dit.BRANCH_FNS[name](p0, h, c, tcfg)
        want = _jit(jax_video.BRANCH_FNS[name], 3)(jp0, jh, jc, jcfg)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("fold", ["spatial", "temporal"])
def test_factorized_attention_matches_blocked_attention(video, fold):
    """The flash wrapper's CPU path on the two folded shapes of dit-video
    SMOKE (B*F sequences of P, B*P sequences of F), against JAX's
    blocked_attention, non-causal."""
    jcfg = video[0]
    F, P = jcfg.dit_num_frames, jcfg.dit_patch_tokens
    B, S = (2 * F, P) if fold == "spatial" else (2 * P, F)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, S, jcfg.num_heads, jcfg.head_dim))
               .astype(np.float32) for _ in range(3))
    out = flash_attention(_t(q), _t(k), _t(v), causal=False)
    ref = jax_layers.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=False)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=0)


def test_temporal_teacache_per_frame_reduction_fires_on_one_frame():
    """Motion concentrated in one frame refreshes the max-reduced policy
    while the clip-mean distance stays below threshold (JAX's test), and
    each distance equals JAX's."""
    F, P, d = 4, 6, 8
    base = np.ones((1, F * P, d), np.float32)
    moved = base.copy()
    moved[:, :P, :] += 2.0                     # only frame 0 changes
    dist = {}
    for red in ("max", "mean"):
        pol = TemporalTeaCachePolicy(delta=0.2, frames=F, reduce=red)
        got = pol._signal_distance(_t(moved)[None], _t(base)[None])
        want = JaxTTC(0.2, F, reduce=red)._signal_distance(
            jnp.asarray(moved), jnp.asarray(base))
        np.testing.assert_allclose(got.numpy(), [float(want)], rtol=1e-6)
        dist[red] = float(got[0])
    assert dist["max"] > 0.2 > dist["mean"]
    plain = float(TeaCachePolicy(0.2)._signal_distance(
        _t(moved)[None], _t(base)[None])[0])
    np.testing.assert_allclose(
        plain, float(JaxTeaCache(0.2)._signal_distance(jnp.asarray(moved),
                                                       jnp.asarray(base))),
        rtol=1e-6)
    assert abs(plain - dist["mean"]) < dist["max"] / 2


def _signals(S, B, T, d, F, steps, seed):
    """Per step, an (S, B, T, d) signal whose change concentrates in one
    frame per slot, at a slot-dependent rate, so slots decide apart."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((S, B, T, d)).astype(np.float32)
    P = T // F
    out = []
    for s in range(steps):
        sig = base.copy()
        for slot in range(S):
            f = (s + slot) % F
            sig[slot, :, f * P:(f + 1) * P] += (0.15 * (slot + 1) * s
                                                 * rng.standard_normal(
                                                     (B, P, d)))
        out.append(sig)
    return out


# teacache_video's delta for _signals (chosen so that decisions mix with
# the margin kept; a draw that lost it fails)
TTC_DELTA = {"max": 0.6, "mean": 0.25}


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_temporal_teacache_scalar_and_slots_match_jax(reduce):
    """The scalar path pools each call's batch (JAX sums over axis 0); the
    slot path takes one distance per slot (JAX's vmapped policy).  Equal
    decisions (after the margin check), outputs within 1e-5."""
    F, T, d, D = 4, 16, 8, 8
    delta = TTC_DELTA[reduce]
    sigs = _signals(3, 2, T, d, F, 6, seed=5)
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((3, 2, T, D)).astype(np.float32) for _ in sigs]
    tpol = TemporalTeaCachePolicy(delta, F, reduce=reduce)
    jpol = JaxTTC(delta, F, reduce=reduce)
    fn = (lambda v: v * 2.0 + 1.0)

    # scalar path on slot 0's (B=2) batch
    tst = tpol.init_state((2, T, D), device="cpu", signal_shape=(2, T, d))
    jst = jpol.init_state((2, T, D), signal_shape=(2, T, d))
    wants = []
    for step, (sig, x) in enumerate(zip(sigs, xs)):
        m = float(jpol.want_metric(jst, step, jnp.asarray(x[0]),
                                   signal=jnp.asarray(sig[0])))
        if step > 0:
            assert abs(m - delta) / delta >= MARGIN, (step, m)
        yj, jst = jpol.apply(jst, step, jnp.asarray(x[0]), fn,
                             signal=jnp.asarray(sig[0]))
        yt, tst = tpol.apply(tst, step, _t(x[0]), fn, signal=_t(sig[0]))
        np.testing.assert_allclose(yt.numpy(), _np(yj), atol=1e-5)
        np.testing.assert_allclose(float(tst["acc"]), float(jst["acc"]),
                                   rtol=1e-5, atol=1e-6)
        wants.append(int(jst["n_compute"]))
    assert int(tst["n_compute"]) == int(jst["n_compute"])
    assert 1 < wants[-1] < len(sigs)            # both branches taken

    # slot path: 3 slots of one row each (the engine's layout)
    S = 3
    jslots = JaxSlots(jpol, S)
    jst = jslots.init_state((1, T, D), signal_shape=(1, T, d))
    tst = {k: v[None].expand((S,) + tuple(v.shape)).clone()
           for k, v in tpol.init_state((T, D), device="cpu",
                                       signal_shape=(T, d)).items()}
    n_mixed = 0
    for step, (sig, x) in enumerate(zip(sigs, xs)):
        steps = np.full((S,), step, np.int32)
        jsig, jx = jnp.asarray(sig[:, :1]), jnp.asarray(x[:, :1])
        jwant = np.asarray(jslots.want_compute(jst, jnp.asarray(steps), jx,
                                               signal=jsig))
        metric = np.asarray(jax.vmap(
            lambda st, xx, sg: jpol.want_metric(st, step, xx, signal=sg))(
                jst, jx, jsig))
        if step > 0:
            assert (np.abs(metric - delta) / delta >= MARGIN).all(), metric
        w = tpol.want_slots(tst, steps, _t(x[:, 0]), _t(sig[:, 0]))
        np.testing.assert_array_equal(w.want.numpy(), jwant)
        np.testing.assert_allclose(w.metric.numpy(), metric, rtol=1e-5)
        n_mixed += 0 < jwant.sum() < S
        yj, jst = jslots.apply(jst, jnp.asarray(steps), jx,
                               lambda v: v * 2.0 + 1.0, signal=jsig)
        ys = _t(x[:, 0]) * 2.0 + 1.0
        yt, tst = tpol.apply_slots(tst, steps, _t(x[:, 0]), ys,
                                   want=w.want.numpy(), signal=_t(sig[:, 0]))
        np.testing.assert_allclose(yt.numpy(), _np(yj)[:, 0], atol=1e-5)
    np.testing.assert_array_equal(tst["n_compute"].numpy(),
                                  np.asarray(jst["n_compute"]))
    assert n_mixed > 0                          # the slots decided apart


def test_temporal_pab_stack_matches_jax(video):
    """TemporalPABStack over dit-video SMOKE's branches: the trajectory
    (fresh x and c each step), the schedule and compute_fraction."""
    jcfg, tcfg, jp, tp = video
    jstack = JaxPAB(jax_video.pab_branch_fns(jcfg), jcfg.num_layers)
    tstack = TemporalPABStack(video_dit.pab_branch_fns(tcfg), tcfg.num_layers)
    assert tstack.intervals == jstack.intervals
    assert tstack.static_schedule(NUM_STEPS) == jstack.static_schedule(
        NUM_STEPS)
    assert tstack.compute_fraction(NUM_STEPS) == pytest.approx(
        jstack.compute_fraction(NUM_STEPS))
    shape = (1, jcfg.dit_tokens, jcfg.d_model)
    jst, tst = jstack.init(shape), tstack.init(shape, device="cpu")
    calls = {k: 0 for k in tstack.branch_fns}

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    tstack.branch_fns = {k: counted(k, f) for k, f in
                         tstack.branch_fns.items()}
    rng = np.random.default_rng(8)
    for step in range(6):
        x = rng.standard_normal(shape).astype(np.float32)
        c = rng.standard_normal((1, jcfg.d_model)).astype(np.float32)
        yj, jst = jstack(jst, step, jnp.asarray(x), jp["blocks"],
                         jnp.asarray(c))
        yt, tst = tstack(tst, step, _t(x), tp["blocks"], _t(c))
        np.testing.assert_allclose(yt.numpy(), _np(yj), atol=1e-5,
                                   err_msg=f"step {step}")
        for i in range(jcfg.num_layers):
            for k in tstack.branch_fns:
                np.testing.assert_allclose(tst[i][k].numpy(),
                                           _np(jst[k][i]), atol=1e-5)
    for k, iv in tstack.intervals.items():
        assert calls[k] == jcfg.num_layers * len(range(0, 6, iv)), k


def _block_fn(p, x, c):
    return x + 0.5 * jnp.tanh(x @ p["w"] + p["b"]) * c


def _tblock_fn(p, x, c):
    return x + 0.5 * torch.tanh(x @ p["w"] + p["b"]) * c


def _stack_params(L=6, d=16, seed=9):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, d, d)) / d ** 0.5).astype(np.float32),
            "b": (0.1 * rng.standard_normal((L, d))).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [("fora", {"interval": 2}),
                                     ("taylorseer", {"interval": 3})])
def test_cached_stack_matches_jax(name, kw):
    P = _stack_params()
    L = P["w"].shape[0]
    jstack = JaxCachedStack(_block_fn, jax_make_policy(name, **kw), L)
    tstack = CachedStack(_tblock_fn, make_policy(name, **kw), L)
    shape = (2, 8, 16)
    jst, tst = jstack.init(shape), tstack.init(shape, device="cpu")
    jP = {k: jnp.asarray(v) for k, v in P.items()}
    tP = {k: _t(v) for k, v in P.items()}
    rng = np.random.default_rng(10)
    x0 = rng.standard_normal(shape).astype(np.float32)
    for step in range(7):
        x = x0 + 0.1 * step
        yj, jst = jstack(jst, step, jnp.asarray(x), jP, 1.0)
        yt, tst = tstack(tst, step, _t(x), tP, 1.0)
        np.testing.assert_allclose(yt.numpy(), _np(yj), atol=1e-5)
    for i in range(L):
        for k, v in tst[i].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jst[k][i]),
                                       atol=1e-5, err_msg=k)


def test_dbcache_stack_matches_jax():
    """Probe -> decide -> correct: equal outputs and equal refresh
    decisions (each probe change first checked 1e-4 relative from the
    threshold), counted on the port by its middle-section block calls."""
    P = _stack_params()
    L, F, B, thr = P["w"].shape[0], 2, 2, 0.02
    jstack = JaxDBCacheStack(_block_fn, L, F, B, thr)
    calls = []

    def counted(p, x, c):
        calls.append(1)
        return _tblock_fn(p, x, c)

    tstack = DBCacheStack(counted, L, F, B, thr)
    shape = (2, 8, 16)
    jst, tst = jstack.init(shape), tstack.init(shape, device="cpu")
    jP = {k: jnp.asarray(v) for k, v in P.items()}
    tP = {k: _t(v) for k, v in P.items()}
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal(shape).astype(np.float32)
    drift = rng.standard_normal(shape).astype(np.float32)
    # DBCache decides from its state, not the step: one compile serves all
    jrun = jax.jit(lambda st, x: jstack(st, 0, x, jP, 1.0))
    refreshes = []
    for step, amp in enumerate([0.0, 0.002, 0.004, 0.05, 0.052, 0.2, 0.201]):
        x = x0 + amp * drift
        prev = np.asarray(jst["prev_probe"])
        yj, jst = jrun(jst, jnp.asarray(x))
        probe = np.asarray(jst["prev_probe"])
        change = np.abs(probe - prev).sum() / (np.abs(probe).sum() + 1e-8)
        if step > 0:
            assert abs(change - thr) / thr >= MARGIN, (step, change)
        refreshes.append(step == 0 or change > thr)
        n0 = len(calls)
        yt, tst = tstack(tst, step, _t(x), tP, 1.0)
        assert len(calls) - n0 == F + B + (L - F - B) * refreshes[-1], step
        np.testing.assert_allclose(yt.numpy(), _np(yj), atol=1e-5)
        np.testing.assert_allclose(tst["mid_cache"].numpy(),
                                   np.asarray(jst["mid_cache"]), atol=1e-5)
    assert int(tst["n"]) == int(jst["n"]) == 7
    assert any(refreshes[1:]) and not all(refreshes[1:])


def test_compute_fraction_matches_jax():
    from repro.core import compute_fraction as jax_cf
    for sched in ([True, False, False, True], [], [1, 1, 0]):
        assert compute_fraction(sched) == jax_cf(sched)


_DENOISER_CASES = [
    ("dit-xl", "block", "fora", {"interval": 2}),
    ("dit-xl", "deepcache", "delta_dit", {"interval": 2}),
    ("dit-video", "block", "taylorseer", {"interval": 3}),
    ("dit-video", "deepcache", "delta_dit", {"interval": 2}),
    ("dit-video", "pab_video", None, {}),
]


@pytest.mark.parametrize("arch,gran,name,kw", _DENOISER_CASES)
def test_cached_denoiser_granularities_match_jax(arch, gran, name, kw):
    """6 DDIM steps of CachedDenoiser at block, deepcache (shallow_n 1) and
    pab_video granularity on dit-xl and dit-video SMOKE; x0 within 1e-4
    abs and 1e-3 rel, and the blocks (or branches) the port computed equal
    the count JAX's static schedule gives."""
    jcfg, tcfg, jp, tp = _model(arch)
    jpol = jax_make_policy(name, **kw) if name else None
    tpol = make_policy(name, **kw) if name else None
    xT = np.random.default_rng(2).standard_normal(
        (1, jcfg.dit_tokens, jcfg.dit_in_dim)).astype(np.float32)
    jsched = jax_linear_schedule(200)
    jden = JaxCachedDenoiser(jp, jcfg, jpol, granularity=gran, shallow_n=1)
    ref, _ = jax_sample(jden, jnp.asarray(xT), jsched.spaced(NUM_STEPS),
                        jsched, step_fn=jax_ddim_step,
                        denoiser_state=jden.init_state(1))
    sched = linear_schedule(200)
    den = CachedDenoiser(tp, tcfg, tpol, granularity=gran, shallow_n=1,
                         device="cpu")
    calls = []
    if gran == "pab_video":
        den._stack.branch_fns = {
            k: (lambda *a, f=f, k=k: calls.append(k) or f(*a))
            for k, f in den._stack.branch_fns.items()}
        sched_j = jden._stack.static_schedule(NUM_STEPS)
        want = round(sum(sched_j) * len(jden._stack.branch_fns)
                     * jcfg.num_layers)
    else:
        blk = den._block
        if gran == "block":
            den._stack.block_fn = (lambda *a: calls.append(1) or blk(*a))
        else:
            den._block = (lambda *a: calls.append(1) or blk(*a))
        n_c = sum(jpol.static_schedule(NUM_STEPS))
        deep = jcfg.num_layers - (1 if gran == "deepcache" else 0)
        want = n_c * deep + (NUM_STEPS if gran == "deepcache" else 0)
    x0, _ = sample(den, _t(xT), sched.spaced(NUM_STEPS), sched,
                   step_fn=ddim_step, denoiser_state=den.init_state(1))
    assert len(calls) == want
    np.testing.assert_allclose(x0.numpy(), _np(ref), atol=1e-4, rtol=1e-3)


def test_structural_granularities_reject_what_they_cannot_run():
    cfg = get_smoke_config("dit-xl")
    params = dit.init_dit(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    with pytest.raises(ValueError, match="video"):
        CachedDenoiser(params, cfg, granularity="pab_video", device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        CachedDenoiser(params, cfg, granularity="layer", device="cpu")
    # a text-enabled config adds the cross branch after spatial attention
    text = dataclasses.replace(get_smoke_config("dit-video"), dit_text_len=4)
    assert list(video_dit.pab_branch_fns(text)) == [
        "spatial_attn", "cross_attn", "temporal_attn", "mlp"]
    with pytest.raises(ValueError, match="middle"):
        DBCacheStack(_tblock_fn, 4, 2, 2)
