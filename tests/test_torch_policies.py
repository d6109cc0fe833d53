"""The port's cache policies against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through both packages: the
metrics, a 10-step single trajectory of each of the 13 policies this slice
ports (JAX `apply` at a traced step, the port's at an int step, compute_fn
= 3 tanh as in tests/test_serving_diffusion.py), a slot round over 3 slots
at staggered steps against JAX's `SlotBatchedPolicy.apply`, FoCa's forecast
weights against `_foca_forecast`, k-means, and the registry.

Tolerances: metrics 1e-6 relative; outputs and every state leaf 1e-5 abs
(f32 sums in another order); compute decisions exactly.  A decision that
thresholds an f32 reduction is compared exactly only where the JAX side's
value lies at least 1e-4 relative from its threshold (`_assert_margin`);
the trajectory (a drift at varying speed, made so that both branches run)
and the thresholds below are chosen so that every decision has that margin,
and a draw that lost it would fail the test, not be skipped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core import POLICY_REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.core import STRUCTURAL_POLICIES as JAX_STRUCTURAL  # noqa: E402
from repro.core import SlotBatchedPolicy as JaxSlotBatched  # noqa: E402
from repro.core import cache_state_bytes as jax_state_bytes  # noqa: E402
from repro.core import kmeans as jax_kmeans  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.core import metrics as jm  # noqa: E402
from repro.core.learned import init_gate as jax_init_gate  # noqa: E402
from repro.core.predictive import _foca_forecast  # noqa: E402
from repro.core.predictive import forecast_from_diffs  # noqa: E402
from repro_torch.core import (NOT_PORTED, POLICY_REGISTRY,  # noqa: E402
                              STRUCTURAL_POLICIES, cache_state_bytes, kmeans,
                              make_policy)
from repro_torch.core import metrics as tm  # noqa: E402
from repro_torch.core import SlotBatchedPolicy, stack_slots  # noqa: E402
from repro_torch.kernels.forecast import basis_coeffs, forecast  # noqa: E402

NAMES = ["delta_dit", "pab", "foca", "freqca", "teacache", "magcache",
         "easycache", "foresight", "blockcache", "lazydit", "toca", "clusca",
         "speca"]
SHAPE, SIG_SHAPE = (1, 32, 4), (1, 32, 8)
STEPS = 10
# the gated policies' thresholds for these inputs: each splits the 10 steps
# into computes and reuses, with every decision >= 1e-4 relative from it
PROFILE = [0.0, 0.04, 0.07, 0.02, 0.09, 0.03, 0.05, 0.08, 0.01, 0.06]
KW = {"teacache": {"delta": 0.1}, "magcache": {"delta": 0.1,
                                                "num_steps": STEPS},
      "easycache": {"tau": 5.0}, "foresight": {"gamma": 1.0},
      "lazydit": {"threshold": 0.505}, "blockcache": {"profile": PROFILE},
      "clusca": {"k": 4}}
# ClusCa at k = 4 over 32 tokens: no cluster of two members, whose centroid
# is equidistant from both (a tie XLA and torch round apart: reps differ)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _gate():
    """A LazyDiT gate from JAX's init_gate, its weights scaled so that the
    score moves visibly with the drift of these inputs."""
    g = jax_init_gate(jax.random.PRNGKey(4), SHAPE[-1])
    return {"w": g["w"] * 40.0, "b": g["b"]}


def _pair(name):
    """The JAX policy and the port's, from each registry."""
    kw = dict(KW.get(name, {}))
    tkw = dict(kw)
    if name == "lazydit":
        kw["gate"] = _gate()
        tkw["gate"] = {k: _t(np.asarray(v)) for k, v in kw["gate"].items()}
    return jax_make_policy(name, **kw), make_policy(name, **tkw)


def _trajectory(seed=0, shape=SHAPE, sig_shape=SIG_SHAPE):
    """x_t and the signal drift along fixed directions at varying speed."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.3, 1.7, STEPS).cumsum().astype(np.float32)
    base, dirx = (rng.standard_normal(shape, np.float32) for _ in range(2))
    sbase, dirs = (rng.standard_normal(sig_shape, np.float32)
                   for _ in range(2))
    xs = [base + 0.05 * s * dirx for s in speed]
    sigs = [sbase + 0.04 * s * dirs for s in speed]
    return xs, sigs


def _compute(x):
    return 3.0 * jnp.tanh(x)


def _jax_gate(name, pol, state, step, x, sig):
    """(forced, value, threshold) of a gated JAX policy's decision, or None
    for one that decides from the step alone."""
    st = {k: np.asarray(v) for k, v in state.items()}
    if name == "teacache":
        v = float(pol.want_metric(state, step, x, signal=sig))
        return st["n"] == 0, v, pol.delta
    if name == "magcache":
        return st["n"] == 0, float(pol.want_metric(state, step, x)), pol.delta
    if name == "lazydit":
        return (st["n"] == 0, float(pol.want_metric(state, step, x)),
                pol.threshold)
    if name == "easycache":
        xf = np.asarray(x, np.float32)
        dx = np.linalg.norm((xf - st["prev_x"]).ravel())
        vn = np.linalg.norm(st["prev_v"].ravel()) + 1e-8
        return (st["n"] < pol.warmup,
                float(st["acc"] + st["k"] * dx / vn * 100.0), pol.tau)
    if name == "foresight":
        d = float(jm.rel_l1_block(jnp.asarray(x), state["prev_in"]))
        return st["n"] < pol.warmup, d, pol.gamma * float(st["lam"])
    return None


def _assert_margin(name, gate, step):
    if gate is None or gate[0]:
        return
    _, value, thr = gate
    rel = abs(value - thr) / max(abs(thr), 1e-12)
    assert rel >= 1e-4, (f"{name} step {step}: value {value} lies {rel:.2e} "
                         f"relative from its threshold {thr}")


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rel_l1", "rel_l1_block", "rel_l2",
                                  "mag_ratio", "transform_rate",
                                  "cosine_sim", "psnr"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(1)
    args = [rng.standard_normal((2, 16, 8), np.float32) for _ in range(4)]
    n = 4 if name == "transform_rate" else 2
    ref = float(getattr(jm, name)(*map(jnp.asarray, args[:n])))
    got = float(getattr(tm, name)(*map(_t, args[:n])))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_slot_metrics_reduce_each_slot():
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((3, 5, 7), np.float32) for _ in range(2))
    for fn, ref in ((tm.rel_l1_slots, jm.rel_l1),
                    (tm.rel_l1_block_slots, jm.rel_l1_block)):
        got = fn(_t(a), _t(b)).numpy()
        want = [float(ref(jnp.asarray(a[s]), jnp.asarray(b[s])))
                for s in range(3)]
        np.testing.assert_allclose(got, want, rtol=1e-6)


# -- one trajectory -----------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_jax(name):
    """10 steps through JAX `apply` (traced step, jit) and the port's (int
    step): every output and state leaf within 1e-5 abs, the same compute
    count, every thresholded decision well posed."""
    jpol, tpol = _pair(name)
    xs, sigs = _trajectory()
    jkw = {"signal_shape": SIG_SHAPE} if jpol.uses_signal else {}
    tkw = {"signal_shape": SIG_SHAPE} if tpol.uses_signal else {}
    jstate = jpol.init_state(SHAPE, **jkw)
    tstate = tpol.init_state(SHAPE, device="cpu", **tkw)
    japply = jax.jit(lambda st, k, x, s: jpol.apply(st, k, x, _compute,
                                                    signal=s))
    jwant = jax.jit(lambda st, k, x, s: jpol.want_compute(st, k, x,
                                                          signal=s))
    j_count = t_count = 0
    for step, (x, sig) in enumerate(zip(xs, sigs)):
        k = jnp.asarray(step, jnp.int32)
        _assert_margin(name, _jax_gate(name, jpol, jstate, k, x, sig), step)
        j_count += int(bool(jwant(jstate, k, x, sig)))
        jy, jstate = japply(jstate, k, jnp.asarray(x), jnp.asarray(sig))
        calls = []

        def f(xx):
            calls.append(1)
            return 3.0 * torch.tanh(xx)

        ty, tstate = tpol.apply(tstate, step, _t(x), f, signal=_t(sig))
        t_count += len(calls)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0, err_msg=f"{name} step {step}")
        assert sorted(tstate) == sorted(jstate)
        for leaf in jstate:
            np.testing.assert_allclose(
                tstate[leaf].numpy(), np.asarray(jstate[leaf]), atol=1e-5,
                rtol=0, err_msg=f"{name} step {step} leaf {leaf}")
    assert t_count == j_count, (name, t_count, j_count)
    assert 0 < t_count <= STEPS
    if name not in ("toca",):     # a ToCa step always runs the module
        assert t_count < STEPS, f"{name} never reused its cache"


@pytest.mark.parametrize("name", NAMES)
def test_want_compute_mirrors_apply(name):
    """The port's `want_compute` before each step predicts whether `apply`
    calls compute_fn."""
    _, pol = _pair(name)
    xs, sigs = _trajectory(seed=3)
    kw = {"signal_shape": SIG_SHAPE} if pol.uses_signal else {}
    state = pol.init_state(SHAPE, device="cpu", **kw)
    for step, (x, sig) in enumerate(zip(xs, sigs)):
        want = bool(pol.want_compute(state, step, _t(x), signal=_t(sig)))
        calls = []
        _, state = pol.apply(
            state, step, _t(x),
            lambda xx: calls.append(1) or 3.0 * torch.tanh(xx),
            signal=_t(sig))
        assert want == bool(calls), (name, step)


# -- the slot round -----------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_apply_slots_matches_jax_slot_batched(name):
    """3 slots at staggered steps, 7 rounds: the port plans each round on
    the device (`SlotBatchedPolicy.want_compute`, as the engine does),
    feeds the fresh rows where a slot computes (zeros elsewhere) into
    `apply_slots`; JAX's
    `SlotBatchedPolicy.apply` vmaps `apply` per slot.  Outputs and states
    within 1e-5 abs; decisions exactly."""
    S, shape, sig_shape = 3, SHAPE[1:], SIG_SHAPE[1:]
    jpol, tpol = _pair(name)
    jb = JaxSlotBatched(jpol, S)
    jstates = jb.init_state(shape, signal_shape=sig_shape)
    tb = SlotBatchedPolicy(tpol, S)
    tstates = stack_slots(tb.init_slot_state(shape, signal_shape=sig_shape,
                                             device="cpu"), S)
    trajs = [_trajectory(seed=10 + s, shape=shape, sig_shape=sig_shape)
             for s in range(S)]
    offset = np.array([0, 1, 3])
    japply = jax.jit(lambda st, k, x, sg: jb.apply(st, k, x, _compute,
                                                   signal=sg))
    jwant = jax.jit(lambda st, k, x, sg: jb.want_compute(st, k, x, signal=sg))
    wants = []
    for r in range(STEPS - offset.max()):
        steps = (r + offset).astype(np.int32)
        x = np.stack([trajs[s][0][steps[s]] for s in range(S)])
        sig = np.stack([trajs[s][1][steps[s]] for s in range(S)])
        want = tb.want_compute(tstates, steps, _t(x), _t(sig)).want.numpy()
        wants.append(want)
        np.testing.assert_array_equal(
            want, np.asarray(jwant(jstates, jnp.asarray(steps), x, sig)))
        for s in range(S):
            js = jax.tree_util.tree_map(lambda a, s=s: a[s], jstates)
            _assert_margin(name, _jax_gate(name, jpol, js, steps[s], x[s],
                                           sig[s]), r)
        jy, jstates = japply(jstates, jnp.asarray(steps), jnp.asarray(x),
                             jnp.asarray(sig))
        ys = torch.where(_t(want).view(S, 1, 1), 3.0 * torch.tanh(_t(x)),
                         torch.zeros(()))
        ty, tstates = tpol.apply_slots(tstates, steps, _t(x), ys, want=want,
                                       signal=_t(sig))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0, err_msg=f"{name} round {r}")
        for leaf in jstates:
            np.testing.assert_allclose(
                tstates[leaf].numpy(), np.asarray(jstates[leaf]), atol=1e-5,
                rtol=0, err_msg=f"{name} round {r} leaf {leaf}")
    wants = np.stack(wants)
    assert wants.any() and (name == "toca" or not wants.all()), wants


# -- the token paths: subset_fn / verify_fn ----------------------------------

def _subset(x, *mask):
    """A token-local module: 3 tanh of the given tokens (ToCa passes its
    recompute mask too and gets every token back)."""
    return 3.0 * (jnp.tanh(x) if isinstance(x, jax.Array) else torch.tanh(x))


def _verify(x, y_hat):
    ref = 3.0 * (jnp.tanh(x) if isinstance(x, jax.Array) else torch.tanh(x))
    return (jm.rel_l2(y_hat, ref) if isinstance(x, jax.Array)
            else tm.rel_l2(y_hat, ref))


@pytest.mark.parametrize("name,kw,signal", [
    ("clusca", {"k": 4}, "subset_fn"),
    ("toca", {}, "subset_fn"),
    ("speca", {"tau": 0.05}, "subset_fn"),
    ("speca", {"tau": 0.05}, "verify_fn"),
])
def test_token_paths_match_jax(name, kw, signal):
    """The policy-level token paths (a cached step through `subset_fn`, a
    draft verified by a probe or by `verify_fn`), 10 steps in both
    packages: outputs and state leaves within 1e-5 abs.  SpeCa's tau 0.05
    splits these drafts into accepts and rejects; each verified error lies
    at least 1e-4 relative from it."""
    jpol, tpol = jax_make_policy(name, **kw), make_policy(name, **kw)
    fn = _subset if signal == "subset_fn" else _verify
    xs, _ = _trajectory(seed=6)
    jstate, tstate = jpol.init_state(SHAPE), tpol.init_state(SHAPE,
                                                             device="cpu")
    japply = jax.jit(lambda st, k, x: jpol.apply(st, k, x, _compute,
                                                 **{signal: fn}))
    for step, x in enumerate(xs):
        if name == "speca" and step % jpol.interval:
            u = np.float32(step - int(jstate["last_step"])) / jpol.interval
            y_hat = forecast_from_diffs(jstate["diffs"], u,
                                        jstate["n_valid"], "taylor")
            if signal == "verify_fn":
                err = float(_verify(jnp.asarray(x), y_hat))
            else:
                idx = jpol._probe_idx(SHAPE[-2])
                err = float(jm.rel_l2(y_hat[0][idx],
                                      3.0 * jnp.tanh(x[0][idx])))
            assert abs(err - jpol.tau) / jpol.tau >= 1e-4, (step, err)
        jy, jstate = japply(jstate, jnp.asarray(step, jnp.int32),
                            jnp.asarray(x))
        ty, tstate = tpol.apply(tstate, step, _t(x),
                                lambda xx: 3.0 * torch.tanh(xx),
                                **{signal: fn})
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0, err_msg=f"{name} step {step}")
        for leaf in jstate:
            np.testing.assert_allclose(
                tstate[leaf].numpy(), np.asarray(jstate[leaf]), atol=1e-5,
                rtol=0, err_msg=f"{name} step {step} leaf {leaf}")
    if name == "speca":
        assert int(tstate["accepts"]) > 0 and int(tstate["rejects"]) > 0


# -- FoCa, k-means, registry -------------------------------------------------

@pytest.mark.parametrize("n_valid", [1, 2, 3])
def test_foca_weights_match_foca_forecast(n_valid):
    """d[0] + min(ceil(u), 64) d[1] (d[0] alone below two computes) against
    the iterated BDF2 + Heun `_foca_forecast`, within 1e-5 of the scale."""
    rng = np.random.default_rng(n_valid)
    diffs = (rng.standard_normal((3, 2, 64, 16)) * 4.0).astype(np.float32)
    for u in np.linspace(0.1, 2.5, 13, dtype=np.float32):
        ref = np.asarray(_foca_forecast(jnp.asarray(diffs), u, n_valid))
        c = basis_coeffs(2, torch.tensor(u), "foca", n_valid=n_valid)
        got = forecast(_t(diffs), c).numpy()
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0,
                                   err_msg=f"u={u}")


@pytest.mark.parametrize("k", [3, 40])
def test_kmeans_matches_jax(k):
    """Three well-separated clusters (k = 3), and k > T (clamped to T)."""
    rng = np.random.default_rng(5)
    centers = np.array([[8, 0], [0, 8], [-8, -8]], np.float32)
    pts = np.concatenate([c + rng.standard_normal((10, 2)).astype(np.float32)
                          for c in centers])
    pts = pts[rng.permutation(len(pts))]
    ja, jc, jr = jax_kmeans(jnp.asarray(pts), k)
    ta, tc, tr = kmeans(_t(pts), k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    assert tc.shape[0] == min(k, len(pts))
    if k == 3:
        assert len(set(ta.numpy().tolist())) == 3


HYPER = ("name", "interval", "order", "basis", "sigma", "delta", "poly",
         "tau", "warmup", "gamma", "threshold", "ratio", "lambdas", "k",
         "kmeans_iters", "cutoff", "axis", "probe", "module_type", "profile")


@pytest.mark.parametrize("name", sorted(POLICY_REGISTRY))
def test_registry_builds_every_name_with_jax_defaults(name):
    """The same hyper-parameters as the JAX registry's, and the same cache
    state bytes."""
    kw = {"lazydit": {"gate": _gate()}, "blockcache": {"profile": PROFILE}
          }.get(name, {})
    tkw = dict(kw)
    if name == "lazydit":
        tkw["gate"] = {k: _t(np.asarray(v)) for k, v in kw["gate"].items()}
    jpol, tpol = jax_make_policy(name, **kw), make_policy(name, **tkw)
    for attr in HYPER:
        if hasattr(jpol, attr):
            assert getattr(tpol, attr) == getattr(jpol, attr), attr
    if hasattr(jpol, "gammas"):
        np.testing.assert_array_equal(tpol.gammas, np.asarray(jpol.gammas))
    jkw = {"signal_shape": SIG_SHAPE} if jpol.uses_signal else {}
    tkw = {"signal_shape": SIG_SHAPE} if tpol.uses_signal else {}
    assert tpol.uses_signal == jpol.uses_signal
    assert tpol.is_predictive == jpol.is_predictive
    assert (cache_state_bytes(tpol.init_state(SHAPE, device="cpu", **tkw))
            == jax_state_bytes(jpol.init_state(SHAPE, **jkw)))


def test_registry_errors():
    assert len(POLICY_REGISTRY) == 21
    assert set(POLICY_REGISTRY) == set(JAX_REGISTRY)
    assert not NOT_PORTED
    assert set(STRUCTURAL_POLICIES) == set(JAX_STRUCTURAL)
    for name in STRUCTURAL_POLICIES:
        with pytest.raises(KeyError, match="structural"):
            make_policy(name)
    with pytest.raises(KeyError, match="unknown"):
        make_policy("no-such-policy")
    with pytest.raises(ValueError, match="gate"):
        make_policy("lazydit")
    with pytest.raises(ValueError, match="profile"):
        make_policy("blockcache")
