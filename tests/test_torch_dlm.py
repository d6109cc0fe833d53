"""The port's diffusion LM (`repro_torch.diffusion.dlm`, the survey's §IV-F
dLLM-Cache application) against the JAX package's, on the CPU, at
tinyllama-1.1b SMOKE with the JAX params bridged.

`dlm_forward` is held at 1e-4 abs on canvases with committed tokens.  The
generation loop (policy, cosine commit schedule, per-row top-n commits,
the residual fill) is held exactly: canvas and full-compute counts equal
under exact, FORA 2, TaylorSeer 2 and TeaCache 0.3, with both packages'
`dlm_forward` replaced by one exact function of the canvas (numpy f32
tables).  The model itself cannot decide such a comparison: on the
all-mask canvas every position's logits are mathematically equal (one
token everywhere, attention over identical values), so which positions tie
at the first commit threshold is decided by rounding, which differs
between XLA and torch.  JAX counts `compute_fn` calls, and its TeaCache
branches with `lax.cond`, which traces the compute branch every step: the
computes that ran are its state's `n_compute`, which the port's count
equals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.diffusion.dlm as jax_dlm  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.diffusion import dlm  # noqa: E402

ARCH = "tinyllama-1.1b"
POLICIES = [("none", {}), ("fora", {"interval": 2}),
            ("taylorseer", {"interval": 2}), ("teacache", {"delta": 0.3})]


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_smoke_config(ARCH)
    jp = jax.jit(jax_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), jcfg)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_smoke_config(ARCH), tp


def test_dlm_forward_matches_jax(lm):
    jcfg, jp, cfg, tp = lm
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    toks[:, ::3] = cfg.vocab_size - 1          # some positions still masked
    ref = jax.jit(jax_dlm.dlm_forward, static_argnums=(2,))(
        jp, jnp.asarray(toks, jnp.int32), jcfg)
    out = dlm.dlm_forward(tp, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _table_model(vocab, seq_len, seed=0):
    """logits[b, s] = T[canvas[b, s]] + P[s] + mean_j U[canvas[b, j]], in
    numpy f32: the same values in both packages, distinct per position."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((vocab, vocab)).astype(np.float32)
    P = 3.0 * rng.standard_normal((seq_len, vocab)).astype(np.float32)
    U = rng.standard_normal((vocab, vocab)).astype(np.float32)

    def logits(canvas):
        c = np.asarray(canvas)
        return (T[c] + P[None] + U[c].mean(axis=1, keepdims=True)).astype(
            np.float32)
    return logits


class _Final:
    """A JAX policy that keeps its last state."""

    def __init__(self, policy):
        self.policy, self.state = policy, None

    def init_state(self, *a, **kw):
        return self.policy.init_state(*a, **kw)

    def apply(self, state, step, x, compute_fn, **signals):
        y, self.state = self.policy.apply(state, step, x, compute_fn,
                                          **signals)
        return y, self.state


@pytest.mark.parametrize("name,kw", POLICIES)
def test_dlm_generate_matches_jax(lm, monkeypatch, name, kw):
    jcfg, jp, cfg, tp = lm
    B, S, T = 2, 24, 8
    table = _table_model(cfg.vocab_size, S)
    monkeypatch.setattr(jax_dlm, "dlm_forward",
                        lambda p, c, _cfg: jnp.asarray(table(c)))
    monkeypatch.setattr(dlm, "dlm_forward",
                        lambda p, c, _cfg: torch.from_numpy(table(c.numpy())))
    jpol = _Final(jax_make_policy(name, **kw))
    ref, n_ref = jax_dlm.dlm_generate(jp, jcfg, batch=B, seq_len=S,
                                      num_steps=T, policy=jpol)
    out, n = dlm.dlm_generate(tp, cfg, batch=B, seq_len=S, num_steps=T,
                              policy=make_policy(name, **kw))
    assert out.dtype == torch.long and tuple(out.shape) == (B, S)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ran = int(jpol.state.get("n_compute", n_ref))
    assert n == ran
    if name == "teacache":
        assert n_ref == T and n < T       # JAX counts the traced branch
    else:
        assert n == n_ref
    assert int(out.max()) < cfg.vocab_size - 1


@pytest.mark.parametrize("name,kw", POLICIES)
def test_dlm_generate_on_the_model(lm, name, kw):
    """The model itself: no mask left, and the static policies compute on
    their schedule (FORA and TaylorSeer every other step)."""
    _, _, cfg, tp = lm
    out, n = dlm.dlm_generate(tp, cfg, batch=2, seq_len=16, num_steps=8,
                              policy=make_policy(name, **kw))
    assert int(out.max()) < cfg.vocab_size - 1 and int(out.min()) >= 0
    assert n == {"none": 8, "fora": 4, "taylorseer": 4}.get(name, n)
    assert 1 <= n <= 8


def test_dlm_temperature_draws_follow_the_generator(lm):
    _, _, cfg, tp = lm

    def run(seed):
        return dlm.dlm_generate(tp, cfg, batch=1, seq_len=12, num_steps=4,
                                temperature=1.0,
                                generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1)[0], run(1)[0], run(2)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_commit_counts_follow_jax_f32_cosine():
    """The kept fraction decides int(frac * S); XLA's f32 cosine is not
    correctly rounded, so the counts are compared, not the fractions."""
    S = np.arange(1, 1025)
    for T in range(1, 33):
        for step in range(T):
            want = float(jnp.cos((step + 1) / T * jnp.pi / 2))
            got = dlm._commit_fraction(step, T)
            assert abs(got - want) <= 1e-7
            np.testing.assert_array_equal((got * S).astype(np.int64),
                                          (want * S).astype(np.int64))
