"""The port's noise schedules and samplers against the JAX package, on the
CPU: the cosine schedule and the rectified-flow grid exactly in f32, the
DPM-Solver++(2M) and rectified-flow Euler trajectories within 1e-5, and
DDPM's mean and sigma against JAX's, its noise term against the
generator's own draw (torch cannot reproduce `jax.random`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.diffusion import cosine_schedule as jax_cosine  # noqa: E402
from repro.diffusion import ddpm_step as jax_ddpm_step  # noqa: E402
from repro.diffusion import dpmpp_2m_step as jax_dpmpp  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear  # noqa: E402
from repro.diffusion import rectified_flow_times as jax_rf_times  # noqa: E402
from repro.diffusion import rf_euler_step as jax_rf_euler  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro_torch.diffusion import (cosine_schedule, ddpm_step,  # noqa: E402
                                   dpmpp_2m_step, linear_schedule,
                                   rectified_flow_times, rf_euler_step,
                                   sample)

SHAPE = (2, 8, 4)


def _x():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


def _jax_denoise(state, i, x, t):
    return 0.5 * jnp.tanh(x) + 0.01 * i, state


def _denoise(state, i, x, t):
    return 0.5 * torch.tanh(x) + 0.01 * i, state


@pytest.mark.parametrize("T", [1000, 50])
def test_cosine_schedule_exact(T):
    j, t = jax_cosine(T), cosine_schedule(T)
    for name in ("betas", "alphas", "alpha_bars"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b.astype(np.float32))
    np.testing.assert_array_equal(t.spaced(17), j.spaced(17))


@pytest.mark.parametrize("n", [1, 16, 50])
def test_rectified_flow_times_exact(n):
    got = rectified_flow_times(n)
    assert got.dtype == np.float32 and got.shape == (n + 1,)
    np.testing.assert_array_equal(got, jax_rf_times(n).astype(np.float32))


@pytest.mark.parametrize("sched_fn", ["linear", "cosine"])
def test_dpmpp_2m_trajectory_matches_jax(sched_fn):
    js = {"linear": jax_linear, "cosine": jax_cosine}[sched_fn](1000)
    ts_ = {"linear": linear_schedule, "cosine": cosine_schedule}[sched_fn](
        1000)
    ts = js.spaced(12)
    jx, _ = jax_sample(_jax_denoise, jnp.asarray(_x()), ts, js,
                       step_fn=jax_dpmpp)
    x, _ = sample(_denoise, torch.from_numpy(_x()), ts, ts_,
                  step_fn=dpmpp_2m_step)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)


def test_rf_euler_trajectory_matches_jax():
    """len(times) - 1 steps, as JAX's loop runs; x within 1e-5."""
    times = rectified_flow_times(10)
    calls = []

    def counted(state, i, x, t):
        calls.append(float(t[0]))
        return _denoise(state, i, x, t)

    jx, _ = jax_sample(_jax_denoise, jnp.asarray(_x()), times, None,
                       step_fn=jax_rf_euler)
    x, _ = sample(counted, torch.from_numpy(_x()), times, None,
                  step_fn=rf_euler_step)
    assert len(calls) == 10 and calls[0] == 1.0
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)


def _mean_sigma(step):
    """(mean, sigma) of a noisy step from two draws: out_k = mean + sigma
    n_k, with step(k) -> (out_k, n_k)."""
    (o1, n1), (o2, n2) = step(1), step(2)
    sigma = float(np.median((o1 - o2) / (n1 - n2)))
    return o1 - sigma * n1, sigma


@pytest.mark.parametrize("i", [0, 5, 10])
def test_ddpm_step_matches_jax(i):
    """DDPM at steps 0, 5 and 10 of 12: the mean and sigma JAX's step
    uses, and the noise term is exactly sigma times the generator's own
    next draw.  The last step adds no noise and equals JAX's output."""
    sched, jsched = linear_schedule(1000), jax_linear(1000)
    ts = sched.spaced(12)
    x = _x()
    eps = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)

    def jax_step(k):
        key = jax.random.PRNGKey(k)
        out, _ = jax_ddpm_step(jnp.asarray(x), jnp.asarray(eps), i, ts,
                               jsched, key, {})
        return np.asarray(out), np.asarray(jax.random.normal(key, SHAPE))

    def torch_step(k):
        out, _ = ddpm_step(torch.from_numpy(x), torch.from_numpy(eps), i, ts,
                           sched, torch.Generator().manual_seed(k), {})
        noise = torch.randn(SHAPE, generator=torch.Generator().manual_seed(k))
        return out.numpy(), noise.numpy()

    jm, jsig = _mean_sigma(jax_step)
    tm, tsig = _mean_sigma(torch_step)
    assert tsig == pytest.approx(jsig, rel=1e-5) and tsig > 0
    np.testing.assert_allclose(tm, jm, atol=1e-5, rtol=1e-5)
    out, noise = torch_step(7)
    np.testing.assert_allclose(out, tm + tsig * noise, atol=1e-5, rtol=1e-5)

    last, _ = ddpm_step(torch.from_numpy(x), torch.from_numpy(eps), 11, ts,
                        sched, None, {})
    jlast, _ = jax_ddpm_step(jnp.asarray(x), jnp.asarray(eps), 11, ts,
                             jsched, jax.random.PRNGKey(0), {})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-5,
                               rtol=1e-5)


def test_ddpm_sample_draws_from_the_generator():
    sched = linear_schedule(1000)
    ts = sched.spaced(6)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return sample(_denoise, torch.from_numpy(_x()), ts, sched,
                      step_fn=ddpm_step, generator=gen)[0]

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    torch.testing.assert_close(run(None), run(0), rtol=0, atol=0)
    assert float((run(3) - run(4)).abs().max()) > 1e-3
