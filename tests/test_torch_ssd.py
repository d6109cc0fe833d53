"""The port's SSD scan and Mamba2 block against the JAX package, on the CPU.

On the CPU `ssd_scan` runs its plain version (`ssd_chunked`), the
arithmetic the CUDA kernel must reproduce and what chip_smoke.py compares
the kernel with on the card.  It is held against the JAX Pallas kernel in
interpret mode and against JAX's `ssd_ref`, at the shapes of
`test_kernels.py`'s ssd cases plus a ragged length, with the kernel tests'
tolerance: 2e-4 abs / 1e-3 rel (f32 sums in another order).  Inputs come
from a numpy seed and go through both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.kernels.ssd import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-3)
# jit the JAX side: one compile per shape instead of an eager dispatch per op
jax_ssd_ref_jit = jax.jit(jax_ssd_ref, static_argnames=("chunk",))
jax_mamba2_forward = jax.jit(jax_ssm.mamba2_forward, static_argnums=(2,))
jax_mamba2_decode = jax.jit(jax_ssm.mamba2_decode, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, (h,))).astype(np.float32)
    B_ = rng.standard_normal((b, s, n), np.float32)
    C_ = rng.standard_normal((b, s, n), np.float32)
    return x, dt, A, B_, C_


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 16, 8, 32),
    (1, 128, 1, 32, 16, 64),
    (1, 96, 2, 8, 4, 32),       # nc = 3 (odd chunk count)
    (2, 100, 3, 16, 8, 64),     # ragged: s % chunk != 0, one chunk of s
])
def test_ssd_plain_matches_jax(b, s, h, p, n, chunk):
    """The plain version at each chunk, and `ssd_scan`'s CPU route (64-token
    chunks, as `mamba2_forward` calls it), against JAX."""
    args = _inputs(b, s, h, p, n)
    y, hf = ssd_chunked(*map(_t, args), chunk)
    assert y.dtype == hf.dtype == torch.float32
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    for yr, hr in (jax_ssd_scan(*jargs, chunk=chunk, interpret=True),
                   jax_ssd_ref_jit(*jargs, chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(hr), **TOL)
    y, hf = ssd_scan(*map(_t, args))
    yr, hr = jax_ssd_ref_jit(*jargs, chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hr), **TOL)


def test_ssd_chunk_invariance():
    """The scan result does not depend on the chunking (the CUDA kernel
    tiles at 64 tokens, the plain version takes one chunk for a ragged s)."""
    args = [_t(a) for a in _inputs(1, 128, 2, 8, 4)]
    y1, h1 = ssd_chunked(*args, 16)
    for chunk in (64, 128, 100):
        y2, h2 = ssd_chunked(*args, chunk)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), **TOL)
        np.testing.assert_allclose(h1.numpy(), h2.numpy(), **TOL)


def test_ssd_state_matches_sequential_decode():
    """Chunk-final state == token-by-token recurrence state."""
    b, s, h, p, n = 1, 32, 2, 8, 4
    x, dt, A, B_, C_ = map(_t, _inputs(b, s, h, p, n, seed=3))
    _, hf = ssd_chunked(x, dt, A, B_, C_, 8)
    state = torch.zeros((b, h, p, n))
    for t in range(s):
        dA = torch.exp(dt[:, t] * A)                             # (b, h)
        state = state * dA[..., None, None] + (
            dt[:, t, :, None, None] * x[:, t, :, :, None]
            * B_[:, t, None, None, :])
    np.testing.assert_allclose(hf.numpy(), state.numpy(), **TOL)


# ----------------------------------------------------------------------
# the Mamba2 block around the scan (f32 SMOKE widths, bridged params)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_smoke_config("zamba2-2.7b")
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(1), jcfg)
    # perturb the zero conv bias so it is exercised
    jp["conv_b"] = jax.random.normal(jax.random.PRNGKey(2),
                                     jp["conv_b"].shape) * 0.1
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_smoke_config("zamba2-2.7b"), tp


def test_causal_conv_and_step_match_jax(mamba):
    """Tolerance 1e-5 abs: f32 sums of 4 terms."""
    _, jp, _, tp = mamba
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, jp["conv_w"].shape[1]), np.float32)
    ref = jax_ssm.causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    out = ssm.causal_conv(_t(x), tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    buf = rng.standard_normal((2, 4, x.shape[-1]), np.float32)
    yr, br = jax_ssm.conv_step(jnp.asarray(buf), jnp.asarray(x[:, 0]),
                               jp["conv_w"], jp["conv_b"])
    y, b = ssm.conv_step(_t(buf), _t(x[:, 0]), tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_array_equal(b.numpy(), np.asarray(br))
    for S in (2, 9):       # shorter and longer than the conv width
        np.testing.assert_array_equal(
            ssm._conv_tail(_t(x[:, :S]), 4).numpy(),
            np.asarray(jax_ssm._conv_tail(jnp.asarray(x[:, :S]), 4)))


@pytest.mark.parametrize("S", [64, 37])
def test_mamba2_forward_then_decode_match_jax(mamba, S):
    """Output and cache within 1e-4 abs / 1e-4 rel after a prefill of S
    tokens (S = 37 is one ragged chunk), then 3 one-token decode steps."""
    jcfg, jp, cfg, tp = mamba
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model), np.float32)
    yr, cr = jax_mamba2_forward(jp, jnp.asarray(u), jcfg)
    y, c = ssm.mamba2_forward(tp, _t(u), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-4)
    for key in ("state", "conv"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(cr[key]),
                                   atol=1e-4, rtol=1e-4)
    conv, state, jconv, jstate = c["conv"], c["state"], cr["conv"], cr["state"]
    for _ in range(3):
        u_t = rng.standard_normal((2, 1, cfg.d_model), np.float32)
        yr, jconv, jstate = jax_mamba2_decode(jp, jnp.asarray(u_t), jcfg,
                                              jconv, jstate)
        y, conv, state = ssm.mamba2_decode(tp, _t(u_t), cfg, conv, state)
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   atol=1e-4, rtol=1e-4)
