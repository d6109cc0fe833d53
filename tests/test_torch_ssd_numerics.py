"""The SSD kernel's rounding emulated on the CPU, and the scan's in-place
bf16 inputs, against both packages.

The CUDA kernel (`kernels/ssd/csrc/ssd.cu`) runs its products on the TF32
tensor cores, which cannot run here.  `emulate` repeats its arithmetic:
64-token tiles (a ragged tail padded with dt = 0 and zero x, B, C), C B^T
per tile, cs the inclusive prefix sum of dt * A in token order (as
torch.cumsum sums it, and the kernel too), S = C B^T * exp(cs_i - cs_j) *
dt_j below the diagonal, y = S x + exp(cs_i) (C h^T), h <- h
exp(cs_last) + x^T (w B) with w_j = exp(cs_last - cs_j) dt_j.  Every
product takes f32 operands as 3xTF32: x = big + small, big = tf32(x)
(10 explicit mantissa bits, to nearest, ties away from zero) and small =
x - big truncated to TF32, summing small*big + big*small + big*big.  An
operand that is exact in TF32 (a bf16 input: x, B and C on the serving
path) is not split, so its small terms are left out, as in the kernel.

Tolerances: the card's SSD tolerance, 2e-4 abs / 1e-3 rel, against the
plain f32 version (the port's `ssd_chunked`, JAX's `ssd_ref`) at the
longest chunk of at most 64 that divides s.  One TF32 product of f32
operands misses it: the reason for the split.  The Pallas kernel is not
used here; `tests/test_torch_ssd.py` holds the plain version against it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-3)
T = 64           # tokens a tile, as in the kernel
jax_ssd_ref_jit = jax.jit(jax_ssd_ref, static_argnames=("chunk",))
jax_ssd_chunked_jit = jax.jit(jax_ssd_chunked, static_argnums=(5,))
jax_mamba2_forward = jax.jit(jax_ssm.mamba2_forward, static_argnums=(2,))


def tf32(x):
    """Round f32 to TF32, to nearest with ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def mm(a, b, exact_a, exact_b, split=True):
    """a @ b as the kernel's mma sequence: the small terms of each operand
    that is not exact in TF32, then big * big; products exact, sums in f64
    rounded once to f32.  split=False: one TF32 product."""
    d = torch.float64
    ab = a if exact_a else tf32(a)
    bb = b if exact_b else tf32(b)
    out = ab.to(d) @ bb.to(d)
    if split and not exact_a:
        out = out + tf32_trunc(a - ab).to(d) @ bb.to(d)
    if split and not exact_b:
        out = out + ab.to(d) @ tf32_trunc(b - bb).to(d)
    return out.float()


def emulate(x, dt, A, B_, C_, *, exact, split=True):
    """The kernel's arithmetic.  exact: x, B and C are bf16 values (exact
    in TF32).  Returns (y (b,s,h,p), h (b,h,p,n)) in f32."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    nt = -(-s // T)
    pad = nt * T - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B_.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C_.float(), (0, 0, 0, pad))
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool))
    state = torch.zeros((b, h, p, n))
    ys = []
    for k in range(nt):
        sl = slice(k * T, (k + 1) * T)
        xt = xf[:, sl].permute(0, 2, 1, 3)                     # (b,h,T,p)
        dtt = dtf[:, sl].permute(0, 2, 1)                      # (b,h,T)
        Bt, Ct = Bf[:, sl], Cf[:, sl]                          # (b,T,n)
        cb = mm(Ct, Bt.transpose(1, 2), exact, exact, split)[:, None]
        cs = torch.cumsum(dtt * A.float()[None, :, None], dim=-1)
        e = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                                  torch.zeros(())))
        S = torch.where(tri, cb * e * dtt[..., None, :], torch.zeros(()))
        yd = mm(S, xt, False, exact, split)
        yo = mm(Ct[:, None], state.transpose(-1, -2), exact, False, split)
        ys.append(yd + torch.exp(cs)[..., None] * yo)
        last = cs[..., -1:]
        w = torch.exp(last - cs) * dtt
        state = state * torch.exp(last)[..., None] + mm(
            xt.transpose(-1, -2), w[..., None] * Bt[:, None], exact, False,
            split)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :s]
    return y.contiguous(), state


def _inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, (h,))).astype(np.float32)
    B_ = rng.standard_normal((b, s, n), np.float32)
    C_ = rng.standard_normal((b, s, n), np.float32)
    return x, dt, A, B_, C_


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _chunk(s):
    return max(c for c in range(1, T + 1) if s % c == 0)


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


CASES = [  # b, s, h, p, n
    (2, 128, 3, 16, 16),
    (1, 130, 2, 32, 64),        # ragged tail, a full column group, widest n
    (1, 40, 2, 8, 8),           # shorter than one tile
]


@pytest.mark.parametrize("b,s,h,p,n", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_products_stay_within_the_tolerance(b, s, h, p, n, dtype):
    """f32 inputs: 3xTF32 in every product; bf16 inputs (rounded from the
    same draws): x, B and C exact, so two products (one for C B^T).
    Against both packages' plain f32 scan on the same values."""
    args = [_t(a) for a in _inputs(b, s, h, p, n, seed=s + p)]
    if dtype == "bfloat16":
        for i in (0, 3, 4):
            args[i] = args[i].to(torch.bfloat16).float()
    y, hf = emulate(*args, exact=dtype == "bfloat16")
    yr, hr = ssd_chunked(*args, _chunk(s))
    _close(y, yr)
    _close(hf, hr)
    yj, hj = jax_ssd_ref_jit(*(jnp.asarray(a.numpy()) for a in args),
                             chunk=_chunk(s))
    _close(y, yj)
    _close(hf, hj)


def test_one_tf32_product_would_miss_the_tolerance():
    """f32 operands rounded once to TF32 err beyond 2e-4 abs + 1e-3 rel,
    which is why the kernel splits them."""
    args = [_t(a) for a in _inputs(2, 128, 3, 16, 16, seed=1)]
    y, _ = emulate(*args, exact=False, split=False)
    yr, _ = ssd_chunked(*args, 64)
    excess = (y - yr).abs() - TOL["rtol"] * yr.abs()
    assert float(excess.max()) > TOL["atol"]


def _xbc(b, s, h, p, n, seed):
    """An (b, s, h p + 2n) conv output in bf16 and its x, B, C views."""
    x, dt, A, B_, C_ = _inputs(b, s, h, p, n, seed)
    xbc = torch.cat([_t(x).reshape(b, s, h * p), _t(B_), _t(C_)],
                    dim=-1).to(torch.bfloat16)
    xv = xbc[..., :h * p].reshape(b, s, h, p)
    return xbc, xv, xbc[..., h * p:h * p + n], xbc[..., h * p + n:], dt, A


@pytest.mark.parametrize("b,s,h,p,n", [(2, 128, 3, 16, 8), (1, 100, 2, 8, 16)])
def test_cpu_route_reads_bf16_views_of_xbc(b, s, h, p, n):
    """`ssd_scan` on bf16 strided views (unit last stride) of one xBC
    tensor, against JAX's `ssd_chunked` on the f32 cast of the same
    values, at the chunk the path takes (64, or s when 64 does not divide
    it)."""
    xbc, xv, Bv, Cv, dt, A = _xbc(b, s, h, p, n, seed=b + s)
    assert not xv.is_contiguous() and xv.stride(-1) == Bv.stride(-1) == 1
    assert xv.data_ptr() == xbc.data_ptr()
    y, hf = ssd_scan(xv, _t(dt), _t(A), Bv, Cv)
    assert y.dtype == hf.dtype == torch.float32
    chunk = 64 if s % 64 == 0 else s
    yj, hj = jax_ssd_chunked_jit(
        *(jnp.asarray(t.float().numpy()) for t in (xv, _t(dt), _t(A), Bv, Cv)),
        chunk)
    _close(y, yj)
    _close(hf, hj)


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_smoke_config("zamba2-2.7b")
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(3), jcfg)
    jp["conv_b"] = jax.random.normal(jax.random.PRNGKey(4),
                                     jp["conv_b"].shape) * 0.1
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_smoke_config("zamba2-2.7b"), tp


def test_mamba2_forward_passes_views_of_the_conv_output(mamba, monkeypatch):
    """`mamba2_forward` hands the scan x, B and C as views of the one conv
    output (no copies), and still matches JAX's block: output and cache
    within 1e-4 abs / 1e-4 rel, as tests/test_torch_ssd.py holds it."""
    jcfg, jp, cfg, tp = mamba
    seen = []

    def spy(x, dt, A, B_, C_):
        seen.append((x, B_, C_))
        return ssd_scan(x, dt, A, B_, C_)

    monkeypatch.setattr(ssm, "ssd_scan", spy)
    u = np.random.default_rng(9).standard_normal((2, 70, cfg.d_model),
                                                 np.float32)
    y, c = ssm.mamba2_forward(tp, _t(u), cfg)
    (x, B_, C_), = seen
    base = x.untyped_storage().data_ptr()
    assert B_.untyped_storage().data_ptr() == C_.untyped_storage().data_ptr() == base
    assert x.stride(-1) == B_.stride(-1) == C_.stride(-1) == 1
    assert not x.is_contiguous()
    yr, cr = jax_mamba2_forward(jp, jnp.asarray(u), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-4)
    for key in ("state", "conv"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(cr[key]),
                                   atol=1e-4, rtol=1e-4)
