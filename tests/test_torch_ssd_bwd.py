"""The SSD scan's backward on the CPU: `ssd_bwd_ref` (the VJP of the chunked
scan in closed form, the plain version the CUDA backward kernel is held
against) against `jax.vjp` of the JAX package's `ssd_chunked` and against
torch autograd of `ssd_ref`; the scan's `torch.autograd.Function` (the
card's route, here with the plain versions in place of the launches) on
bf16 views of the conv output; and the gradients of `mamba2_forward`
through that route against JAX's `value_and_grad` of its `mamba2_forward`.

Tolerances: 1e-5 of the largest gradient in f32 (sum order of XLA and
torch), 1e-4 for dA, a sum over every (b, s) of terms that cancel (its f32
rounding against float64 reaches 4.3e-5 here); on bf16 views of the conv
output dx, dB and dC round once to bf16 from the f32 gradient, so they
equal the plain f32 gradient rounded; through `mamba2_forward` with bf16
params, 3e-2 of each leaf's largest gradient (the two packages round the
bf16 block at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.ssd import (ops, ssd_bwd_ref, ssd_ref,  # noqa: E402
                                     ssd_scan_backward)
from repro_torch.models import ssm  # noqa: E402

F32_TOL = 1e-5
TOL = {"dx": F32_TOL, "ddt": F32_TOL, "dA": 1e-4, "dB": F32_TOL,
       "dC": F32_TOL}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(b, s, h, p, n, seed, dh):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.random(h)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n), np.float32)
    C_ = rng.standard_normal((b, s, n), np.float32)
    dy = rng.standard_normal((b, s, h, p), np.float32)
    dhf = rng.standard_normal((b, h, p, n), np.float32) if dh else None
    return (x, dt, A, B_, C_), dy, dhf


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_vjp():
    @jax.jit
    def vjp(x, dt, A, B_, C_, dy, dhf):
        _, pull = jax.vjp(lambda *a: jax_ssm.ssd_chunked(*a, 64),
                          x, dt, A, B_, C_)
        return pull((dy, dhf))
    return vjp


# (b, s, h, p, n): two whole chunks; a ragged tail (JAX takes s = 100 as one
# chunk, the port pads to two); one chunk
SHAPES = [(2, 128, 3, 8, 4), (1, 100, 2, 16, 16), (2, 64, 4, 8, 8)]


@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SHAPES)
def test_bwd_ref_matches_jax_vjp(jax_vjp, b, s, h, p, n, dh):
    """At JAX's chunking (a ragged s is one chunk there); the padded
    64-token chunks are held against float64 autograd below."""
    args, dy, dhf = _inputs(b, s, h, p, n, seed=s + h, dh=dh)
    want = jax_vjp(*map(jnp.asarray, args), jnp.asarray(dy),
                   jnp.zeros((b, h, p, n)) if dhf is None
                   else jnp.asarray(dhf))
    got = ssd_bwd_ref(*map(_t, args), _t(dy),
                      None if dhf is None else _t(dhf),
                      chunk=64 if s % 64 == 0 else s)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) <= TOL[name], (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SHAPES)
def test_bwd_ref_matches_autograd_of_ssd_ref(b, s, h, p, n, dh):
    """Against autograd of `ssd_ref` in float64 (the card's reference), in
    f32 and, in float64, to rounding."""
    args, dy, dhf = _inputs(b, s, h, p, n, seed=3 * s + h, dh=dh)
    ins = [_t(a).double().requires_grad_() for a in args]
    y, hf = ssd_ref(*ins)
    assert y.dtype == torch.float64
    loss = (y * _t(dy)).sum()
    if dhf is not None:
        loss = loss + (hf * _t(dhf)).sum()
    want = torch.autograd.grad(loss, ins)
    got = ssd_bwd_ref(*map(_t, args), _t(dy),
                      None if dhf is None else _t(dhf))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w.numpy()) <= TOL[name], name
    got64 = ssd_bwd_ref(*(_t(a).double() for a in args), _t(dy).double(),
                        None if dhf is None else _t(dhf).double())
    for g, w in zip(got64, want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-12


def _card_route(monkeypatch):
    """The scan's CUDA route with its launches replaced by the plain
    versions: `_SSDScan` around the plain forward, whose backward goes
    through `ssd_scan_backward` (the plain VJP for CPU tensors)."""
    def forward(x, dt, A, B_, C_):
        with torch.no_grad():
            return ssd_ref(x, dt, A, B_, C_)
    monkeypatch.setattr(ops, "_forward", forward)
    return ops._SSDScan.apply


@pytest.mark.parametrize("dh", [False, True])
def test_scan_function_on_bf16_views(monkeypatch, dh):
    """On bf16 views of one (b, s, h p + 2 n) buffer, as `mamba2_forward`
    passes them: the gradients reach the buffer through the views, dx, dB
    and dC are the f32 gradient rounded once to bf16, ddt and dA f32."""
    scan = _card_route(monkeypatch)
    b, s, h, p, n = 2, 100, 3, 16, 8
    rng = np.random.default_rng(4)
    buf = _t(rng.standard_normal((b, s, h * p + 2 * n), np.float32)).to(
        torch.bfloat16).requires_grad_()
    dt = _t(np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
        np.float32)).requires_grad_()
    A = _t(-np.exp(rng.random(h)).astype(np.float32)).requires_grad_()
    x = buf[..., :h * p].view(b, s, h, p)
    B_, C_ = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    dy = _t(rng.standard_normal((b, s, h, p), np.float32))
    dhf = _t(rng.standard_normal((b, h, p, n), np.float32))
    y, hf = scan(x, dt, A, B_, C_)
    assert y.grad_fn is not None and y.dtype == hf.dtype == torch.float32
    loss = (y * dy).sum() + ((hf * dhf).sum() if dh else 0.0)
    gbuf, gdt, gA = torch.autograd.grad(loss, (buf, dt, A))
    want = ssd_bwd_ref(x.detach().float(), dt.detach(), A.detach(),
                       B_.detach().float(), C_.detach().float(), dy,
                       dhf if dh else None)
    assert gbuf.dtype == torch.bfloat16
    got_x = gbuf[..., :h * p].view(b, s, h, p)
    assert torch.equal(got_x, want[0].to(torch.bfloat16))
    assert torch.equal(gbuf[..., h * p:h * p + n], want[3].to(torch.bfloat16))
    assert torch.equal(gbuf[..., h * p + n:], want[4].to(torch.bfloat16))
    assert torch.equal(gdt, want[1]) and torch.equal(gA, want[2])


def test_backward_wrapper_checks_its_inputs():
    args, dy, _ = _inputs(1, 8, 2, 4, 3, seed=0, dh=False)
    ts = list(map(_t, args))
    with pytest.raises(ValueError, match="do not fit"):
        ssd_scan_backward(*ts, _t(dy)[:, :4])
    with pytest.raises(ValueError, match="device"):
        ssd_scan_backward(*ts, torch.empty((1, 8, 2, 4), device="meta"))
    assert ssd_scan_backward.launches == 0


@pytest.fixture(scope="module")
def mamba_bf16():
    jcfg = jax_get_smoke_config("zamba2-2.7b")
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    jp["conv_b"] = (jax.random.normal(jax.random.PRNGKey(4),
                                      jp["conv_b"].shape) * 0.1).astype(
        jnp.bfloat16)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(9)
    u = rng.standard_normal((2, 70, jcfg.d_model), np.float32)
    w = rng.standard_normal((2, 70, jcfg.d_model), np.float32)

    def loss(p, u):
        y, _ = jax_ssm.mamba2_forward(p, u.astype(jnp.bfloat16), jcfg)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(w))

    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jp, jnp.asarray(u))
    return get_smoke_config("zamba2-2.7b"), tp, u, w, float(val), grads


def test_mamba2_forward_grads_through_the_card_route_match_jax(
        mamba_bf16, monkeypatch):
    """bf16 params, so the scan reads bf16 views of the conv output and
    its Function's backward scatters dx, dB and dC into them."""
    cfg, tp, u, w, val, (gp, gu) = mamba_bf16
    scan = _card_route(monkeypatch)
    calls = []

    def spy(*a):
        calls.append(a[0].dtype)
        return scan(*a)

    monkeypatch.setattr(ssm, "ssd_scan", spy)
    params = {k: v.detach().requires_grad_() for k, v in tp.items()}
    ut = _t(u).requires_grad_()
    y, _ = ssm.mamba2_forward(params, ut.to(torch.bfloat16), cfg)
    loss = (y.float() * _t(w)).sum()
    grads = torch.autograd.grad(loss, [*params.values(), ut])
    assert calls == [torch.bfloat16]
    assert abs(float(loss.detach()) - val) <= 1e-2 * abs(val)
    want = dict(gp, u=gu)
    for key, g in zip([*params, "u"], grads):
        ref = np.asarray(want[key], np.float32)
        assert g.shape == ref.shape, key
        assert _rel(g.float().numpy(), ref) <= 3e-2, (key, _rel(
            g.float().numpy(), ref))
