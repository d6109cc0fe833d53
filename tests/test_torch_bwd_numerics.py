"""The backward kernels' rounding, emulated on the CPU in plain torch.

Both CUDA backward kernels run their products on the tensor cores, which
cannot run here; the emulations below repeat their arithmetic product by
product (operands rounded as the kernel rounds them, each product exact and
summed in f64, rounded once to f32).

Flash attention (`kernels/flash_attention/csrc/flash_attention_bwd.cu`):
- bf16 inputs: S = Q K^T and dP = dO V^T of bf16 values summed in f32; P
  and dS (f32 values) enter dV = P^T dO, dK = dS^T Q and dQ = dS K as a
  bf16 pair each, hi = bf16(x) and lo = bf16(x - hi) (`bf16_pair`).
- f32 inputs: every product 3xTF32 (big = tf32(x) to nearest, small = the
  rest truncated; small*big + big*small + big*big), P and dS included.
Tolerances: bf16 within 2e-2 abs of float64 autograd and of `jax.vjp` of
JAX's `blocked_attention` in bf16 (the card's bf16 gate), GQA 8 included;
3xTF32 within 1e-5 abs of float64 autograd, a tenth of the card's 1e-4;
one TF32 product per operand pair misses 1e-4 (the reason for the split);
`attention_bwd_ref` on bf16 inputs is the emulation within one bf16
rounding of its output plus 1e-5 (the two differ in exp against exp2 and
in the order of their f32 sums).

SSD scan (`kernels/ssd/csrc/ssd_bwd.cu`): the kernel's decomposition (tile-
local states, the recurrence, the per-tile products of a head group) with
each product's operands rounded as the kernel rounds them: a bf16 value
(x, B and C on the path's bf16 views) is exact in TF32 and is not split,
every f32 operand splits (3x/2xTF32).  Within 1e-5 of each gradient's
largest value against `jax.vjp` of JAX's `ssd_chunked` (1e-4 for dA, a sum
of cancelling terms); one TF32 product misses the card's 1e-4 gate.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.layers import blocked_attention as jax_blocked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_bwd_ref,  # noqa: E402
                                                 attention_lse_ref,
                                                 attention_ref)
from repro_torch.kernels.flash_attention.ref import bf16_pair  # noqa: E402
from repro_torch.kernels.ssd import ssd_ref  # noqa: E402

LOG2E = 1.4426950408889634
T = 64           # SSD tokens a tile, as in the kernel


def tf32(x):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as the kernels' split does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def mm(a, b, exact_a=False, exact_b=False, split=True):
    """a @ b as an mma sequence: the small terms of each operand that is not
    exact in TF32, then big * big; products exact, sums in f64 rounded once
    to f32.  split=False: one TF32 product."""
    d = torch.float64
    ab = a.float() if exact_a else tf32(a)
    bb = b.float() if exact_b else tf32(b)
    out = ab.to(d) @ bb.to(d)
    if split and not exact_a:
        out = out + tf32_trunc(a.float() - ab).to(d) @ bb.to(d)
    if split and not exact_b:
        out = out + ab.to(d) @ tf32_trunc(b.float() - bb).to(d)
    return out.float()


def mm_exact(a, b):
    """a @ b of values exact in bf16 (or pairs of them), summed in f32."""
    return (a.double() @ b.double()).float()


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------

def emulate_flash_bwd(q, k, v, o, do, lse, *, causal, window, mode):
    """The backward kernels' arithmetic.  mode: "bf16" (bf16 inputs, P and
    dS as bf16 pairs), "bf16-single" (P and dS rounded once, the design not
    taken), "3xtf32" (f32 inputs) or "tf32" (one TF32 product, the design
    not taken).  Returns (dq, dk, dv) in f32."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    if mode.startswith("bf16"):
        prod, operand = mm_exact, (bf16_pair if mode == "bf16" else
                                   lambda t: t.to(torch.bfloat16).float())
    else:
        prod = (lambda a, b: mm(a, b, split=mode == "3xtf32"))
        operand = (lambda t: t)
    perm = (0, 2, 1, 3)
    qf, dof, of = (t.float().permute(perm) for t in (q, do, o))  # (B,H,Sq,D)
    kf, vf = (t.float().repeat_interleave(G, dim=2).permute(perm)
              for t in (k, v))                                   # (B,H,Sk,D)
    s = prod(qf, kf.transpose(-1, -2))
    dp = prod(dof, vf.transpose(-1, -2))
    delta = (dof.double() * of.double()).sum(-1).float()[..., None]
    q_pos = torch.arange(Sq) + (Sk - Sq)
    k_pos = torch.arange(Sk)
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    dead = (q_pos < 0)[:, None] & torch.tensor(bool(causal))
    p = torch.exp2(s * (scale * LOG2E) - lse.float()[..., None] * LOG2E)
    p = torch.where(dead, torch.tensor(1.0 / Sk),
                    torch.where(ok, p, torch.zeros(())))
    ds = torch.where(ok & ~dead, p * (dp - delta) * scale, torch.zeros(()))
    p_op, ds_op = operand(p), operand(ds)
    dv = prod(p_op.transpose(-1, -2), dof)
    dk = prod(ds_op.transpose(-1, -2), qf)
    dq = prod(ds_op, kf)
    # the group's heads summed into their kv head, in head order
    dk = dk.reshape(B, KH, G, Sk, D).sum(2).permute(perm)
    dv = dv.reshape(B, KH, G, Sk, D).sum(2).permute(perm)
    return dq.permute(perm), dk, dv


def _flash_inputs(B, Sq, Sk, H, KH, D, causal, window, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, np.float32) for shape in
            ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D), (B, Sq, H, D))]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrs)
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window).float()
    return q, k, v, o, do, lse


def _f64_grads(q, k, v, do, causal, window):
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad(
        attention_ref(q64, k64, v64, causal=causal, window=window),
        (q64, k64, v64), do.double())


@partial(jax.jit, static_argnums=(4, 5))
def _jax_flash_vjp(q, k, v, do, causal, window):
    _, pull = jax.vjp(lambda *a: jax_blocked_attention(
        *a, causal=causal, window=window), q, k, v)
    return pull(do)


def _max_err(got, want):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))


FLASH_CASES = [  # B, Sq, Sk, H, KH, D, causal, window
    (2, 48, 48, 16, 2, 64, True, 0),      # GQA 8, causal (tinyllama's group)
    (2, 70, 70, 4, 4, 72, False, 0),      # the DiT head dim, ragged tile
    (1, 40, 24, 2, 2, 16, True, 0),       # q longer than k: keyless rows
    (1, 96, 96, 2, 1, 80, True, 40),      # MQA, window edge mid-tile
]


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", FLASH_CASES)
def test_flash_bf16_pairs_stay_within_the_bf16_gate(B, Sq, Sk, H, KH, D,
                                                     causal, window):
    q, k, v, o, do, lse = _flash_inputs(B, Sq, Sk, H, KH, D, causal, window,
                                        torch.bfloat16, seed=Sq + D)
    got = [t.to(torch.bfloat16) for t in emulate_flash_bwd(
        q, k, v, o, do, lse, causal=causal, window=window, mode="bf16")]
    # a GQA group summed into its kv head: 2e-2 plus one rounding of the
    # output, as the card's gate at tinyllama's group of 8
    rounding = 2.0 ** -8 if H // KH == 8 else 0.0
    for a, r in zip(got, _f64_grads(q, k, v, do, causal, window)):
        err = (a.double() - r).abs() - rounding * r.abs()
        assert float(err.max()) <= 2e-2
    if causal and Sq > Sk:
        # JAX adds -1e30 to the scores: autodiff of that sum hands a row with
        # no key a nonzero dS, where the reference's select (and the
        # kernel) give 0 (its dq exactly 0); no comparison there
        return

    want = _jax_flash_vjp(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (q, k, v, do)), causal, window)
    # JAX rounds its bf16 gradients too: one rounding of each side
    for a, r in zip(got, want):
        r = torch.from_numpy(np.asarray(r, np.float32)).double()
        err = (a.double() - r).abs() - 2 * rounding * r.abs()
        assert float(err.max()) <= 2e-2


def test_flash_bf16_pair_is_closer_than_one_rounding():
    """At the GQA-8 shape the pairs keep the gradients closer to float64
    than P and dS rounded once to bf16 (the emulation before the output's
    own rounding)."""
    args = _flash_inputs(2, 48, 48, 16, 2, 64, True, 0, torch.bfloat16,
                         seed=5)
    ref = _f64_grads(*args[:3], args[4], True, 0)
    pair, single = (_max_err(emulate_flash_bwd(*args, causal=True, window=0,
                                               mode=m), ref)
                    for m in ("bf16", "bf16-single"))
    assert pair < single


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", FLASH_CASES)
def test_flash_3xtf32_stays_within_1e5(B, Sq, Sk, H, KH, D, causal, window):
    q, k, v, o, do, lse = _flash_inputs(B, Sq, Sk, H, KH, D, causal, window,
                                        torch.float32, seed=Sq + D + 1)
    got = emulate_flash_bwd(q, k, v, o, do, lse, causal=causal,
                            window=window, mode="3xtf32")
    assert _max_err(got, _f64_grads(q, k, v, do, causal, window)) <= 1e-5


def test_flash_one_tf32_product_would_miss_the_f32_gate():
    q, k, v, o, do, lse = _flash_inputs(2, 130, 130, 2, 2, 72, False, 0,
                                        torch.float32, seed=7)
    got = emulate_flash_bwd(q, k, v, o, do, lse, causal=False, window=0,
                            mode="tf32")
    assert _max_err(got, _f64_grads(q, k, v, do, False, 0)) > 1e-4


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", FLASH_CASES[:3])
def test_rounded_attention_bwd_ref_is_the_emulation(B, Sq, Sk, H, KH, D,
                                                    causal, window):
    q, k, v, o, do, lse = _flash_inputs(B, Sq, Sk, H, KH, D, causal, window,
                                        torch.bfloat16, seed=Sq + 3)
    plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                              window=window)
    emu = emulate_flash_bwd(q, k, v, o, do, lse, causal=causal,
                            window=window, mode="bf16")
    for a, b in zip(plain, emu):
        assert a.dtype == torch.bfloat16
        excess = (a.double() - b.double()).abs() - 2.0 ** -8 * b.double().abs()
        assert float(excess.max()) <= 1e-5


# ----------------------------------------------------------------------
# SSD scan
# ----------------------------------------------------------------------

def emulate_ssd_bwd(x, dt, A, B_, C_, dy, dhf, *, exact, split=True):
    """The SSD backward kernels' arithmetic: (dx, ddt, dA, dB, dC) in f32.
    exact: x, B and C are bf16 values (exact in TF32)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    nt = -(-s // T)
    pad = nt * T - s

    def tiles(t):   # (b, s, ...) -> (b, nt, T, ...), zero-padded
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape((b, nt, T) + t.shape[2:])

    def prod(a, bb, ea, eb):
        return mm(a, bb, ea, eb, split)

    xt = tiles(x).permute(0, 1, 3, 2, 4)            # (b,nt,h,T,p)
    dyt = tiles(dy).permute(0, 1, 3, 2, 4)
    dtt = tiles(dt).permute(0, 1, 3, 2)             # (b,nt,h,T)
    Bt, Ct = tiles(B_)[:, :, None], tiles(C_)[:, :, None]   # (b,nt,1,T,n)
    cs = torch.cumsum(dtt * A.float()[:, None], dim=-1)
    csL = cs[..., -1:]
    ecs, w = torch.exp(cs), torch.exp(csL - cs) * dtt
    decay = torch.exp(csL)[..., None]               # (b,nt,h,1,1)
    # tile-local states and state gradients, then the recurrence
    loc = prod(xt.transpose(-1, -2), w[..., None] * Bt, exact, False)
    locg = prod((ecs[..., None] * dyt).transpose(-1, -2), Ct, False, exact)
    hin = [torch.zeros((b, h, p, n))]
    for c in range(nt - 1):
        hin.append(hin[-1] * decay[:, c] + loc[:, c])
    gout = [torch.zeros((b, h, p, n)) if dhf is None else dhf.float()]
    for c in range(nt - 1, 0, -1):
        gout.insert(0, gout[0] * decay[:, c] + locg[:, c])
    H_, G_ = torch.stack(hin, 1), torch.stack(gout, 1)      # (b,nt,h,p,n)
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool))  # (i, j)
    e = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                              torch.zeros(())))
    cbt = prod(Bt, Ct.transpose(-1, -2), exact, exact)      # (j, i)
    dmt = prod(xt, dyt.transpose(-1, -2), exact, False)     # (j, i)
    et = e.transpose(-1, -2)                                # E_ij at (j, i)
    dtj = dtt[..., :, None]
    trit = tri.T
    mt = torch.where(trit, cbt * et * dtj, torch.zeros(()))
    dcbt = torch.where(trit, dmt * et * dtj, torch.zeros(())).sum(2)
    tt = torch.where(trit, dmt * cbt * et, torch.zeros(()))
    gb = prod(Bt, G_.transpose(-1, -2), exact, False)       # (j, p)
    dw = (xt * gb).sum(-1)
    dx = w[..., None] * gb + prod(mt, dyt, False, False)
    doff = ecs[..., None] * prod(dyt, H_, False, False)     # (i, n)
    yoff = (Ct * doff).sum(-1)
    dC = doff.sum(2) + prod(dcbt.transpose(-1, -2), Bt[:, :, 0], False, exact)
    dB = (w[..., None] * prod(xt, G_, exact, False)).sum(2) \
        + prod(dcbt, Ct[:, :, 0], False, exact)
    colT, rowT = tt.sum(-1), (tt * dtj).sum(-2)
    dcs = rowT - dtt * colT + yoff - w * dw
    dcs[..., -1] += ecs[..., -1] * (G_ * H_).sum((-1, -2)) + (w * dw).sum(-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
    ddt = colT + torch.exp(csL - cs) * dw + A.float()[:, None] * ddA
    dA = (dtt * ddA).sum((0, 1, 3))

    def untile(t, heads):   # (b,nt,[h,]T,...) -> (b,s,[h,]...)
        if heads:
            t = t.transpose(2, 3)
        return t.reshape((b, nt * T) + t.shape[3:])[:, :s]

    return untile(dx, True), untile(ddt, True), dA, untile(dB, False), \
        untile(dC, False)


def _ssd_inputs(b, s, h, p, n, seed, exact):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.random(h)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n), np.float32)
    C_ = rng.standard_normal((b, s, n), np.float32)
    dy = rng.standard_normal((b, s, h, p), np.float32)
    dhf = rng.standard_normal((b, h, p, n), np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B_, C_, dy, dhf)]
    if exact:
        for i in (0, 3, 4):
            t[i] = t[i].to(torch.bfloat16).float()
    return t


@jax.jit
def _ssd_jax_vjp_impl(x, dt, A, B_, C_, dy, dhf):
    _, pull = jax.vjp(lambda *a: jax_ssm.ssd_chunked(*a, T), x, dt, A, B_, C_)
    return pull((dy, dhf))


def _ssd_jax_vjp(*args):
    return [torch.from_numpy(np.array(g)) for g in _ssd_jax_vjp_impl(
        *(jnp.asarray(t.numpy()) for t in args))]


def _ssd_rel(got, want):
    return [float((a.double() - b.double()).abs().max())
            / float(b.double().abs().max()) for a, b in zip(got, want)]


SSD_TOL = [1e-5, 1e-5, 1e-4, 1e-5, 1e-5]    # dx, ddt, dA, dB, dC


SSD_SHAPE = (2, 150, 3, 16, 16)   # three tiles, the last ragged; JAX: one chunk


@pytest.mark.parametrize("exact", [False, True])
def test_ssd_split_products_stay_within_1e5_of_jax(exact):
    """The recurrence runs over three tiles with dh_final; JAX takes the
    ragged s = 150 as one chunk, the kernel pads to three tiles."""
    x, dt, A, B_, C_, dy, dhf = _ssd_inputs(*SSD_SHAPE, 1, exact)
    got = emulate_ssd_bwd(x, dt, A, B_, C_, dy, dhf, exact=exact)
    want = _ssd_jax_vjp(x, dt, A, B_, C_, dy, dhf)
    for rel, tol in zip(_ssd_rel(got, want), SSD_TOL):
        assert rel <= tol


def test_ssd_emulation_is_the_float64_vjp():
    """The emulation's decomposition is the scan's VJP: in float64 with no
    TF32 rounding it is autograd of `ssd_ref` to 1e-10."""
    x, dt, A, B_, C_, dy, dhf = _ssd_inputs(1, 150, 2, 8, 8, 4, False)
    ins = [t.double().requires_grad_() for t in (x, dt, A, B_, C_)]
    y, hf = ssd_ref(*ins)
    want = torch.autograd.grad((y * dy.double()).sum()
                               + (hf * dhf.double()).sum(), ins)
    got = emulate_ssd_bwd(x, dt, A, B_, C_, dy, dhf, exact=False)
    for rel, tol in zip(_ssd_rel(got, want), SSD_TOL):
        assert rel <= tol


def test_ssd_one_tf32_product_would_miss_the_gate():
    x, dt, A, B_, C_, dy, dhf = _ssd_inputs(*SSD_SHAPE, 11, False)
    got = emulate_ssd_bwd(x, dt, A, B_, C_, dy, dhf, exact=False, split=False)
    want = _ssd_jax_vjp(x, dt, A, B_, C_, dy, dhf)
    assert max(_ssd_rel(got, want)) > 1e-4


def test_ssd_head_groups_fill_the_card_and_take_a_ragged_last_group():
    """The backward's tile blocks walk a group of heads: 5 at the train shape
    (16 groups, 256 blocks), at most 8, and at the card test's (b 4, s 512,
    h 21) groups of 2 that leave one head to the last."""
    from repro_torch.kernels.ssd.ops import head_group
    assert head_group(8, 128, 80) == 5
    assert head_group(4, 512, 80) == 8 and head_group(1, 64, 3) == 1
    assert head_group(4, 512, 21) == 2 and 21 % 2 == 1
