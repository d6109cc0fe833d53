"""The flash kernel's rounding, emulated on the CPU in plain torch.

The CUDA kernel (`kernels/flash_attention/csrc/flash_attention.cu`) runs
both products on the tensor cores, which cannot run here.  `emulate` below
repeats its arithmetic step by step: 64-key tiles, an online softmax in
f32 with exp2 and log2(e) folded into the scale, masked keys at -1e30, and
the operand rounding of each path:

- f32 inputs: 3xTF32.  Each operand x splits into big = tf32(x), which
  keeps 10 explicit mantissa bits and rounds to nearest with ties away
  from zero (as `cvt.rna.tf32.f32`), and small = x - big truncated to
  TF32; a product sums small*big + big*small + big*big in f32.  Both
  Q K^T and P V, P included.
- bf16 inputs: Q K^T of bf16 values summed in f32; P rounded to bf16
  before P V (what `mma.sync` m16n8k16 takes, and what JAX's
  `blocked_attention` does); the row sum l keeps the f32 P.  Also at head
  dim 160, which only the bf16 serving instantiation takes.

Tolerances:
- 3xTF32 against the f32 references (the port's `attention_ref`, JAX's
  `attention_ref`): 1e-5 abs, a tenth of the 1e-4 the card's kernel is
  held to in f32.
- Plain TF32 (one product of the rounded operands) misses 1e-4 at D = 72:
  the reason for the split.
- bf16 P against the f32 reference on the same bf16 inputs and against
  JAX's `blocked_attention` in bf16: 2e-2 abs, the card's bf16 tolerance.
The JAX Pallas kernel is not used: it fails on the installed jax.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.layers import blocked_attention as jax_blocked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402

LOG2E = 1.4426950408889634
BK = 64          # keys per tile, as in the kernel
MASKED = -1e30   # the score of a key the causal or window mask excludes


def tf32(x):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero: adding half of the dropped range to the magnitude bits
    and clearing them is what `cvt.rna.tf32.f32` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """Truncate f32 to TF32: clear the low 13 mantissa bits."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split(x):
    """The kernel's split: big rounded, the rest truncated."""
    big = tf32(x)
    return big, tf32_trunc(x - big)


def mm_3xtf32(a, b):
    """a @ b from the split halves: small*big + big*small + big*big.  Each
    product of two TF32 values is exact in f32; the sums are taken in f64
    and rounded once to f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    d = torch.float64
    return (as_.to(d) @ bb.to(d) + ab.to(d) @ bs.to(d)
            + ab.to(d) @ bb.to(d)).float()


def mm_tf32(a, b):
    return (tf32(a).double() @ tf32(b).double()).float()


def mm_bf16_p(p, v):
    """P rounded to bf16 times bf16 V, summed in f32."""
    return (p.to(torch.bfloat16).double() @ v.double()).float()


def mm_f32(a, b):
    return (a.double() @ b.double()).float()


def emulate(q, k, v, *, causal, window, mode):
    """The kernel's arithmetic. mode: "3xtf32" (f32 inputs), "tf32"
    (rejected design, for comparison) or "bf16" (bf16 inputs)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    c = LOG2E / math.sqrt(D)
    qk, pv = {"3xtf32": (mm_3xtf32, mm_3xtf32), "tf32": (mm_tf32, mm_tf32),
              "bf16": (mm_f32, mm_bf16_p)}[mode]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(H // KH, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(H // KH, dim=2).permute(0, 2, 1, 3)
    q_pos = torch.arange(Sq) + (Sk - Sq)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Sk, BK):
        kt, vt = kf[:, :, k0:k0 + BK], vf[:, :, k0:k0 + BK]
        x = qk(qf, kt.transpose(-1, -2)) * c
        k_pos = torch.arange(k0, k0 + kt.shape[2])
        ok = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            ok &= q_pos[:, None] - k_pos[None, :] < window
        x = torch.where(ok, x, torch.tensor(MASKED))
        mx = torch.maximum(m, x.amax(-1))
        m_use = torch.where(mx == -math.inf, torch.zeros(()), mx)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + pv(p, vt)
        m = mx
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def _qkv(B, Sq, Sk, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


CASES = [  # B, Sq, Sk, H, KH, D, causal, window
    (2, 130, 130, 2, 2, 72, False, 0),    # DiT head dim, ragged last tile
    (1, 96, 160, 4, 2, 80, True, 0),      # zamba2 head dim, GQA, q at the tail
    (1, 128, 128, 2, 1, 128, True, 48),   # MQA, window edge mid-tile
    (1, 80, 40, 2, 2, 72, True, 0),       # q longer than k: rows fully masked
]


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", CASES)
def test_3xtf32_stays_within_1e5_of_the_f32_references(B, Sq, Sk, H, KH, D,
                                                       causal, window):
    q, k, v = _qkv(B, Sq, Sk, H, KH, D, seed=D + Sq)
    out = emulate(_t(q), _t(k), _t(v), causal=causal, window=window,
                  mode="3xtf32")
    ref = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    jref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    assert float((out - ref).abs().max()) <= 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)


def test_plain_tf32_would_miss_the_f32_tolerance():
    """At the DiT head dim one TF32 product per operand pair errs by more
    than the card's 1e-4, which is why the kernel splits."""
    q, k, v = _qkv(2, 130, 130, 2, 2, 72, seed=202)
    out = emulate(_t(q), _t(k), _t(v), causal=False, window=0, mode="tf32")
    ref = attention_ref(_t(q), _t(k), _t(v), causal=False)
    assert float((out - ref).abs().max()) > 1e-4


# the bf16 serving path alone goes to head dim 160 (pixtral-12b: GQA 4)
BF16_CASES = CASES + [(1, 130, 130, 8, 2, 160, True, 0)]


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", BF16_CASES)
def test_bf16_p_stays_within_the_bf16_tolerance(B, Sq, Sk, H, KH, D, causal,
                                                window):
    q, k, v = _qkv(B, Sq, Sk, H, KH, D, seed=D + Sq + 1)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    out = emulate(qb, kb, vb, causal=causal, window=window, mode="bf16")
    assert out.dtype == torch.bfloat16
    ref = attention_ref(qb, kb, vb, causal=causal, window=window)
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    blk = jax_blocked_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                causal=causal, window=window)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(blk, np.float32), atol=2e-2, rtol=0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """tf32 of 1 + 2^-11 (a tie) rounds away from zero to 1 + 2^-10, and the
    split's halves add back to x within 2^-21 of it."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0])
    assert tf32(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    big, small = split(y)
    assert float(((big + small) - y).abs().max()) <= 2 ** -21 * float(
        y.abs().max())
