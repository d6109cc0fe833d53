"""The kernels' whole domain against the JAX package, on the CPU.

Flash attention at any head dim and the SSD scan at any head dim p and
state n: the wrapper's routing table (which CUDA unit a call launches, or
what it raises), and the plain versions the general units are held
against on the card, at widths no earlier instantiation takes:

- `attention_ref` and `attention_bwd_ref` at f32 head dims 256 (Gemma),
  288 (the prompt encoder at dit-t2i's width) and an odd 200, GQA and
  causal, against JAX's `attention_ref` and `jax.vjp` of
  `blocked_attention` (the Pallas flash kernel cannot run on the installed
  jax): 1e-5 abs, f32 sums in another order;
- `ssd_ref` at p 96, n 128 against the Pallas scan in interpret mode: 2e-4
  abs and 1e-3 rel, as tests/test_kernels.py holds it; `ssd_bwd_ref`
  against `jax.vjp` of `ssd_chunked`: 1e-5 abs of each gradient's largest
  value (dA 1e-4);
- zamba2's SMOKE config with the state of the published Mamba2 (128; SMOKE
  caps it at 16): forward logits against JAX's, 1e-4 abs.

Inputs are numpy draws from a seed; JAX compiles are scoped to the module.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.layers import blocked_attention  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    Route, attention_bwd_ref, attention_lse_ref, attention_ref,
    flash_attention, route)
from repro_torch.kernels.ssd import (general, ssd_bwd_ref, ssd_ref,  # noqa: E402
                                     ssd_scan)
from repro_torch.kernels.flash_attention.ops import aligned16  # noqa: E402
from repro_torch.models import forward  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
ANY = Route("flash_attention_fwd_any", None)
ANY_GRAD = Route("flash_attention_fwd_any", "flash_attention_bwd_any")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ----------------------------------------------------------------------
# the routing table
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,D,Dv,aligned,grad,want", [
    # the base instantiations, any alignment, and v padded below 128
    (F32, 72, 72, True, False, Route("flash_attention_fwd", None)),
    (BF16, 80, 80, False, True, Route("flash_attention_fwd_lse",
                                      "flash_attention_bwd")),
    (F32, 128, 128, True, True, Route("flash_attention_fwd_lse",
                                      "flash_attention_bwd")),
    (BF16, 128, 96, True, False, Route("flash_attention_fwd", None, True)),
    # bf16 with 16-byte rows: 160, and the split 192 over 128
    (BF16, 160, 160, True, False, Route("flash_attention_fwd", None)),
    (BF16, 160, 160, True, True, Route("flash_attention_fwd_lse",
                                       "flash_attention_bwd_wide")),
    (BF16, 192, 128, True, False, Route("flash_attention_fwd_split", None)),
    (BF16, 192, 128, True, True, Route("flash_attention_fwd_split_lse",
                                       "flash_attention_bwd_wide")),
    (BF16, 136, 136, True, False, Route("flash_attention_fwd", None)),
    # the general units: f32 above 128, wider bf16, unaligned rows
    (F32, 160, 160, True, False, ANY),
    (F32, 160, 160, True, True, ANY_GRAD),
    (F32, 192, 128, True, True, ANY_GRAD),
    (F32, 288, 288, True, False, ANY),
    (F32, 256, 256, True, True, ANY_GRAD),
    (F32, 200, 200, True, True, ANY_GRAD),
    (BF16, 256, 256, True, True, ANY_GRAD),
    (BF16, 176, 176, True, False, ANY),
    (BF16, 200, 128, True, False, ANY),
    (BF16, 192, 136, True, True, ANY_GRAD),
    (BF16, 136, 136, False, True, ANY_GRAD),
    (BF16, 132, 132, False, False, ANY),
    (BF16, 160, 160, False, False, ANY),
    (F32, 129, 1, False, True, ANY_GRAD),
])
def test_route(dtype, D, Dv, aligned, grad, want):
    assert route(dtype, D, Dv, aligned, grad) == want


@pytest.mark.parametrize("dtype,D,Dv,err", [
    (torch.float16, 64, 64, TypeError),
    (torch.float16, 256, 256, TypeError),
    (F32, 128, 160, ValueError),
    (BF16, 64, 0, ValueError),
])
def test_route_raises(dtype, D, Dv, err):
    with pytest.raises(err):
        route(dtype, D, Dv, True, False)


@pytest.mark.parametrize("case", chip_smoke.ANY_FLASH_CASES,
                         ids=lambda c: c[0])
def test_any_flash_cases_route_to_the_general_units(case):
    """Every row of chip_smoke's any-kernels phase, at its dtype and storage
    offset, takes the general forward, and under grad the general
    backward: the phase times and checks those units, not a routed
    instantiation."""
    _, _, _, _, _, D, Dv, _, dt, offset = case
    dtype = getattr(torch, dt)
    q, k, v = (torch.empty((offset + n,), dtype=dtype)[offset:]
               for n in (D, D, Dv))
    aligned = aligned16(D, Dv, (q, k, v))
    assert route(dtype, D, Dv, aligned, False) == ANY
    assert route(dtype, D, Dv, aligned, True) == ANY_GRAD


def test_ssd_general_units_take_what_ssd_cu_does_not():
    assert not general(64, 64) and not general(1, 16)
    assert general(64, 128) and general(96, 64) and general(96, 160)


@pytest.mark.parametrize("b,s,h,sms,want", [
    (4, 512, 80, 132, 20),    # zamba2 n 128: 128 blocks, one wave
    (1, 500, 4, 132, 1),      # the ragged p 96 row: 32 blocks
    (8, 128, 80, 132, 10),    # zamba2's training batch: 128 blocks
    (1, 64, 3, 132, 1),       # one tile, few heads
    (2, 4096, 200, 132, 50),  # 512 blocks in 4 waves
])
def test_any_head_group_trades_waves_against_heads(b, s, h, sms, want):
    """The general backward's head group: the least waves x (group + 1) of
    its one-block-an-SM tile kernel, the smallest group on a tie, at most
    64 heads."""
    from repro_torch.kernels.ssd.ops import any_head_group
    nt = -(-s // 64)

    def cost(g):
        return -(-nt * -(-h // g) * b // sms) * (g + 1)
    got = any_head_group(b, s, h, sms)
    assert got == want and 1 <= got <= min(h, 64)
    assert all(cost(got) < cost(g) for g in range(1, got))
    assert all(cost(got) <= cost(g) for g in range(got, min(h, 64) + 1))


def test_ssd_general_widths_match_the_sources():
    """ops.RESIDENT_N, the widest state the general forward keeps in shared
    memory, and the 128 columns of n whose dB / dC partials the general
    backward keeps in registers, as the CUDA sources state them."""
    import re
    from repro_torch.kernels.ssd import ops
    csrc = Path(ops.__file__).parent / "csrc"
    fwd = (csrc / "ssd_any.cu").read_text()
    bwd = (csrc / "ssd_bwd_any.cu").read_text()
    assert int(re.search(r"kMaxResidentN = (\d+);", fwd).group(1)) \
        == ops.RESIDENT_N == 1024
    assert int(re.search(r"constexpr int kNC = (\d+);", bwd).group(1)) == 128


# ----------------------------------------------------------------------
# attention_ref / attention_bwd_ref at wide f32 head dims against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KH,D", [
    (1, 40, 4, 2, 256),     # Gemma-7B's head dim, GQA 2
    (2, 24, 4, 4, 288),     # the prompt encoder at dit-t2i's d_model
    (1, 33, 6, 2, 200),     # an odd width, GQA 3, ragged S
])
def test_wide_f32_attention_matches_jax(B, S, H, KH, D):
    """The forward against JAX's attention_ref and the backward, from o and
    the row log-sum-exp, against `jax.vjp` of blocked_attention: 1e-5 abs;
    the CPU wrapper returns the plain forward."""
    rng = np.random.default_rng(D + S)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, S, KH, D), dtype=np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S, H, D), dtype=np.float32)
    want_o = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True)

    @jax.jit
    def fwd_bwd(a, b, c, ct):
        out, vjp = jax.vjp(lambda x, y, z: blocked_attention(x, y, z,
                                                             causal=True),
                           a, b, c)
        return out, vjp(ct)
    out, want = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o = attention_ref(tq, tk, tv, causal=True)
    assert float((o - _t(want_o)).abs().max()) <= 1e-5
    assert float((o - _t(out)).abs().max()) <= 1e-5
    assert torch.equal(flash_attention(tq, tk, tv, causal=True), o)
    lse = attention_lse_ref(tq, tk, causal=True)
    got = attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=True)
    for a, b in zip(got, want):
        assert float((a - _t(b)).abs().max()) <= 1e-5


# ----------------------------------------------------------------------
# the SSD scan and its backward at p 96, n 128
# ----------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, (h,))).astype(np.float32)
    B_, C_ = (rng.standard_normal((b, s, n), dtype=np.float32)
              for _ in range(2))
    return x, dt, A, B_, C_


def test_ssd_ref_matches_pallas_interpret():
    """ssd_ref (and the CPU wrapper) against the Pallas scan in interpret
    mode at p 96, n 128: 2e-4 abs, 1e-3 rel."""
    ins = _ssd_inputs(1, 128, 2, 96, 128, seed=7)
    y, hf = jax_ssd_scan(*map(jnp.asarray, ins), chunk=64, interpret=True)
    ty, thf = ssd_ref(*map(_t, ins))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(thf.numpy(), np.asarray(hf), atol=2e-4,
                               rtol=1e-3)
    wy, whf = ssd_scan(*map(_t, ins))
    assert torch.equal(wy, ty) and torch.equal(whf, thf)


@pytest.mark.parametrize("s,dh", [(128, True), (100, False)])
def test_ssd_bwd_ref_matches_jax_vjp(s, dh):
    """ssd_bwd_ref at p 96, n 128 (with dh_final, and a ragged s without)
    against jax.vjp of ssd_chunked: each gradient within 1e-5 of its
    largest value (dA 1e-4)."""
    b, h, p, n = 1, 2, 96, 128
    ins = _ssd_inputs(b, s, h, p, n, seed=s)
    rng = np.random.default_rng(s + 1)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dhf = rng.standard_normal((b, h, p, n), dtype=np.float32) if dh else None
    chunk = 64 if s % 64 == 0 else s
    @jax.jit
    def bwd(args, ct):
        return jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=chunk),
                       *args)[1](ct)
    want = bwd(tuple(map(jnp.asarray, ins)), (jnp.asarray(dy), jnp.asarray(
        dhf if dh else np.zeros((b, h, p, n), np.float32))))
    got = ssd_bwd_ref(*map(_t, ins), _t(dy), None if dhf is None else _t(dhf))
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        tol = (1e-4 if name == "dA" else 1e-5) * max(np.abs(w).max(), 1.0)
        assert float(np.abs(a.numpy() - w).max()) <= tol, name


# ----------------------------------------------------------------------
# zamba2 SMOKE with the published Mamba2 state
# ----------------------------------------------------------------------

def test_zamba2_state_128_logits_match_jax():
    arch = "zamba2-2.7b"
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), ssm_state=128)
    cfg = dataclasses.replace(get_smoke_config(arch), ssm_state=128)
    jp = jax.jit(jax_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), jcfg)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 72))
    ref, _ = jax.jit(jax_forward, static_argnums=(2,))(
        jp, jnp.asarray(toks, jnp.int32), jcfg)
    out = forward(tp, _t(toks), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
