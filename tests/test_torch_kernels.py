"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
that plain version (the arithmetic the CUDA kernel must reproduce, and what
the card's kernel is compared with) against the JAX oracles.  Inputs come
from a numpy seed and go through both packages.  The Pallas flash kernel
is not used as a reference: it fails on the installed jax (`pl.load`), so
flash is held against `attention_ref` and `blocked_attention`.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
# the plain references compute in full f32 (only matters on a card; stated)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro.core.predictive import forecast_from_diffs as jax_forecast_from_diffs  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.forecast.ref import basis_coeffs as jax_basis_coeffs  # noqa: E402
from repro.kernels.forecast.ref import forecast_ref as jax_forecast_ref  # noqa: E402
from repro.models.layers import blocked_attention as jax_blocked_attention  # noqa: E402
from repro_torch.core import forecast_from_diffs  # noqa: E402
from repro_torch.kernels import flash_attention, forecast, ssd_scan  # noqa: E402
from repro_torch.kernels.flash_attention import (MAX_GRID_Z,  # noqa: E402
                                                 attention_ref, check_grid)
from repro_torch.kernels.forecast import basis_coeffs, forecast_ref  # noqa: E402
from repro_torch.models.layers import blocked_attention  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _qkv(B, Sq, Sk, H, KH, D, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32))


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------

FLASH_SHAPES = [
    (1, 128, 128, 4, 4, 64),    # MHA
    (2, 256, 256, 8, 2, 64),    # GQA group 4
    (1, 128, 256, 4, 1, 32),    # MQA, q at the tail of k
    (1, 512, 512, 4, 2, 128),   # widest head dim the kernel takes
    (2, 256, 256, 16, 16, 72),  # DiT-XL attention (head dim 72)
    (1, 77, 77, 4, 4, 72),      # ragged length (text)
]


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_jax(B, Sq, Sk, H, KH, D, causal, window):
    """Tolerance 3e-5 abs / 1e-4 rel: f32 sums in another order."""
    q, k, v = _qkv(B, Sq, Sk, H, KH, D)
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window)
    blk = jax_blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(blk), atol=3e-5,
                               rtol=1e-4)


def test_flash_fully_masked_rows_match_reference():
    """q longer than k: causal rows before the first key see no key at all
    and average all of v, as the reference does."""
    q, k, v = _qkv(1, 64, 32, 2, 2, 16)
    out = attention_ref(_t(q), _t(k), _t(v), causal=True)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_blocked_attention_matches_jax(causal, window):
    """The port's chunked reference, chunked (Sq 256 over chunk 64) and not;
    tolerance 3e-5 abs / 1e-4 rel."""
    q, k, v = _qkv(2, 256, 256, 4, 2, 32, seed=3)
    ref = jax_blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                chunk=64)
    for chunk in (64, 512):
        out = blocked_attention(_t(q), _t(k), _t(v), causal=causal,
                                window=window, chunk=chunk)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                                   rtol=1e-4)


def test_flash_bf16_plain_matches_jax():
    """bf16 in, bf16 out; tolerance 3e-2 abs / 1e-2 rel (bf16 rounding)."""
    q, k, v = _qkv(1, 128, 128, 4, 2, 64)
    qt, kt, vt = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_attention(qt, kt, vt)
    assert out.dtype == torch.bfloat16
    ref = jax_attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=3e-2,
                               rtol=1e-2)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card raises; the
    wrappers take the plain version for CPU tensors only."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    d = torch.empty((3, 64), device="meta")
    with pytest.raises(ValueError):
        forecast(d, torch.empty((3,), device="meta"))
    x = torch.empty((1, 8, 2, 4), device="meta")
    s = torch.empty((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        ssd_scan(x, torch.empty((1, 8, 2), device="meta"),
                 torch.empty((2,), device="meta"), s, s)
    with pytest.raises(ValueError):       # one input on the CPU, one not
        ssd_scan(x, torch.empty((1, 8, 2)), torch.empty((2,)), s, s)
    assert (flash_attention.launches, forecast.launches,
            ssd_scan.launches) == (0, 0, 0)


def test_flash_grid_guard():
    """The CUDA branch's gridDim.z guard: a batch above 65535 raises before
    any launch; the plain CPU path keeps no limit, as JAX has none."""
    check_grid(MAX_GRID_Z)
    with pytest.raises(ValueError, match="gridDim.z"):
        check_grid(MAX_GRID_Z + 1)
    q = torch.ones((MAX_GRID_Z + 1, 1, 1, 8))
    out = flash_attention(q, q, q, causal=False)
    assert out.shape == q.shape and bool((out == 1).all())


# ----------------------------------------------------------------------
# forecast
# ----------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("basis", ["taylor", "newton", "hermite", "ab"])
def test_basis_coeffs_match_jax(order, basis):
    """Tolerance 1e-6 abs / 1e-6 rel: the same f32 formulas."""
    for u, n_valid in [(1.75, None), (0.25, 2), (3.0, 1)]:
        out = basis_coeffs(order, u, basis, n_valid=n_valid)
        ref = jax_basis_coeffs(order, u, basis, n_valid=n_valid)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("basis", ["taylor", "newton", "hermite", "ab"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_plain_matches_jax(basis, dtype):
    """Odd N (3*130*17); tolerance 1e-5 in f32, 5e-2 in bf16 (rounding of
    the bf16 output)."""
    rng = np.random.default_rng(11)
    for order in (1, 2, 3, 4):
        d = rng.standard_normal((order + 1, 3, 130, 17), np.float32)
        c = np.asarray(jax_basis_coeffs(order, 1.75, basis))
        jd = jnp.asarray(d, dtype)
        td = _t(d).to(getattr(torch, dtype))
        out = forecast(td, _t(c))
        assert out.dtype == td.dtype and out.shape == td.shape[1:]
        ref = jax_forecast_ref(jd, jnp.asarray(c))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=1e-5 if dtype == "float32" else 5e-2)


def test_forecast_batched_equals_rows():
    """(B, m+1, N) with (B, m+1) coefficients is B independent forecasts."""
    rng = np.random.default_rng(5)
    d = _t(rng.standard_normal((5, 3, 4097), np.float32))
    c = _t(rng.standard_normal((5, 3), np.float32))
    out = forecast(d, c)
    for b in range(5):
        np.testing.assert_allclose(out[b].numpy(),
                                   forecast_ref(d[b], c[b]).numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("basis", ["taylor", "hermite"])
def test_slot_batched_forecast_matches_jax_loop(basis):
    """One batched forecast over S slots (own u and n_valid each) equals a
    loop of JAX forecast_from_diffs; tolerance 1e-5 abs / 1e-5 rel."""
    rng = np.random.default_rng(2)
    S, order = 4, 2
    diffs = rng.standard_normal((S, order + 1, 16, 8), np.float32)
    u = np.array([0.25, 0.5, 0.75, 1.5], np.float32)
    n_valid = np.array([0, 1, 2, 5], np.int32)
    out = forecast_from_diffs(_t(diffs), _t(u), _t(n_valid), basis)
    for s in range(S):
        ref = jax_forecast_from_diffs(jnp.asarray(diffs[s]), u[s], n_valid[s],
                                      basis)
        np.testing.assert_allclose(out[s].numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------
# import hygiene
# ----------------------------------------------------------------------

def test_port_imports_no_jax_and_no_repro():
    """The port, its examples, chip_smoke.py and the tools import neither
    JAX nor the JAX package."""
    root = SRC.parent
    paths = (sorted((SRC / "repro_torch").rglob("*.py"))
             + sorted((root / "examples").glob("torch_*.py"))
             + [root / "chip_smoke.py"]
             + sorted((root / "tools").glob("*.py")))
    assert len(paths) > 3 and all(p.exists() for p in paths)
    bad = []
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(root)}: {name}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serving.diffusion, "
            "repro_torch.bridge, repro_torch.diffusion, repro_torch.kernels, "
            "repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.models.transformer, repro_torch.data, "
            "repro_torch.optim, repro_torch.checkpoint, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.tree, "
            "repro_torch.diffusion.dlm, repro_torch.sharding, "
            "repro_torch.spmd, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun, repro_torch.launch.perf_dit; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
