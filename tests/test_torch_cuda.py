"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked `cuda`: they skip without a card (the fixture decides, at run
time).  This file imports torch only, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, forecast  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.forecast import basis_coeffs, forecast_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain references compute in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64), (1, 128, 256, 4, 1, 32),
    (1, 512, 512, 4, 2, 128), (3, 256, 256, 16, 16, 72), (2, 77, 77, 4, 4, 72),
    (1, 64, 32, 2, 2, 16),      # q longer than k: fully masked causal rows
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KH, D, causal, window,
                                    dtype, tol):
    """Tolerance: 1e-4 abs in f32 (sum order), 2e-2 abs in bf16 (output
    rounding)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dt)
    k = torch.randn((B, Sk, KH, D), generator=g, device=cuda).to(dt)
    v = torch.randn((B, Sk, KH, D), generator=g, device=cuda).to(dt)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape", [(3, 1), (3, 127), (4, 3, 4096),
                                   (5, 3, 4097), (3, 294912)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_kernel_matches_plain(cuda, shape, dtype):
    """Batched when the shape has 3 axes.  Tolerance: 2e-6 relative to the
    largest output in f32, one bf16 step (2^-7 relative) in bf16."""
    g = torch.Generator(device=cuda).manual_seed(1)
    d = torch.randn(shape, generator=g, device=cuda).to(getattr(torch, dtype))
    m1 = shape[-2]
    if len(shape) == 3:
        u = torch.linspace(0.25, 1.75, shape[0], device=cuda)
    else:
        u = torch.tensor(0.75, device=cuda)
    c = basis_coeffs(m1 - 1, u, "hermite")
    out = forecast(d, c)
    ref = forecast_ref(d, c)
    torch.cuda.synchronize()
    scale = max(float(ref.float().abs().max()), 1.0)
    tol = 2e-6 * scale if dtype == "float32" else 2 ** -7 * scale
    assert out.shape == ref.shape and out.dtype == d.dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 160), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    d = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError):
        forecast(d, torch.zeros((3,)))          # coeffs on the CPU
