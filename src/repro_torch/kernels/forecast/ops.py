"""Public wrapper for the forecast kernel.

CPU tensors take the plain version (`forecast_ref`).  CUDA tensors launch
`csrc/forecast.cu` or raise: there is no fallback on the card.
`forecast.launches` counts kernel launches (a plain integer)."""
from __future__ import annotations

import torch

from .. import _build
from .ref import basis_coeffs, forecast_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def forecast(diffs, coeffs):
    """Fused `sum_i coeffs[..., i] * diffs[..., i, :]`.

    diffs (m+1, ...) with coeffs (m+1,) -> (...), or a batch: diffs
    (B, m+1, ...) with coeffs (B, m+1) -> (B, ...).  Output in diffs'
    dtype, accumulated in f32."""
    if coeffs.dim() not in (1, 2):
        raise ValueError(f"forecast: coeffs must be (m+1,) or (B, m+1), "
                         f"got {tuple(coeffs.shape)}")
    batched = coeffs.dim() == 2
    lead = tuple(coeffs.shape)
    if tuple(diffs.shape[:len(lead)]) != lead or diffs.dim() <= len(lead):
        raise ValueError(f"forecast: diffs {tuple(diffs.shape)} does not "
                         f"match coeffs {lead}")
    devices = {diffs.device.type, coeffs.device.type}
    if devices == {"cpu"}:
        return forecast_ref(diffs, coeffs)
    if devices != {"cuda"} or diffs.device != coeffs.device:
        raise ValueError(f"forecast: diffs and coeffs must share one CUDA "
                         f"device (got {diffs.device}, {coeffs.device})")
    if diffs.dtype not in _DTYPES or coeffs.dtype != torch.float32:
        raise TypeError(f"forecast: diffs float32/bfloat16 and coeffs "
                        f"float32 required (got {diffs.dtype}, {coeffs.dtype})")
    if not (diffs.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError("forecast: diffs and coeffs must be contiguous")
    batch = lead[0] if batched else 1
    m1 = lead[-1]
    out_shape = ((batch,) if batched else ()) + tuple(diffs.shape[len(lead):])
    out = torch.empty(out_shape, dtype=diffs.dtype, device=diffs.device)
    n = out.numel() // batch
    vec = 16 // diffs.element_size()
    use_vec = (n % vec == 0 and diffs.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    lib = _build.load()
    with torch.cuda.device(diffs.device):
        stream = torch.cuda.current_stream(diffs.device).cuda_stream
        err = lib.forecast_fwd(diffs.data_ptr(), coeffs.data_ptr(),
                               out.data_ptr(), _DTYPES[diffs.dtype], batch,
                               m1, n, int(use_vec), stream)
    _build.check(err, "forecast")
    forecast.launches += 1
    return out


forecast.launches = 0

__all__ = ["forecast", "forecast_ref", "basis_coeffs"]
