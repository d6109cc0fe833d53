"""Public wrappers for the forecast kernel.

  forecast(diffs, coeffs)       the weighted sum with given weights (the
                                exact function of JAX's `forecast_pallas`)
  forecast_basis(diffs, steps, last_step, n_valid, interval, basis, sigma)
                                the weights evaluated in the kernel's
                                prologue: a skip tick's whole forecast in
                                one launch

CPU tensors take the plain version (`forecast_ref`, after `basis_coeffs`
for `forecast_basis`).  CUDA tensors launch `csrc/forecast.cu` or raise:
there is no fallback on the card.  Both share one lean host path
(`_build.launch`).  `forecast.launches` counts launches of the kernel from
either entry point and `forecast.flops` the products they compute,
2*B*(m+1)*n a launch (plain integers; counted on the CUDA path only, where
`FlopCounterMode` cannot see the ctypes launch: on CPU tensors it counts
`forecast_ref`'s product as the same number).

Under grad (grad mode on and an input requiring a gradient) the CUDA path
raises: the kernel has no backward, and no training path runs it.  The
CPU path stays differentiable through `forecast_ref`."""
from __future__ import annotations

import torch

from repro_torch.device import to_device

from .. import _build
from .ref import basis_coeffs, forecast_ref

_BASES = {"taylor": 0, "newton": 1, "hermite": 2, "ab": 3, "foca": 4}
_NO_BACKWARD = "no training path runs the forecast"
MAX_ORDER1 = 8       # order + 1 the kernel takes
MAX_SLOTS = 64       # slots of one forecast_basis launch


def _code(diffs, name) -> int:
    """The kernel's dtype code of a contiguous CUDA stack, or raise."""
    dtype = diffs.dtype
    code = (0 if dtype is torch.float32 else 1 if dtype is torch.bfloat16
            else -1)
    if code < 0:
        raise TypeError(f"{name}: diffs float32 or bfloat16 required (got "
                        f"{dtype})")
    if not diffs.is_contiguous():
        raise ValueError(f"{name}: diffs must be contiguous")
    return code


def _vec(ptr, code, n) -> int:
    """16-byte access: whole 16-byte rows from a 16-byte aligned pointer
    (the output comes from the caching allocator, so it is aligned)."""
    return int(n % (8 if code else 4) == 0 and ptr % 16 == 0)


def forecast(diffs, coeffs):
    """Fused `sum_i coeffs[..., i] * diffs[..., i, :]`.

    diffs (m+1, ...) with coeffs (m+1,) -> (...), or a batch: diffs
    (B, m+1, ...) with coeffs (B, m+1) -> (B, ...).  Output in diffs'
    dtype, accumulated in f32."""
    cd = coeffs.dim()
    shape = diffs.shape
    if cd == 2:
        batch, m1 = coeffs.shape
        ok = len(shape) > 2 and shape[0] == batch and shape[1] == m1
    else:
        batch, m1 = 1, coeffs.shape[0] if cd == 1 else 0
        ok = cd == 1 and len(shape) > 1 and shape[0] == m1
    if not ok:
        raise ValueError(f"forecast: diffs {tuple(shape)} does not match "
                         f"coeffs {tuple(coeffs.shape)} (m+1,) or (B, m+1)")
    if not diffs.is_cuda:
        if diffs.device.type == "cpu" and coeffs.device.type == "cpu":
            return forecast_ref(diffs, coeffs)
        raise ValueError(f"forecast: diffs and coeffs must share one CUDA "
                         f"device or both be on the CPU (got {diffs.device}, "
                         f"{coeffs.device})")
    dev = diffs.get_device()
    if coeffs.get_device() != dev:
        raise ValueError(f"forecast: diffs and coeffs must share one CUDA "
                         f"device (got {diffs.device}, {coeffs.device})")
    _build.no_grad_launch("forecast", _NO_BACKWARD, diffs, coeffs)
    code = _code(diffs, "forecast")
    if coeffs.dtype is not torch.float32 or not coeffs.is_contiguous():
        raise TypeError(f"forecast: coeffs must be contiguous float32 (got "
                        f"{coeffs.dtype})")
    if m1 > MAX_ORDER1:
        raise ValueError(f"forecast: {m1} weights, the kernel takes at most "
                         f"{MAX_ORDER1}")
    out = diffs.new_empty(shape[1:] if cd == 1 else (batch, *shape[2:]))
    n = out.numel() // batch
    ptr = diffs.data_ptr()
    _build.launch("forecast_fwd", dev, ptr, coeffs.data_ptr(), out.data_ptr(),
                  code, batch, m1, n, _vec(ptr, code, n))
    forecast.launches += 1
    forecast.flops += 2 * batch * m1 * n
    return out


forecast.launches = 0
forecast.flops = 0


def forecast_basis(diffs, steps, last_step, n_valid, interval: int,
                   basis: str = "taylor", sigma: float = 0.5):
    """The forecast of the predictive policies at u = (step - last_step) /
    interval, its weights from `basis_coeffs(order, u, basis, sigma,
    n_valid)`, in one launch.

    Batched: diffs (S, m+1, ...), steps, last_step and n_valid (S,) int32
    on diffs' device -> (S, ...).  Unbatched: diffs (m+1, ...), 0-d steps,
    last_step and n_valid -> (...).  The kernel reads all three from
    device memory, so a captured launch reads the steps its replay finds
    there; `steps` given as host data (an int, a numpy array) is copied to
    the device first (`repro_torch.device.to_device`, no sync), and a
    `Staged` input gives its device buffer.  Output in diffs' dtype,
    accumulated in f32."""
    code_b = _BASES.get(basis)
    if code_b is None:
        raise ValueError(f"forecast_basis: unknown basis {basis}")
    batched = last_step.dim() == 1
    shape = diffs.shape
    S = shape[0] if batched else 1
    if (len(shape) <= 1 + batched or last_step.shape != n_valid.shape
            or (batched and last_step.shape[0] != S)):
        raise ValueError(f"forecast_basis: diffs {tuple(shape)}, last_step "
                         f"{tuple(last_step.shape)} and n_valid "
                         f"{tuple(n_valid.shape)} do not match")
    m1 = shape[batched]
    if not diffs.is_cuda:
        if {diffs.device.type, last_step.device.type,
                n_valid.device.type} != {"cpu"}:
            raise ValueError(f"forecast_basis: tensors must share one CUDA "
                             f"device or all be on the CPU (got "
                             f"{diffs.device}, {last_step.device}, "
                             f"{n_valid.device})")
        u = (to_device(steps, diffs.device, torch.int32)
             - last_step).float() / float(interval)
        return forecast_ref(diffs, basis_coeffs(m1 - 1, u, basis, sigma,
                                                n_valid))
    dev = diffs.get_device()
    if last_step.get_device() != dev or n_valid.get_device() != dev:
        raise ValueError(f"forecast_basis: tensors must share one CUDA device "
                         f"(got {diffs.device}, {last_step.device}, "
                         f"{n_valid.device})")
    _build.no_grad_launch("forecast_basis", _NO_BACKWARD, diffs)
    code = _code(diffs, "forecast_basis")
    if (last_step.dtype is not torch.int32 or n_valid.dtype is not torch.int32
            or not (last_step.is_contiguous() and n_valid.is_contiguous())):
        raise TypeError("forecast_basis: last_step and n_valid must be "
                        "contiguous int32")
    if m1 > MAX_ORDER1 or S > MAX_SLOTS or interval < 1:
        raise ValueError(f"forecast_basis: {m1} weights (at most "
                         f"{MAX_ORDER1}), {S} slots (at most {MAX_SLOTS}), "
                         f"interval {interval}")
    steps = to_device(steps, diffs.device, torch.int32)
    if steps.numel() != S or not steps.is_contiguous():
        raise ValueError(f"forecast_basis: {steps.numel()} steps for {S} "
                         f"slots (contiguous int32 on diffs' device)")
    out = diffs.new_empty((S, *shape[2:]) if batched else shape[1:])
    n = out.numel() // S
    ptr = diffs.data_ptr()
    _build.launch("forecast_basis_fwd", dev, ptr, steps.data_ptr(),
                  last_step.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
                  code, S, m1, n, _vec(ptr, code, n), code_b, int(interval),
                  float(sigma))
    forecast.launches += 1
    forecast.flops += 2 * S * m1 * n
    return out


__all__ = ["forecast", "forecast_basis", "forecast_ref", "basis_coeffs"]
