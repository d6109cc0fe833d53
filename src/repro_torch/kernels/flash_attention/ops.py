"""Public wrappers for the flash-attention kernels.

  flash_attention(q, k, v)          the forward: softmax(q k^T scale) v
  flash_attention_backward(...)     (dq, dk, dv) from the forward's output,
                                    its row log-sum-exp and dO
  route(dtype, D, Dv, aligned, grad)  the CUDA unit a call launches

CPU tensors take the plain versions (`attention_ref`, `attention_bwd_ref`).
CUDA tensors launch a kernel or raise: there is no fallback on the card.
`route`, a pure function of the dtype, the head dims, whether rows and
pointers are 16-byte aligned and whether the call is under grad, picks
the unit; every head dim D >= 1 with a v head dim 1 <= Dv <= D, in f32 and
bf16, has one:

  D <= 128, Dv == D   csrc/flash_attention.cu (serving), its kLse build
                      csrc/flash_attention_lse.cu (under grad) and
                      csrc/flash_attention_bwd.cu (its f32 half from
                      csrc/flash_attention_bwd_f32.cu and _f32_hi.cu);
                      any alignment
  Dv < D <= 128       v zero-padded to D through the above, the first Dv
                      columns kept: the zero columns add exactly 0 to each
                      output column kept, and their gradient is dropped
  bf16, aligned, Dv == D <= 160 (pixtral-12b), or D <= 192 over Dv <= 128
                      (deepseek-v2's MLA): the instantiations at 160 and
                      the split ones of flash_attention.cu / _lse.cu, and
                      csrc/flash_attention_bwd_wide.cu (wgmma)
  anything else       csrc/flash_attention_any.cu (forward, with or
                      without the log-sum-exp) and
                      csrc/flash_attention_bwd_any.cu: f32 above 128, bf16
                      above 160 (or 192, or Dv above 128), and rows or
                      pointers that are not 16-byte aligned above 128

What still raises is not a width: a dtype other than f32 and bf16 (f16
included), Dv > D, tensors on several devices or not contiguous, and a
batch above the grid's z limit (`check_grid`).

The forward runs bf16 inputs on bf16 tensor-core products (P rounded to
bf16 before P V, as `blocked_attention` does) and f32 inputs as 3xTF32.

Under grad (grad mode on and q, k or v requiring a gradient) a CUDA call
goes through a `torch.autograd.Function`: the forward also writes each
row's log-sum-exp and saves q, k, v, o and it, and the backward launches
the backward kernels on a contiguous dO.  Otherwise the call takes the
serving path, which writes no log-sum-exp.  On the CPU `attention_ref` is
differentiable itself.

`flash_attention.launches` counts forward launches and
`flash_attention_backward.launches` backward launches (three kernels a
launch in every unit: Delta, dK/dV and dQ);
`_build.launches` counts each C entry point's launches, so
`flash_attention_fwd_any` and `flash_attention_bwd_any` there count those
that went to the general units.
`flash_attention.flops` counts the forward's products, 2*B*H*Sq*Sk*(D +
Dv) a launch, and `flash_attention_backward.flops` the backward's five,
2*B*H*Sq*Sk*(3*D + 2*Dv) (plain integers).  The FLOPs are counted on the CUDA path only: a
ctypes launch is no aten operator, so `FlopCounterMode` cannot see it,
while on CPU tensors it counts `attention_ref`'s two products as the same
4*B*H*Sq*Sk*D."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import _build
from .ref import attention_bwd_ref, attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head dim of flash_attention.cu's base instantiations
MAX_HEAD_DIM = 128
#: bf16 with 16-byte rows: flash_attention.cu's instantiation at 160 ...
WIDE_HEAD_DIM = 160
#: ... and its split ones, q/k up to 192 over v up to 128
SPLIT_HEAD_DIM, SPLIT_V_HEAD_DIM = 192, 128
#: the general units, csrc/flash_attention_any.cu and _bwd_any.cu
ANY_FWD, ANY_BWD = "flash_attention_fwd_any", "flash_attention_bwd_any"
#: the entries that take v's head dim beside q/k's
_TAKES_DV = ("flash_attention_fwd_split", "flash_attention_fwd_split_lse",
             ANY_FWD, "flash_attention_bwd_wide", ANY_BWD)


class Route(NamedTuple):
    """The C entry points a call launches: `forward` (the kLse one under
    grad), `backward` (None unless grad), and `pad_v`: v is zero-padded to
    D and the call routed as Dv == D."""
    forward: str
    backward: Optional[str]
    pad_v: bool = False


def route(dtype, D: int, Dv: int, aligned: bool, grad: bool) -> Route:
    """The unit of a CUDA call with q/k head dim D, v head dim Dv, `aligned`
    16-byte rows (D and Dv) and pointers, under grad or not.  Raises for a
    dtype other than f32 and bf16 and for Dv outside 1 .. D."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q, k, v must be float32 or "
                        f"bfloat16 (got {dtype})")
    if not 1 <= Dv <= D:
        raise ValueError(f"flash_attention: v head dim {Dv} outside 1 .. "
                         f"the q/k head dim {D}")
    if Dv < D <= MAX_HEAD_DIM:
        return route(dtype, D, D, aligned, grad)._replace(pad_v=True)
    wide = dtype == torch.bfloat16 and aligned
    if D <= MAX_HEAD_DIM:
        fwd, bwd = "flash_attention_fwd", "flash_attention_bwd"
    elif wide and Dv == D <= WIDE_HEAD_DIM:
        fwd, bwd = "flash_attention_fwd", "flash_attention_bwd_wide"
    elif wide and Dv < D <= SPLIT_HEAD_DIM and Dv <= SPLIT_V_HEAD_DIM:
        fwd, bwd = "flash_attention_fwd_split", "flash_attention_bwd_wide"
    else:
        return Route(ANY_FWD, ANY_BWD if grad else None)
    return Route(fwd + "_lse", bwd) if grad else Route(fwd, None)


def aligned16(D: int, Dv: int, tensors) -> bool:
    """16-byte rows of D and Dv elements and 16-byte aligned tensors."""
    el = tensors[0].element_size()
    return (D * el) % 16 == 0 and (Dv * el) % 16 == 0 \
        and all(t.data_ptr() % 16 == 0 for t in tensors)


#: the launch puts the batch on gridDim.z (csrc/flash_attention.cu:425)
MAX_GRID_Z = 65535


def check_grid(batch: int) -> None:
    """Raise before a launch whose batch exceeds the grid's z limit (a
    folded attention batch, such as the video DiT's B*P temporal
    sequences, can reach it)."""
    if batch > MAX_GRID_Z:
        raise ValueError(f"flash_attention: batch {batch} > {MAX_GRID_Z}, "
                         f"the kernel's gridDim.z limit")


def _check_cuda(name, tensors):
    """Raise unless every tensor is a contiguous float32 / bfloat16 tensor
    of q's dtype on one CUDA device."""
    if {t.device.type for t in tensors} != {"cuda"} \
            or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors must share one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v must all be float32 or bfloat16 "
                        f"(got {[str(t.dtype) for t in tensors]})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _forward(q, k, v, causal, window, scale, lse, entry):
    """Launch the forward entry `entry` (a `Route.forward`); `lse` is None
    (serving) or a (B, H, Sq) f32 buffer for the rows' log-sum-exp (the
    kLse entries, and the general unit's with lse)."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if entry == ANY_FWD:      # one entry: serving (a null lse) or with lse
        ptrs += (None if lse is None else lse.data_ptr(),)
    elif lse is not None:
        ptrs += (lse.data_ptr(),)
    dims = (D, Dv) if entry in _TAKES_DV else (D,)
    _build.launch(entry, q.get_device(), *ptrs, _DTYPES[q.dtype], B, Sq, Sk,
                  H, KH, *dims, int(bool(causal)), int(window), float(scale))
    flash_attention.launches += 1
    flash_attention.flops += 2 * B * H * Sq * Sk * (D + Dv)
    return o


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward with its row log-sum-exp, and the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, entry):
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        o = _forward(q, k, v, causal, window, scale, lse, entry)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_backward(q, k, v, o, do.contiguous(), lse,
                                              causal=causal, window=window,
                                              scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k: (B, Sk, KH, D); v: (B, Sk, KH, Dv), Dv <= D,
    KH divides H -> (B, Sq, H, Dv) in q's dtype.  q sits at the tail of the
    key sequence."""
    B, Sq, H, D = q.shape
    Bk, Sk, KH, Dk = k.shape
    Dv = v.shape[-1]
    if v.shape[:3] != k.shape[:3] or Bk != B or Dk != D or Dv > D \
            or H % KH != 0:
        raise ValueError(f"flash_attention: incompatible shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if {t.device.type for t in (q, k, v)} == {"cpu"}:
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check_cuda("flash_attention", (q, k, v))
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    r = route(q.dtype, D, Dv, aligned16(D, Dv, (q, k, v)), grad)
    if r.pad_v:
        o = flash_attention(q, k, torch.nn.functional.pad(v, (0, D - Dv)),
                            causal=causal, window=window, scale=scale)
        return o[..., :Dv]
    check_grid(B)
    if grad:
        return _FlashAttention.apply(q, k, v, causal, window, scale, r.forward)
    return _forward(q, k, v, causal, window, scale, None, r.forward)


def flash_attention_backward(q, k, v, o, do, lse, *, causal=True, window=0,
                             scale=None):
    """(dq, dk, dv) of `flash_attention(q, k, v)` for the output gradient
    `do`, given its output `o` and row log-sum-exp `lse` (B, H, Sq) f32;
    o and do have v's head dim Dv <= D.  Each gradient comes in its
    input's shape and dtype, GQA groups summed into their kv head."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if o.shape != q.shape[:3] + (Dv,) or do.shape != o.shape \
            or tuple(lse.shape) != (B, H, Sq) or Dv > D:
        raise ValueError(f"flash_attention_backward: o{tuple(o.shape)}, "
                         f"do{tuple(do.shape)} and lse{tuple(lse.shape)} do "
                         f"not fit q{tuple(q.shape)} and v{tuple(v.shape)}")
    ts = (q, k, v, o, do, lse)
    if {t.device.type for t in ts} == {"cpu"}:
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                 window=window, scale=scale)
    _check_cuda("flash_attention_backward", (q, k, v, o, do))
    if lse.device != q.device or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be a contiguous "
                         "float32 tensor on q's device")
    check_grid(B)
    r = route(q.dtype, D, Dv, aligned16(D, Dv, (q, k, v, o, do)), True)
    if r.pad_v:
        raise ValueError(f"flash_attention_backward: v head dim {Dv} below "
                         f"D {D} <= {MAX_HEAD_DIM}: pad v to D, as "
                         f"flash_attention does")
    return _backward(q, k, v, o, do, lse, causal, window, scale, r.backward)


def _backward(q, k, v, o, do, lse, causal, window, scale, entry):
    """Launch the backward entry `entry` (a `Route.backward`) on checked
    CUDA inputs."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    dims = (D, Dv) if entry in _TAKES_DV else (D,)
    _build.launch(entry, q.get_device(), *ptrs, _DTYPES[q.dtype], B, Sq, Sk,
                  H, KH, *dims, int(bool(causal)), int(window), float(scale))
    flash_attention_backward.launches += 1
    flash_attention_backward.flops += 2 * B * H * Sq * Sk * (3 * D + 2 * Dv)
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.flops = 0
flash_attention_backward.launches = 0
flash_attention_backward.flops = 0
