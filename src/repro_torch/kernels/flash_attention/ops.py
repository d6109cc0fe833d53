"""Public wrappers for the flash-attention kernels.

  flash_attention(q, k, v)          the forward: softmax(q k^T scale) v
  flash_attention_backward(...)     (dq, dk, dv) from the forward's output,
                                    its row log-sum-exp and dO

CPU tensors take the plain versions (`attention_ref`, `attention_bwd_ref`).
CUDA tensors launch `csrc/flash_attention.cu` (serving),
`csrc/flash_attention_lse.cu` (the same kernels writing the row
log-sum-exp, under grad) and `csrc/flash_attention_bwd.cu` (its f32
half built from `csrc/flash_attention_bwd_f32.cu`; head dims above 128
from `csrc/flash_attention_bwd_wide.cu`), or raise: there is no fallback
on the card.  Head dims up to `MAX_HEAD_DIM` (128) in f32 and bf16; up to
`MAX_HEAD_DIM_BF16_WIDE` (160, pixtral-12b) for bf16 with 16-byte rows
and pointers, serving and under grad.

v may have a smaller head dim Dv than q and k (deepseek-v2's MLA: 192
over 128); the output then has Dv.  bf16 with 128 < D <=
`MAX_HEAD_DIM_SPLIT` (192), Dv <= 128, launches the split instantiations
(`flash_attention_fwd_split`, and under grad `flash_attention_fwd_split_lse`
and `flash_attention_bwd_wide`).  D <= 128, in any dtype or under grad,
zero-pads v to D, runs the forward (and backward) above and keeps the
first Dv columns: the zero columns add exactly 0 to each output column
kept, and their gradient is dropped.  f32 above 128 raises (ROADMAP.md
§B.1: no configuration of the repository reaches it), as does anything
else the kernels do not take.

The forward runs bf16 inputs on bf16 tensor-core products (P rounded to
bf16 before P V, as `blocked_attention` does) and f32 inputs as 3xTF32;
its C entry point picks 16-byte or element-by-element staging from D and
the pointers' alignment.

Under grad (grad mode on and q, k or v requiring a gradient) a CUDA call
goes through a `torch.autograd.Function`: the forward also writes each
row's log-sum-exp and saves q, k, v, o and it, and the backward launches
the backward kernels on a contiguous dO.  Otherwise the call takes the
serving path, which writes no log-sum-exp.  On the CPU `attention_ref` is
differentiable itself.

`flash_attention.launches` counts forward launches and
`flash_attention_backward.launches` backward launches (three kernels a
launch, Delta, dK/dV and dQ; four above 128, where dV and dK are two
walks); `flash_attention.flops` counts the forward's products,
4*B*H*Sq*Sk*D a launch, 2*B*H*Sq*Sk*(D + Dv) for the split instantiation,
and `flash_attention_backward.flops` the backward's five,
2*B*H*Sq*Sk*(3*D + 2*Dv) (plain integers).  The FLOPs are counted on the
CUDA path only: a ctypes launch is no aten operator, so `FlopCounterMode`
cannot see it, while on CPU tensors it counts `attention_ref`'s two
products as the same 4*B*H*Sq*Sk*D."""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import attention_bwd_ref, attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: the one wider instantiation of the forward and the backward (bf16,
#: 16-byte staging), serving and under grad
MAX_HEAD_DIM_BF16_WIDE = 160
#: the split instantiations: q/k head dim up to 192 over a v head dim up to
#: MAX_HEAD_DIM (bf16, 16-byte staging), serving and under grad
MAX_HEAD_DIM_SPLIT = 192
_F32_WIDE = ("f32 above head dim 128 has no kernel (ROADMAP.md §B.1; every "
             "configuration with a wider head has bf16 params)")
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


def _forward(q, k, v, causal, window, scale, lse):
    """Launch the forward kernel; `lse` is None (serving) or a (B, H, Sq)
    f32 buffer for the rows' log-sum-exp (training: the kLse
    instantiations, `csrc/flash_attention_lse.cu`).  A v head dim Dv
    below D takes the split instantiation."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if Dv != D:
        return _forward_split(q, k, v, causal, window, scale, lse)
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    args = (_DTYPES[q.dtype], B, Sq, Sk, H, KH, D, int(bool(causal)),
            int(window), float(scale))
    if lse is None:
        _build.launch("flash_attention_fwd", q.get_device(), *ptrs, *args)
    else:
        _build.launch("flash_attention_fwd_lse", q.get_device(), *ptrs,
                      lse.data_ptr(), *args)
    flash_attention.launches += 1
    flash_attention.flops += 4 * B * H * Sq * Sk * D
    return o


def _forward_split(q, k, v, causal, window, scale, lse):
    """The split instantiation (Dv < D, bf16, 128 < D): serving, or with
    the rows' log-sum-exp into `lse`."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    args = (_DTYPES[q.dtype], B, Sq, Sk, H, KH, D, Dv, int(bool(causal)),
            int(window), float(scale))
    if lse is None:
        _build.launch("flash_attention_fwd_split", q.get_device(), *ptrs,
                      *args)
    else:
        _build.launch("flash_attention_fwd_split_lse", q.get_device(), *ptrs,
                      lse.data_ptr(), *args)
    flash_attention.launches += 1
    flash_attention.flops += 2 * B * H * Sq * Sk * (D + Dv)
    return o


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward with its row log-sum-exp, and the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        o = _forward(q, k, v, causal, window, scale, lse)
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
        return dq, dk, dv, None, None, None


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
    if Dv < D:
        return _split_head_dim(q, k, v, causal, window, scale, grad)
    if D > MAX_HEAD_DIM:
        _check_wide_head_dim(q, k, v)
    check_grid(B)
    if grad:
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, None)


def _split_head_dim(q, k, v, causal, window, scale, grad):
    """A v head dim Dv below D (CUDA tensors): the split instantiations for
    bf16 above 128, else v zero-padded to D through the forward (and
    backward) of D <= 128, else raise."""
    B, D, Dv = q.shape[0], q.shape[-1], v.shape[-1]
    if D <= MAX_HEAD_DIM:
        o = flash_attention(q, k, torch.nn.functional.pad(v, (0, D - Dv)),
                            causal=causal, window=window, scale=scale)
        return o[..., :Dv]
    _check_split(q, k, v, "flash_attention")
    check_grid(B)
    if grad:
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward_split(q, k, v, causal, window, scale, None)


def _check_split(q, k, v, name):
    """Raise unless the split instantiations take these tensors: bf16, D
    <= 192 over Dv <= 128, 16-byte rows and pointers."""
    D, Dv = q.shape[-1], v.shape[-1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: q/k head dim {D} over v head dim {Dv} "
                         f"in {q.dtype}: {_F32_WIDE}")
    if D > MAX_HEAD_DIM_SPLIT or Dv > MAX_HEAD_DIM:
        raise ValueError(f"{name}: q/k head dim {D} over v head dim {Dv}: "
                         f"the split instantiations take D <= "
                         f"{MAX_HEAD_DIM_SPLIT} over Dv <= {MAX_HEAD_DIM}")
    if D % 8 or Dv % 8 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the split head dim ({D} over {Dv}) needs "
                         f"16-byte rows and 16-byte aligned tensors")


def _check_wide_head_dim(q, k, v):
    """Raise unless the head-dim-160 instantiations take these tensors:
    bf16, D <= 160, 16-byte rows and pointers."""
    D = q.shape[-1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: head dim {D} in {q.dtype}: "
                         f"{_F32_WIDE}")
    if D > MAX_HEAD_DIM_BF16_WIDE:
        raise ValueError(f"flash_attention: head dim {D} > "
                         f"{MAX_HEAD_DIM_BF16_WIDE}, the widest "
                         f"instantiation (a v head dim below it takes the "
                         f"split ones, to {MAX_HEAD_DIM_SPLIT})")
    if D % 8 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM} "
                         f"needs 16-byte rows and 16-byte aligned tensors")


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
    wide = D > MAX_HEAD_DIM
    if wide:
        if Dv < D:
            _check_split(q, k, v, "flash_attention_backward")
        else:
            _check_wide_head_dim(q, k, v)
        if do.data_ptr() % 16:
            raise ValueError("flash_attention_backward: head dims above "
                             f"{MAX_HEAD_DIM} need a 16-byte aligned dO")
    elif Dv < D:
        raise ValueError(f"flash_attention_backward: v head dim {Dv} below "
                         f"D {D} <= {MAX_HEAD_DIM}: pad v to D, as "
                         f"flash_attention does")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    mask = (int(bool(causal)), int(window), float(scale))
    if wide:
        _build.launch("flash_attention_bwd_wide", q.get_device(), *ptrs,
                      _DTYPES[q.dtype], B, Sq, Sk, H, KH, D, Dv, *mask)
    else:
        _build.launch("flash_attention_bwd", q.get_device(), *ptrs,
                      _DTYPES[q.dtype], B, Sq, Sk, H, KH, D, *mask)
    flash_attention_backward.launches += 1
    flash_attention_backward.flops += 2 * B * H * Sq * Sk * (3 * D + 2 * Dv)
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.flops = 0
flash_attention_backward.launches = 0
flash_attention_backward.flops = 0
