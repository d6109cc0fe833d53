"""Public wrapper for the flash-attention kernel.

CPU tensors take the plain version (`attention_ref`).  CUDA tensors launch
`csrc/flash_attention.cu` or raise: there is no fallback on the card.  The
kernel runs bf16 inputs on bf16 tensor-core products (P rounded to bf16
before P V, as `blocked_attention` does) and f32 inputs as 3xTF32; its C
entry point picks 16-byte or element-by-element staging from D and the
pointers' alignment.  `flash_attention.launches` counts kernel launches and
`flash_attention.flops` the products they compute, 4*B*H*Sq*Sk*D a launch
(plain integers).  The FLOPs are counted on the CUDA path only: a ctypes
launch is no aten operator, so `FlopCounterMode` cannot see it, while on
CPU tensors it counts `attention_ref`'s two products as the same
4*B*H*Sq*Sk*D."""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: the launch puts the batch on gridDim.z (csrc/flash_attention.cu:425)
MAX_GRID_Z = 65535


def check_grid(batch: int) -> None:
    """Raise before a launch whose batch exceeds the grid's z limit (a
    folded attention batch, such as the video DiT's B*P temporal
    sequences, can reach it)."""
    if batch > MAX_GRID_Z:
        raise ValueError(f"flash_attention: batch {batch} > {MAX_GRID_Z}, "
                         f"the kernel's gridDim.z limit")



def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D), KH divides H -> (B, Sq, H, D)
    in q's dtype.  q sits at the tail of the key sequence."""
    B, Sq, H, D = q.shape
    Bk, Sk, KH, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % KH != 0:
        raise ValueError(f"flash_attention: incompatible shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if devices != {"cuda"} or len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"flash_attention: q, k, v must share one CUDA "
                         f"device (got {[str(t.device) for t in (q, k, v)]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    check_grid(B)
    o = torch.empty_like(q)
    _build.launch("flash_attention_fwd", q.get_device(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
                  B, Sq, Sk, H, KH, D, int(bool(causal)), int(window),
                  float(scale))
    flash_attention.launches += 1
    flash_attention.flops += 4 * B * H * Sq * Sk * D
    return o


flash_attention.launches = 0
flash_attention.flops = 0
