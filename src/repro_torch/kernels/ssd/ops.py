"""Public wrapper for the SSD scan kernel.

CPU tensors take the plain version (`ssd_ref`).  CUDA tensors launch
`csrc/ssd.cu` (a C B^T pass and the scan, from one C entry point) or raise:
there is no fallback on the card.  `ssd_scan.launches` counts calls that
launched the kernels (a plain integer).

x, B and C are read in place, in their own dtype (f32 or bf16) and through
their strides, as long as the last axis has a unit stride: on the serving
path they are views of the conv output.  Both take 64-token chunks.  The
kernel masks a ragged tail, where the plain version, as JAX's does, takes
the whole sequence as one chunk; the scan's result does not depend on the
chunking beyond rounding (held at 2e-4 abs / 1e-3 rel against the plain
version).

Under grad (grad mode on and an input requiring a gradient) the CUDA path
raises: the scan has no backward kernel yet (ROADMAP.md §A.6b), so training
zamba2 runs on the CPU, where `ssd_ref` is differentiable."""
from __future__ import annotations

import torch

from .. import _build
from .ref import ssd_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64      # p
MAX_STATE = 64         # n
TILE = 64              # tokens of a tile (the C B^T scratch is per tile)


def ssd_scan(x, dt, A, B_, C_):
    """Mamba2 SSD scan.  x: (b,s,h,p); dt: (b,s,h) softplus'd; A: (h,)
    negative; B_, C_: (b,s,n) shared across heads.  Returns (y (b,s,h,p),
    h_final (b,h,p,n)), both f32."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B_.shape) != (b, s, n) or C_.shape != B_.shape):
        raise ValueError(f"ssd_scan: incompatible shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(B_.shape)} C{tuple(C_.shape)}")
    ts = (x, dt, A, B_, C_)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_ref(x, dt, A, B_, C_)
    if not x.is_cuda or len({t.device for t in ts}) != 1:
        raise ValueError(f"ssd_scan: inputs must share one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if (x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise TypeError(f"ssd_scan: x, B, C float32 or bfloat16 (one dtype) "
                        f"and dt, A float32 required (got "
                        f"{[str(t.dtype) for t in ts]})")
    if x.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1:
        raise ValueError("ssd_scan: x, B and C need a unit stride on their "
                         "last axis")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_scan: dt and A must be contiguous")
    _build.no_grad_launch("ssd_scan", "the SSD scan's backward kernel is "
                          "ROADMAP.md §A.6b", *ts)
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: head dim {p} or state {n} above "
                         f"{MAX_HEAD_DIM}")
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    cb = torch.empty((b, -(-s // TILE), TILE, TILE), dtype=torch.float32,
                     device=dev)
    xs, bs, cs = x.stride(), B_.stride(), C_.stride()
    _build.launch("ssd_fwd", x.get_device(), x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), B_.data_ptr(), C_.data_ptr(), cb.data_ptr(),
                  y.data_ptr(), h_fin.data_ptr(), _DTYPES[x.dtype], b, s, h,
                  p, n, xs[0], xs[1], xs[2], bs[0], bs[1], cs[0], cs[1])
    ssd_scan.launches += 1
    return y, h_fin


ssd_scan.launches = 0
