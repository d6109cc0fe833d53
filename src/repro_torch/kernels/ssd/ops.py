"""Public wrapper for the SSD scan kernel.

CPU tensors take the plain version (`ssd_ref`).  CUDA tensors launch
`csrc/ssd.cu` or raise: there is no fallback on the card.
`ssd_scan.launches` counts kernel launches (a plain integer).

Both take 64-token chunks.  The kernel masks a ragged tail, where the
plain version, as JAX's does, takes the whole sequence as one chunk; the
scan's result does not depend on the chunking beyond rounding (held at
2e-4 abs / 1e-3 rel against the plain version)."""
from __future__ import annotations

import torch

from .. import _build
from .ref import ssd_ref

MAX_HEAD_DIM = 64      # p
MAX_STATE = 64         # n


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
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return ssd_ref(x, dt, A, B_, C_)
    if devices != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"ssd_scan: inputs must share one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan: the kernel takes float32 only (got "
                        f"{[str(t.dtype) for t in ts]})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: head dim {p} or state {n} above "
                         f"{MAX_HEAD_DIM}")
    y = torch.empty_like(x)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          B_.data_ptr(), C_.data_ptr(), y.data_ptr(),
                          h_fin.data_ptr(), b, s, h, p, n, stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_fin


ssd_scan.launches = 0
