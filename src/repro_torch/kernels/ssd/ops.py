"""Public wrappers for the SSD scan kernels.

  ssd_scan(x, dt, A, B, C)             the scan: (y, h_final)
  ssd_scan_backward(..., dy, dh_final) its VJP: (dx, ddt, dA, dB, dC)

CPU tensors take the plain versions (`ssd_ref`, `ssd_bwd_ref`).  CUDA
tensors launch `csrc/ssd.cu` (a C B^T pass and the scan, from one C entry
point) and `csrc/ssd_bwd.cu` (the tile-local states and their gradients,
the recurrence between tiles, the per-tile terms of a head group, the
sums over groups) where the head dim p and the state n are at most
`SMALL` (64, zamba2-2.7b's published layer), and `csrc/ssd_any.cu` /
`csrc/ssd_bwd_any.cu`, the same decomposition over 64-wide slabs of p and
n, at any other p >= 1 and n >= 1 (a Mamba2 state of 128, as every
published Mamba2 checkpoint has), or raise: there is no fallback on the
card.  No width is a limit.  Inside the general forward, n routes by width:
up to `RESIDENT_N` (1024) a block keeps its rows of the state in shared
memory and writes h_final once; a wider state walks those rows in h_final
itself, the same kernel with the rows in device memory.  The general
backward keeps a head group's dB and dC partials in registers up to n 128
and, wider, adds 128-column chunks of them into its scratch.
`ssd_scan.launches` and
`ssd_scan_backward.launches` count calls that launched the kernels
(plain integers), and `_build.launches` each C entry point's launches
(`ssd_fwd_any` / `ssd_bwd_any` those that went to the general units).

x, B and C are read in place, in their own dtype (f32 or bf16) and through
their strides, as long as the last axis has a unit stride: on the model's
path they are views of the conv output.  Both take 64-token chunks.  The
kernels mask a ragged tail, where the plain forward, as JAX's does, takes
the whole sequence as one chunk; the scan's result does not depend on the
chunking beyond rounding (held at 2e-4 abs / 1e-3 rel against the plain
version).

Under grad (grad mode on and an input requiring a gradient) a CUDA call
goes through a `torch.autograd.Function`: the forward launches the serving
kernels and saves its inputs, and the backward launches `ssd_bwd` with the
output gradients (dh_final None when h_final takes no part in the loss).
dx, dB and dC come back in x's dtype, each rounded once from f32.  On the
CPU `ssd_ref` is differentiable itself."""
from __future__ import annotations

import functools

import torch

from .. import _build
from .ref import ssd_bwd_ref, ssd_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMALL = 64             # p and n up to which ssd.cu / ssd_bwd.cu run
RESIDENT_N = 1024      # n up to which ssd_any.cu keeps h in shared memory
TILE = 64              # tokens of a tile (the C B^T scratch is per tile)


def general(p: int, n: int) -> bool:
    """Whether (p, n) takes the general units, ssd_any.cu / ssd_bwd_any.cu."""
    return p > SMALL or n > SMALL


def head_group(b: int, s: int, h: int) -> int:
    """Heads a block of the backward's tile kernels walks: enough that the
    grid keeps about 256 blocks (two an SM on the H100's 132), at most 8.
    B and C are shared by the heads, so C B^T and the dB / dC products over
    dCB run once a group, and the group's dB and dC partials go out once."""
    nt = -(-s // TILE)
    return max(1, min(8, h, nt * h * b // 256))


@functools.lru_cache(maxsize=None)
def any_head_group(b: int, s: int, h: int, sms: int) -> int:
    """Heads a block of the general backward's tile kernel
    (`csrc/ssd_bwd_any.cu`) walks.  Its blocks take an SM each (their
    shared memory), so the group trades waves of (tiles x groups x b)
    blocks over `sms` against heads a block: the group of least waves x
    (group + 1), the block's own C B^T and dCB products counted as one
    head; the smallest on a tie, at most 64.  zamba2-2.7b's (4, 512, 80) on
    an H100's 132 SMs: 20 heads, 128 blocks in one wave."""
    nt = -(-s // TILE)
    return min(range(1, min(h, 64) + 1),
               key=lambda g: -(-nt * -(-h // g) * b // sms) * (g + 1))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, x, dt, A, B_, C_):
    """Shapes, and on the card devices, dtypes and strides, of the scan's
    inputs; True when every input lies on the CPU (the plain version)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B_.shape) != (b, s, n) or C_.shape != B_.shape):
        raise ValueError(f"{name}: incompatible shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(B_.shape)} C{tuple(C_.shape)}")
    ts = (x, dt, A, B_, C_)
    if all(t.device.type == "cpu" for t in ts):
        return True
    if not x.is_cuda or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: inputs must share one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if (x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise TypeError(f"{name}: x, B, C float32 or bfloat16 (one dtype) "
                        f"and dt, A float32 required (got "
                        f"{[str(t.dtype) for t in ts]})")
    if x.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1:
        raise ValueError(f"{name}: x, B and C need a unit stride on their "
                         f"last axis")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError(f"{name}: dt and A must be contiguous")
    return False


def _strides(x, B_, C_):
    xs, bs, cs = x.stride(), B_.stride(), C_.stride()
    return (xs[0], xs[1], xs[2], bs[0], bs[1], cs[0], cs[1])


def _forward(x, dt, A, B_, C_):
    """Launch the scan's kernels on checked CUDA inputs."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    cb = torch.empty((b, -(-s // TILE), TILE, TILE), dtype=torch.float32,
                     device=dev)
    entry = "ssd_fwd_any" if general(p, n) else "ssd_fwd"
    _build.launch(entry, x.get_device(), x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), B_.data_ptr(), C_.data_ptr(), cb.data_ptr(),
                  y.data_ptr(), h_fin.data_ptr(), _DTYPES[x.dtype], b, s, h,
                  p, n, *_strides(x, B_, C_))
    ssd_scan.launches += 1
    return y, h_fin


class _SSDScan(torch.autograd.Function):
    """The CUDA scan, and its backward kernels."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C_)
        return _forward(x, dt, A, B_, C_)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh):
        x, dt, A, B_, C_ = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return ssd_scan_backward(x, dt, A, B_, C_, dy.contiguous(),
                                 None if dh is None else dh.contiguous())


def ssd_scan(x, dt, A, B_, C_):
    """Mamba2 SSD scan.  x: (b,s,h,p); dt: (b,s,h) softplus'd; A: (h,)
    negative; B_, C_: (b,s,n) shared across heads.  Returns (y (b,s,h,p),
    h_final (b,h,p,n)), both f32."""
    if _check("ssd_scan", x, dt, A, B_, C_):
        return ssd_ref(x, dt, A, B_, C_)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B_, C_)):
        return _SSDScan.apply(x, dt, A, B_, C_)
    return _forward(x, dt, A, B_, C_)


def ssd_scan_backward(x, dt, A, B_, C_, dy, dh_final=None):
    """The VJP of `ssd_scan(x, dt, A, B_, C_)` for the output gradients dy
    (b,s,h,p) and dh_final (b,h,p,n, or None for 0): (dx in x's shape and
    dtype, ddt (b,s,h) f32, dA (h,) f32 summed over b and s, dB and dC in
    B_'s shape and dtype, summed over the heads)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if tuple(dy.shape) != (b, s, h, p) or (
            dh_final is not None and tuple(dh_final.shape) != (b, h, p, n)):
        raise ValueError(f"ssd_scan_backward: dy{tuple(dy.shape)} or "
                         f"dh_final do not fit x{tuple(x.shape)}, n {n}")
    outs = (dy,) if dh_final is None else (dy, dh_final)
    on_cpu = _check("ssd_scan_backward", x, dt, A, B_, C_)
    if on_cpu != all(t.device.type == "cpu" for t in outs):
        raise ValueError("ssd_scan_backward: dy and dh_final must lie on "
                         "the inputs' device")
    if on_cpu:
        dx, ddt, dA, dB, dC = ssd_bwd_ref(x, dt, A, B_, C_, dy, dh_final)
        return dx.to(x.dtype), ddt, dA, dB.to(B_.dtype), dC.to(C_.dtype)
    if any(t.device != x.device or t.dtype != torch.float32
           or not t.is_contiguous() for t in outs):
        raise ValueError("ssd_scan_backward: dy and dh_final must be "
                         "contiguous float32 tensors on x's device")
    dev, nt = x.device, -(-s // TILE)
    entry = "ssd_bwd_any" if general(p, n) else "ssd_bwd"
    group = (any_head_group(b, s, h, _sms(x.get_device()))
             if entry == "ssd_bwd_any" else head_group(b, s, h))
    groups = -(-h // group)
    f32 = dict(dtype=torch.float32, device=dev)
    hst = torch.empty((b, nt - 1, h, p, n), **f32)
    gst = torch.empty((b, nt - 1, h, p, n), **f32)
    # ssd_bwd's exp(cs_last) of each (b, tile, head); the general unit's
    # tile scans (dt, cs, exp(cs) and w of each tile) in its place
    decay = torch.empty((4, b, nt, h, TILE) if entry == "ssd_bwd_any"
                        else (b, nt, h), **f32)
    dbp = torch.empty((b, s, groups, n), **f32)
    dcp = torch.empty((b, s, groups, n), **f32)
    dapart = torch.empty((b, nt, h), **f32)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, n), dtype=B_.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=C_.dtype, device=dev)
    _build.launch(entry, x.get_device(), x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), B_.data_ptr(), C_.data_ptr(), dy.data_ptr(),
                  None if dh_final is None else dh_final.data_ptr(),
                  hst.data_ptr(), gst.data_ptr(), decay.data_ptr(),
                  dx.data_ptr(), ddt.data_ptr(), dbp.data_ptr(),
                  dcp.data_ptr(), dapart.data_ptr(), dB.data_ptr(),
                  dC.data_ptr(), dA.data_ptr(), _DTYPES[x.dtype], b, s, h, p,
                  n, group, *_strides(x, B_, C_))
    ssd_scan_backward.launches += 1
    return dx, ddt, dA, dB, dC


ssd_scan.launches = 0
ssd_scan_backward.launches = 0
