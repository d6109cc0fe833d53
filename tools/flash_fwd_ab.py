#!/usr/bin/env python3
"""A kernel of the port (the flash forward, the SSD scan, either backward,
or the forecast kernel) built from several source trees, compared on one
CUDA card.

    python3 tools/flash_fwd_ab.py [--kernel flash|flash-lse|flash-any|ssd|ssd-any|flash-bwd|ssd-bwd|ssd-bwd-any|forecast] --src build/parent/src --src src [--src src --src build/parent/src]

Builds the kernel's sources of each tree (under `repro_torch/kernels`:
`flash_attention/csrc/flash_attention.cu`, the training forward's
`flash_attention/csrc/flash_attention_lse.cu`, the general forward's
`flash_attention/csrc/flash_attention_any.cu`, `ssd/csrc/ssd.cu`, the
general scan's `ssd/csrc/ssd_any.cu`,
`flash_attention/csrc/flash_attention_bwd*.cu`, `ssd/csrc/ssd_bwd.cu`, the
general scan backward's `ssd/csrc/ssd_bwd_any.cu` or
`forecast/csrc/forecast.cu`;
one nvcc per source of every tree, all started together, into
`build/flash_fwd_ab/`, each printed when it ends),
then prints, against the first tree:

- ptxas registers, spill bytes and static shared bytes of every
  instantiation (`flash_fwd`; `flash_fwd_any`; `ssd_cb_kernel` and
  `ssd_scan_kernel`; `ssd_cb_any` and `ssd_scan_any`;
  `flash_bwd_*`; `ssd_bwd_*`, with `ssd_bwd_*_any` for the general unit),
  and those where they differ (the backward and the general SSD kernels'
  shared memory is dynamic: their source notes give its bytes);
- the SASS of every instantiation the first tree has, with constant-bank
  offsets masked: those whose instructions differ, with the count, and
  the instantiations only a later tree has;
- at the kernel's shapes (flash: DiT-XL f32 and bf16, B 8, S 256, H 16,
  D 72; zamba2 prefill bf16, B 4, S 512, H 32, D 80, causal; the dense
  prefills of tinyllama (32 / 4 heads of 64), qwen2-7b (28 / 4 of 128)
  and arctic-480b (56 / 8 of 128), causal; whisper-small's encoder (B 4, S 1500, 12 heads of 64) and its
  cross-attention (448 queries over 1500 keys), bf16.  ssd:
  chip_smoke's ssd phase, zamba2 prefill b 4, s 512, h 80, p = n = 64 in
  f32 and on bf16 views of the conv output, b 1 on bf16 views, a ragged
  s = 500 in f32.  ssd-any and ssd-bwd-any: chip_smoke's ANY_SSD_CASES
  (zamba2-2.7b's Mamba2 layer at state 128 on bf16 xBC views and in f32,
  a ragged p 96 / n 160 / s 500 in f32 with dh_final), with each tree's
  largest error against the plain version in float64 (the forward: its
  largest absolute error and its worst excess over SSD_TOL's 1e-3
  relative, held to 2e-4; the backward as ssd-bwd).  flash-lse: the training forward (kLse) at DiT-XL's,
  zamba2's and tinyllama's training shapes.  flash-any: chip_smoke's
  ANY_FLASH_CASES (pixtral-12b f32 160, the MLA f32 192 over 128, the
  prompt encoder's 288, Gemma's 256 in bf16 and f32, odd 200 and a
  misaligned bf16 136), each serving and with the lse, with each tree's
  largest error of o against the plain version in float64 (and of the lse
  against its float64 reference).  flash-bwd and ssd-bwd:
  chip_smoke's flash-bwd and ssd-bwd phases' shapes, and for flash-bwd
  the general unit's at pixtral-12b's and the MLA's training shapes in
  f32 and at a misaligned bf16 D 136 (BWD_AB_EXTRA); a row the wrapper
  routes above head dim 128 calls that entry (`flash_attention_bwd_wide`
  or `flash_attention_bwd_any`), and a tree without it sits the row out.  forecast: the serving skip tick's 4 slots x 3
  x 4096 in f32 and bf16, the video pool's 2 x 3 x 65536, and an n that
  takes the element-by-element path), whether the outputs are bitwise
  equal across the trees, for flash-any and a backward also each tree's
  largest error against float64 (for a backward: autograd of the plain
  version (flash: max abs, or the
  excess over one bf16 rounding where chip_smoke gates so; ssd: the
  largest of each gradient's error over its largest value, and of its
  excess over one bf16 rounding for a bf16 gradient, held to
  SSD_BWD_TOL)), and the
  device ms per call:
  CUDA events around a CUDA graph of `reps` back-to-back calls, each tree
  in order and then in reverse, three rounds; a tree given twice shows the
  spread of one build.

Each tree's backward is called through that tree's own argument list (the
SSD backward's changed with its head groups; the general one's with its
tile scans and its own head groups, `ops.any_head_group`).  Prints the card's name and
power limit.  `--src` takes a tree's `src` directory: unpack an older
commit with `git archive <commit> | tar -x -C build/parent`.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_fwd_ab"
P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def flash_case(torch, gen, B, Sq, Sk, H, KH, D, causal, dt):
    dtype = getattr(torch, dt)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, KH, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    o = torch.empty_like(q)
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             int(dt == "bfloat16"), B, Sq, Sk, H, KH, D, causal, 0,
             1.0 / math.sqrt(D)), (o,), (q, k, v))


def flash_any_case(torch, gen, B, S, H, KH, D, Dv, causal, dt, offset,
                   with_lse):
    """flash_attention_fwd_any's arguments at one of ANY_FLASH_CASES (each
    input `offset` elements into its storage), serving or with the lse, and
    error(outs): the largest error of o against the plain version in
    float64 and, with the lse, of the lse against its float64 reference."""
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref)
    dtype = getattr(torch, dt)

    def rnd(shape):
        flat = torch.randn((math.prod(shape) + offset,), generator=gen,
                           device="cuda").to(dtype)
        return flat[offset:].view(shape)
    q, k, v = rnd((B, S, H, D)), rnd((B, S, KH, D)), rnd((B, S, KH, Dv))
    o = torch.empty((B, S, H, Dv), dtype=dtype, device="cuda")
    lse = torch.empty((B, H, S), device="cuda") if with_lse else None
    ref = attention_ref(*(t.double() for t in (q, k, v)), causal=causal)
    lse_ref = attention_lse_ref(q.double(), k.double(), causal=causal) \
        if with_lse else None

    def error(outs):
        err = float((outs[0].double() - ref).abs().max())
        if with_lse:
            return err, float((outs[1].double() - lse_ref).abs().max())
        return err
    args = (*_ptrs((q, k, v, o, lse)), int(dt == "bfloat16"), B, S, S, H,
            KH, D, Dv, int(causal), 0, 1.0 / math.sqrt(D))
    return args, (o,) if lse is None else (o, lse), (q, k, v), error


def any_flash_shapes():
    """chip_smoke's ANY_FLASH_CASES, each serving and with the lse."""
    from chip_smoke import ANY_FLASH_CASES
    return [(f"{name}{', lse' if lse else ''}", *shape, lse)
            for name, *shape in ANY_FLASH_CASES for lse in (False, True)]


def ssd_case(torch, gen, b, s, h, p, n, xbc):
    from chip_smoke import ssd_inputs
    x, dt, A, B_, C_ = ins = ssd_inputs(torch, gen, b, s, h, p, n, xbc)
    y = torch.empty((b, s, h, p), device="cuda")
    hf = torch.empty((b, h, p, n), device="cuda")
    cb = torch.empty((b, -(-s // 64), 64, 64), device="cuda")
    return ((x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
             C_.data_ptr(), cb.data_ptr(), y.data_ptr(), hf.data_ptr(),
             int(xbc), b, s, h, p, n, *x.stride()[:3], *B_.stride()[:2],
             *C_.stride()[:2]), (y, hf), (*ins, cb))


def ssd_any_case(torch, gen, b, s, h, p, n, xbc, dh):
    """ssd_fwd_any's arguments at one of ANY_SSD_CASES (dh_final plays no
    part in the forward), and error(outs): the largest absolute error of y
    and h_final against the plain version in float64 at the longest chunk
    of at most 64 dividing s, and the worst excess over SSD_TOL's relative
    part (within SSD_TOL's 2e-4 where it passes)."""
    from chip_smoke import SSD_TOL
    from repro_torch.kernels.ssd import ssd_chunked
    args, outs, keep = ssd_case(torch, gen, b, s, h, p, n, xbc)
    chunk = max(c for c in range(1, 65) if s % c == 0)
    ref = ssd_chunked(*(t.double() for t in keep[:5]), chunk)

    def error(got):
        return (max(float((a.double() - r).abs().max())
                    for a, r in zip(got, ref)),
                max(float(((a.double() - r).abs()
                           - SSD_TOL["rtol"] * r.abs()).max())
                    for a, r in zip(got, ref)))
    return args, outs, keep, error


def _fmt(err) -> str:
    """An error, or a tuple of them (o and the lse), as %.3e."""
    if isinstance(err, tuple):
        return "(" + ", ".join(f"{e:.3e}" for e in err) + ")"
    return f"{err:.3e}"


def _ptrs(ts):
    return tuple(0 if t is None else t.data_ptr() for t in ts)


def flash_bwd_case(torch, gen, name, B, Sq, Sk, H, KH, D, Dv, causal,
                   window, dt, offset=0):
    """q, k, v, o, dO, lse from the forward of the checkout (each input
    `offset` elements into its storage), and the float64 gradients;
    call(variant) -> (args, outputs, buffers), with `call.entry` the C
    entry point that takes the row where the wrapper routes it elsewhere
    than flash_attention_bwd."""
    from chip_smoke import BWD_ROUNDED, route_entry
    from repro_torch.kernels.flash_attention import attention_ref, ops
    dtype = getattr(torch, dt)

    def rnd(shape):
        flat = torch.randn((math.prod(shape) + offset,), generator=gen,
                           device="cuda").to(dtype)
        return flat[offset:].view(shape)
    q, k, v, do = (rnd(sh) for sh in ((B, Sq, H, D), (B, Sk, KH, D),
                                      (B, Sk, KH, Dv), (B, Sq, H, Dv)))
    scale = 1.0 / math.sqrt(D)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    o = ops._forward(q, k, v, causal, window, scale, lse,
                     route_entry(ops, q, k, v, True))
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(attention_ref(q64, k64, v64, causal=causal,
                                            window=window),
                              (q64, k64, v64), do.double())
    rounded = name in BWD_ROUNDED or (dt == "bfloat16" and D > 128)
    entry = ops.route(dtype, D, Dv, ops.aligned16(D, Dv, (q, k, v)),
                      True).backward
    with_dv = entry != "flash_attention_bwd"   # the entries that take Dv

    def call(variant):
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        delta = torch.empty((B, H, Sq), device="cuda")
        dims = (D, Dv) if with_dv else (D,)
        return ((*_ptrs((q, k, v, o, do, lse, delta, *outs)),
                 int(dt == "bfloat16"), B, Sq, Sk, H, KH, *dims, int(causal),
                 int(window), scale), outs, (delta,))

    call.entry = entry if with_dv else None

    def error(outs):
        return max(float(((a.double() - r).abs()
                          - (2.0 ** -8 * r.abs() if rounded else 0)).max())
                   for a, r in zip(outs, ref))
    return call, error, (q, k, v, o, do, lse)


# flash-bwd rows beside chip_smoke's BWD_CASES: the general unit
# (flash_attention_bwd_any) at pixtral-12b's and the MLA's training shapes
# with f32 params, and bf16 rows one element off 16 bytes at D 136
BWD_AB_EXTRA = [  # name, B, Sq, Sk, H, KH, D, Dv, causal, window, dtype, offset
    ("pixtral train f32 (d 160)", 2, 1088, 1088, 32, 8, 160, 160, True, 0,
     "float32", 0),
    ("mla train f32 (192 over 128)", 4, 512, 512, 128, 128, 192, 128, True,
     0, "float32", 0),
    ("odd d136 bf16, offset 1", 2, 300, 300, 8, 2, 136, 136, True, 0,
     "bfloat16", 1),
]


def flash_lse_case(torch, gen, B, Sq, Sk, H, KH, D, causal, dt):
    args, outs, keep = flash_case(torch, gen, B, Sq, Sk, H, KH, D, causal,
                                  dt)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    return (*args[:4], lse.data_ptr(), *args[4:]), (*outs, lse), keep


def ssd_bwd_case(torch, gen, name, b, s, h, p, n, xbc, dh):
    from chip_smoke import SSD_GRADS, ssd_inputs
    from repro_torch.kernels.ssd import ssd_ref
    from repro_torch.kernels.ssd.ops import _sms, any_head_group, head_group
    ins = ssd_inputs(torch, gen, b, s, h, p, n, xbc)
    x, dt, A, B_, C_ = ins
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    dhf = torch.randn((b, h, p, n), generator=gen, device="cuda") \
        if dh else None
    i64 = [a.detach().double().requires_grad_() for a in ins]
    y64, h64 = ssd_ref(*i64)
    loss = (y64 * dy.double()).sum()
    if dh:
        loss = loss + (h64 * dhf.double()).sum()
    ref = torch.autograd.grad(loss, i64)
    nt = -(-s // 64)
    strides = (*x.stride()[:3], *B_.stride()[:2], *C_.stride()[:2])

    def call(variant):
        def f32(*shape):
            return torch.empty(shape, device="cuda")
        outs = (torch.empty((b, s, h, p), dtype=x.dtype, device="cuda"),
                f32(b, s, h), f32(h),
                torch.empty((b, s, n), dtype=B_.dtype, device="cuda"),
                torch.empty((b, s, n), dtype=C_.dtype, device="cuda"))
        dx, ddt, dA, dB, dC = outs
        if variant in ("groups", "any"):   # hst, gst, decay, dbp, dcp, dapart
            # the general unit's own head groups, and its tile scans
            # (4, b, tiles, h, 64) in place of exp(cs_last) (b, tiles, h)
            group = (any_head_group(b, s, h, _sms(0)) if variant == "any"
                     else head_group(b, s, h))
            groups = -(-h // group)
            scratch = (f32(b, nt - 1, h, p, n), f32(b, nt - 1, h, p, n),
                       f32(*((4, b, nt, h, 64) if variant == "any"
                             else (b, nt, h))), f32(b, s, groups, n),
                       f32(b, s, groups, n), f32(b, nt, h))
            args = (*_ptrs((x, dt, A, B_, C_, dy, dhf, *scratch[:3], dx,
                            ddt, *scratch[3:], dB, dC, dA)),
                    int(xbc), b, s, h, p, n, group, *strides)
        else:                        # hin, gout, dbh, dch, dapart
            scratch = (f32(b, nt, h, p, n), f32(b, nt, h, p, n),
                       f32(b, s, h, n), f32(b, s, h, n), f32(b, nt, h))
            args = (*_ptrs((x, dt, A, B_, C_, dy, dhf, *scratch[:2], dx,
                            ddt, *scratch[2:], dB, dC, dA)),
                    int(xbc), b, s, h, p, n, *strides)
        return args, outs, scratch

    def error(outs):
        # grads come back in (dx, ddt, dA, dB, dC) order, as SSD_GRADS: the
        # largest error over the largest |grad|, and the largest excess over
        # one bf16 rounding (2^-8 |ref|) of a bf16 gradient, likewise
        assert len(outs) == len(SSD_GRADS)
        rel, beyond = [], []
        for a, r in zip(outs, ref):
            big = max(float(r.abs().max()), 1e-30)
            e = (a.double() - r).abs()
            rel.append(float(e.max()) / big)
            if a.dtype == torch.bfloat16:
                e = e - 2.0 ** -8 * r.abs()
            beyond.append(float(e.max()) / big)
        return max(rel), max(beyond)
    return call, error, (*ins, dy, dhf)


def forecast_case(torch, gen, batch, m1, n, dt):
    dtype = getattr(torch, dt)
    d = torch.randn((batch, m1, n), generator=gen, device="cuda").to(dtype)
    c = torch.randn((batch, m1), generator=gen, device="cuda")
    o = torch.empty((batch, n), dtype=dtype, device="cuda")
    vec = int(n % (16 // d.element_size()) == 0)
    return ((d.data_ptr(), c.data_ptr(), o.data_ptr(),
             int(dt == "bfloat16"), batch, m1, n, vec), (o,), (d, c))


def ssd_bwd_variant(cu: Path) -> str:
    """The argument list of a tree's ssd_bwd: per head (the earlier SIMT
    kernels), with head groups (the tensor-core kernels), or with the
    general unit's tile scans and head groups (`any`, from the redesign
    of ssd_bwd_any.cu on)."""
    text = cu.read_text()
    if "int group" not in text:
        return "heads"
    return "any" if "ssd_bwd_scan_any" in text else "groups"


def ssd_bwd_argtypes(variant):
    return ([P] * 17 + [I] * 6 + [L] * 7 if variant == "heads"
            else [P] * 18 + [I] * 7 + [L] * 7)


KERNELS = {
    "flash": {
        "cu": "flash_attention/csrc/flash_attention.cu",
        "entry": "flash_attention_fwd", "argtypes": [P] * 4 + [I] * 9 + [F],
        "instantiation": r"flash_fwdI\w+?Lb\dE",
        "case": flash_case, "seed": 0,
        "shapes": [  # name, B, Sq, Sk, H, KH, D, causal, dtype
            ("dit-xl f32", 8, 256, 256, 16, 16, 72, 0, "float32"),
            ("dit-xl bf16", 8, 256, 256, 16, 16, 72, 0, "bfloat16"),
            ("zamba2 prefill bf16", 4, 512, 512, 32, 32, 80, 1, "bfloat16"),
            ("tinyllama prefill", 4, 512, 512, 32, 4, 64, 1, "bfloat16"),
            ("qwen2-7b prefill", 4, 512, 512, 28, 4, 128, 1, "bfloat16"),
            ("arctic prefill", 4, 512, 512, 56, 8, 128, 1, "bfloat16"),
            ("whisper encoder", 4, 1500, 1500, 12, 12, 64, 0, "bfloat16"),
            ("whisper cross", 4, 448, 1500, 12, 12, 64, 0, "bfloat16"),
        ]},
    "flash-lse": {
        "cu": "flash_attention/csrc/flash_attention_lse.cu",
        "entry": "flash_attention_fwd_lse",
        "argtypes": [P] * 5 + [I] * 9 + [F],
        "instantiation": r"flash_fwdI\w+?Lb\dE",
        "case": flash_lse_case, "seed": 0,
        "shapes": [  # name, B, Sq, Sk, H, KH, D, causal, dtype
            ("dit-xl train f32", 8, 256, 256, 16, 16, 72, 0, "float32"),
            ("dit-xl train bf16", 8, 256, 256, 16, 16, 72, 0, "bfloat16"),
            ("zamba2 train bf16", 8, 128, 128, 32, 32, 80, 1, "bfloat16"),
            ("tinyllama train", 8, 128, 128, 32, 4, 64, 1, "bfloat16"),
        ]},
    "flash-any": {
        "cu": "flash_attention/csrc/flash_attention_any.cu",
        "entry": "flash_attention_fwd_any",
        "argtypes": [P] * 5 + [I] * 10 + [F],
        "instantiation": r"flash_fwd_anyI\w+?Lb\dELb\dE",
        "case": flash_any_case, "seed": 19, "error": True,
        "shapes": any_flash_shapes},
    "ssd": {
        "cu": "ssd/csrc/ssd.cu",
        "entry": "ssd_fwd", "argtypes": [P] * 8 + [I] * 6 + [L] * 7,
        "instantiation": r"ssd_(?:cb|scan)_kernel\w+?Lb\dE",
        "case": ssd_case, "seed": 2,
        "shapes": [  # name, b, s, h, p, n, bf16 views of one conv output
            ("zamba2 prefill f32", 4, 512, 80, 64, 64, False),
            ("zamba2 prefill bf16 xBC views", 4, 512, 80, 64, 64, True),
            ("b1 bf16 xBC views", 1, 512, 80, 64, 64, True),
            ("ragged 500 f32", 1, 500, 80, 64, 64, False),
        ]},
    "ssd-any": {
        "cu": "ssd/csrc/ssd_any.cu",
        "entry": "ssd_fwd_any", "argtypes": [P] * 8 + [I] * 6 + [L] * 7,
        "instantiation": r"ssd_(?:cb|scan)_anyI\w+?E(?:Lb\dE)*",
        "case": ssd_any_case, "seed": 29, "error": True,
        "shapes": "ANY_SSD_CASES"},
    "flash-bwd": {
        "cu": "flash_attention/csrc/flash_attention_bwd*.cu",
        "entry": "flash_attention_bwd",
        "argtypes": lambda cu: [P] * 10 + [I] * 9 + [F],
        "instantiation": r"flash_bwd_\w+?E(?:E|Lb\dE)",
        "case": flash_bwd_case, "seed": 0, "backward": True,
        "alt_entries": {"flash_attention_bwd_wide": [P] * 10 + [I] * 10
                        + [F],
                        "flash_attention_bwd_any": [P] * 10 + [I] * 10
                        + [F]},
        "shapes": "BWD_CASES", "extra_shapes": BWD_AB_EXTRA},
    "ssd-bwd": {
        "cu": "ssd/csrc/ssd_bwd.cu",
        "entry": "ssd_bwd", "argtypes": lambda cu: ssd_bwd_argtypes(
            ssd_bwd_variant(cu)), "variant": ssd_bwd_variant,
        "instantiation": r"(?<=\d)ssd_bwd_[a-z]+_kernel\w*?E",
        "case": ssd_bwd_case, "seed": 3, "backward": True,
        "shapes": "SSD_BWD_CASES"},
    "ssd-bwd-any": {
        "cu": "ssd/csrc/ssd_bwd_any.cu",
        "entry": "ssd_bwd_any", "argtypes": lambda cu: ssd_bwd_argtypes(
            ssd_bwd_variant(cu)), "variant": ssd_bwd_variant,
        "instantiation": r"(?<=\d)ssd_bwd_[a-z]+_(?:any|kernel)\w*?E(?:Lb\dE)*",
        "case": ssd_bwd_case, "seed": 30, "backward": True,
        "shapes": "ANY_SSD_CASES"},
    "forecast": {
        "cu": "forecast/csrc/forecast.cu",
        "entry": "forecast_fwd", "argtypes": [P] * 3 + [I] * 3 + [L, I],
        "instantiation": r"forecast_kernelI\w+?Li\d+E",
        "case": forecast_case, "seed": 4,
        "shapes": [  # name, batch, m + 1, n, dtype
            ("serving 4 slots f32", 4, 3, 256 * 16, "float32"),
            ("serving 4 slots bf16", 4, 3, 256 * 16, "bfloat16"),
            ("dit-video pool", 2, 3, 4096 * 16, "float32"),
            ("element by element", 4, 3, 4097, "float32"),
        ]},
}


def build(kernel, srcs, nvcc, flags):
    """{label: (library path, the tree's first source, {instantiation:
    (registers, spill bytes, static shared bytes)})}.  One nvcc per
    source of every tree, all started together; prints when each ended."""
    jobs, t0 = [], time.monotonic()
    for i, src in enumerate(srcs):
        d = OUT / f"src{i}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copytree(Path(src) / "repro_torch" / "kernels", d / "kernels",
                        dirs_exist_ok=True)
        cus = sorted((d / "kernels").glob(kernel["cu"]))
        if not cus:
            sys.exit(f"flash_fwd_ab: no {kernel['cu']} under {src}")
        inc = [f if not f.startswith("-I") else f"-I{d / 'kernels'}"
               for f in flags]
        for cu in cus:
            jobs.append((f"src{i}", d, cu, subprocess.Popen(
                [nvcc, *inc, "-c", str(cu), "-o", str(d / (cu.stem + ".o"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def finish(job):
        return job[3].communicate()[0], time.monotonic() - t0
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(finish, jobs))
    logs = {}
    for (label, d, cu, p), (log, sec) in zip(jobs, done):
        print(f"{label}: nvcc {cu.name} ended at {sec:.1f} s", flush=True)
        if p.returncode != 0:
            sys.exit(f"flash_fwd_ab: nvcc failed for {label} {cu.name}:"
                     f"\n{log}")
        logs[label] = logs.get(label, "") + log
    out = {}
    for i in range(len(srcs)):
        label, d = f"src{i}", OUT / f"src{i}"
        cus = [cu for lab, _, cu, _ in jobs if lab == label]
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(d / "lib.so"),
             *(str(d / (cu.stem + ".o")) for cu in cus)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            sys.exit(f"flash_fwd_ab: linking failed for {label}:"
                     f"\n{link.stdout}")
        regs = {m.group(1): (int(m.group(3)), int(m.group(2)),
                             int(m.group(4) or 0)) for m in re.finditer(
            rf"Function properties for \w*?({kernel['instantiation']})\w*\n"
            r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers"
            r"(?:.*?, (\d+) bytes smem)?", logs[label])}
        out[label] = (d / "lib.so", cus[0], regs)
    return out


def sass_blocks(lib: Path):
    """{function name: its SASS instructions, constant-bank offsets
    masked}, or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    blocks, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            blocks[name] = []
        elif name and "*/" in line:
            ins = line.split("*/", 1)[1].split(";")[0].strip()
            if ins:
                blocks[name].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]",
                                           "c[param]", ins))
    return blocks


def n_differ(a, b) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def compare_all_sass(kernel, ref_lib, lib, label):
    """Every instantiation of the first tree against the same one of
    `lib` (names without the anonymous namespace, which differs by
    tree)."""
    a, b = sass_blocks(ref_lib), sass_blocks(lib)
    if a is None or b is None:
        print(f"{label}: SASS not compared (no cuobjdump)", flush=True)
        return

    def by_inst(blocks):
        out = {}
        for name, ins in blocks.items():
            m = re.search(kernel["instantiation"], name)
            if m:
                out[m.group(0)] = ins
        return out

    a, b = by_inst(a), by_inst(b)
    differ = {k: n_differ(v, b[k]) for k, v in a.items() if k in b
              and n_differ(v, b[k])}
    print(f"{label}: SASS of the {len(a)} instantiations of src0: "
          f"{sum(k in b for k in a)} also here, differing (offsets masked) "
          f"{differ}; missing here {[k for k in a if k not in b]}; only "
          f"here {[k for k in b if k not in a]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="flash")
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    kernel = KERNELS[args.kernel]
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_ab: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 references
    from repro_torch.kernels import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    built = build(kernel, args.src, _build._nvcc(), _build.FLAGS)
    labels = list(built)
    ref_lib, _, ref_regs = built[labels[0]]
    for label in labels:
        lib, _, regs = built[label]
        diff = {k: (ref_regs.get(k), v) for k, v in regs.items()
                if ref_regs.get(k) != v}
        print(f"{label} ({args.src[labels.index(label)]}): registers/spill/"
              f"static smem {regs}; differing from src0: {diff}", flush=True)
        compare_all_sass(kernel, ref_lib, lib, label)
    fns, variants, alt = {}, {}, {}
    for label in labels:
        lib, cu, _ = built[label]
        dll = ctypes.CDLL(str(lib))
        fn = getattr(dll, kernel["entry"])
        argtypes = kernel["argtypes"]
        fn.argtypes = (argtypes(cu) if callable(argtypes) else argtypes) + [P]
        fn.restype = I
        fns[label] = fn
        variants[label] = kernel.get("variant", lambda _: None)(cu)
        for entry, types in kernel.get("alt_entries", {}).items():
            if hasattr(dll, entry):        # an older tree may lack it
                f = getattr(dll, entry)
                f.argtypes, f.restype = types + [P], I
                alt[label, entry] = f
    backward = kernel.get("backward", False)
    shapes = kernel["shapes"]
    if callable(shapes):
        shapes = shapes()
    if isinstance(shapes, str):
        import chip_smoke
        shapes = getattr(chip_smoke, shapes) + kernel.get("extra_shapes", [])
    gen = torch.Generator(device="cuda").manual_seed(kernel["seed"])
    for name, *shape in shapes:
        entry, row = None, labels
        if backward:
            call, error, _keep = kernel["case"](torch, gen, name, *shape)
            entry = getattr(call, "entry", None)
            if entry:
                row = [x for x in labels if (x, entry) in alt]
                print(f"{name}: {entry}; trees without it sit the row out: "
                      f"{[x for x in labels if x not in row]}", flush=True)
            calls = {x: call(variants[x]) for x in row}
        else:
            call_args, outs_of, _keep, *error = kernel["case"](torch, gen,
                                                               *shape)
            error = error[0] if error else None
            calls = {x: (call_args, outs_of, ()) for x in labels}

        def run(label):
            fn = alt[label, entry] if entry else fns[label]
            err = fn(*calls[label][0],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"flash_fwd_ab: CUDA error {err}")

        outs = {}
        for label in row:
            run(label)
            torch.cuda.synchronize()
            outs[label] = [t.clone() for t in calls[label][1]]
        check = "outputs bitwise equal " + str(all(
            torch.equal(a, b) for x in row
            for a, b in zip(outs[row[0]], outs[x])))
        if backward or kernel.get("error"):
            check += "; error against float64 " + ", ".join(
                f"{x} {_fmt(error(outs[x]))}" for x in row)

        def time_ms(label):
            run(label)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(args.reps):
                    run(label)
            graph.replay()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / args.reps

        times = {x: [] for x in row}
        for _ in range(3):
            for turn in (row, row[::-1]):
                for label in turn:
                    times[label].append(time_ms(label))
        print(f"{name}: {check}; " + "; ".join(
            f"{x} mean {sum(t) / len(t):.5f} ms (min {min(t):.5f}, max "
            f"{max(t):.5f})" for x, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
