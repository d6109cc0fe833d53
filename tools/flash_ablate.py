#!/usr/bin/env python3
"""Where the flash or SSD kernel's time goes, on one CUDA card.

    python3 tools/flash_ablate.py [--kernel flash|ssd] [--reps N] [NAME=FLAGS ...]

Builds a copy of the kernel's source (flash:
`src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`, ssd:
`src/repro_torch/kernels/ssd/csrc/ssd.cu`; into `build/flash_ablate/`)
with switches that each skip one part of the work, once per variant:
NAME=FLAGS names the variant and gives its nvcc defines, joined by commas,
e.g. `noqk=-DABL_NO_QK`.  The flash switches:

  ABL_EMPTY     return at once: the launch alone
  ABL_NO_LOOP   no key tiles: Q and the first K/V tile in, O out
  ABL_NO_LOADS  no K/V copies after the first tile
  ABL_NO_QK     skip S = Q K^T
  ABL_NO_PV     skip O += P V

The SSD switches (in the scan kernel; the C B^T pass always runs):

  ABL_EMPTY     the scan returns at once: the C B^T pass and two launches
  ABL_NO_LOADS  no copies of x, B, C, dt after the first tile
  ABL_NO_SX     skip S and S x
  ABL_NO_CH     skip C h^T
  ABL_NO_STATE  skip the state product x^T (w B)
  ABL_NO_YOUT   skip the stores of y

A switch skips its part behind a test the compiler cannot fold, so code
and registers stay those of the kernel; its results are wrong (FAIL).  The
variant `base` (no switch) is always built: it is the kernel itself.  One
nvcc per variant, all started together.  At the main paths' shapes
(flash: DiT-XL f32 and bf16, zamba2-2.7b prefill bf16; ssd: the zamba2
prefill scan with bf16 views of the conv output as the path passes them,
with f32 inputs, and at b 1) every variant is held against the plain
version (flash 1e-4 abs f32, 2e-2 abs bf16; ssd 2e-4 abs + 1e-3 rel) and
timed on the device: CUDA events around a CUDA graph of `reps`
back-to-back calls, every variant in order and then in reverse, the mean
of the two turns reported.  For flash, `scaled_dot_product_attention`
(with the boolean mask chip_smoke.py gives it, and with `is_causal` where
it applies) is timed the same way.  Prints the card, ptxas registers and
spills of the main-path instantiations per variant, a line per shape and
variant, and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
OUT = ROOT / "build" / "flash_ablate"
SHAPES = [  # name, B, Sq, Sk, H, KH, D, causal, dtype
    ("dit-xl f32", 8, 256, 256, 16, 16, 72, False, "float32"),
    ("dit-xl bf16", 8, 256, 256, 16, 16, 72, False, "bfloat16"),
    ("zamba2 prefill", 4, 512, 512, 32, 32, 80, True, "bfloat16"),
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MAIN = {"f32 D72": "flash_fwdIfLi72ELb1E",
        "bf16 D80": "flash_fwdI13__nv_bfloat16Li80ELb1E"}
FLASH_ABLATIONS = [  # switch, anchor in the source, what goes before it
    ("ABL_EMPTY", "  const int q0 = blockIdx.x * kBQ;\n",
     "  if (scale_log2 != 12345.f) return;\n"),
    ("ABL_NO_LOOP", "  for (int kt = kt_lo; kt < kt_hi; ++kt) {\n",
     "  if (scale_log2 != 12345.f) kt_hi = kt_lo;\n"),
    ("ABL_NO_LOADS", "    stage_kv(kt + kStages - 1);\n",
     "    if (scale_log2 != 12345.f) cp_async_commit(); else\n"),
    ("ABL_NO_QK", "      if constexpr (kBf16) {\n        // ldmatrix x4: keys 16 jp",
     "      if (scale_log2 != 12345.f) {} else\n"),
    ("ABL_NO_PV", "      if constexpr (kBf16) {\n        // ldmatrix.trans x4",
     "      if (scale_log2 != 12345.f) {} else\n"),
]
# a = A[head] < 0 in the scan kernel: a test the compiler cannot fold
SSD_ABLATIONS = [
    ("ABL_EMPTY", "  const int grp = blockIdx.x",
     "  if (A[0] != 12345.f) return;\n"),
    ("ABL_NO_LOADS", "    if (tile + 1 < nt) stage(tile + 1, st ^ 1);\n",
     "    if (a != 12345.f) { cp_async_commit(); cp_async_commit(); } else\n"),
    ("ABL_NO_SX", "      if (kk > 2 * warp + 1) break;\n",
     "      if (a != 12345.f) break;\n"),
    ("ABL_NO_CH", "    if (tile > 0) {\n", "    if (a != 12345.f) {} else\n"),
    ("ABL_NO_STATE", "      const float w0 = w_w[j0], w1 = w_w[j1];\n",
     "      if (a != 12345.f) break;\n"),
    ("ABL_NO_YOUT", "        if (s >= S) continue;\n",
     "        if (a != 12345.f) continue;\n"),
]
KERNELS = {
    "flash": {"cu": SRC / "repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "ablations": FLASH_ABLATIONS, "main": MAIN},
    "ssd": {"cu": SRC / "repro_torch/kernels/ssd/csrc/ssd.cu",
            "ablations": SSD_ABLATIONS,
            "main": {"bf16 scan": "ssd_scan_kernelI13__nv_bfloat16Lb1E",
                     "f32 scan": "ssd_scan_kernelIfLb1E"}},
}
SSD_SHAPES = [  # name, b, s, h, p, n, bf16 views of xBC
    ("zamba2 prefill bf16 xBC views", 4, 512, 80, 64, 64, True),
    ("zamba2 prefill f32", 4, 512, 80, 64, 64, False),
    ("b1 bf16 xBC views", 1, 512, 80, 64, 64, True),
]


def ablation_source(kernel) -> Path:
    """A copy of the kernel with its ablation switches put in."""
    cu = KERNELS[kernel]["cu"]
    text = cu.read_text()
    for switch, anchor, skip in KERNELS[kernel]["ablations"]:
        if text.count(anchor) != 1:
            sys.exit(f"flash_ablate: anchor of {switch} not found once in {cu}")
        text = text.replace(anchor, f"#ifdef {switch}\n{skip}#endif\n{anchor}")
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"ablate_{kernel}.cu"
    out.write_text(text)
    return out


def build(kernel, variants, nvcc, flags):
    """One shared library per variant; returns the loaded libraries and
    the ptxas report of the main-path instantiations."""
    source = ablation_source(kernel)
    procs = {}
    for name, defs in variants:
        d = OUT / kernel / name
        d.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, *defs, "-shared", str(source), "-o",
             str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            sys.exit(f"flash_ablate: nvcc failed for {name}:\n{log}")
        ptxas[name] = {}
        for tag, mangled in KERNELS[kernel]["main"].items():
            m = re.search(re.escape(mangled) + r".*?\n.*?(\d+) bytes spill stores"
                          r".*?\n.*?Used (\d+) registers", log)
            ptxas[name][tag] = (f"{m.group(2)} registers, {m.group(1)} B spilled"
                                if m else "?")
        lib = ctypes.CDLL(str(OUT / kernel / name / "lib.so"))
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        if kernel == "flash":
            lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, I,
                                                I, I, F, P]
            lib.flash_attention_fwd.restype = I
        else:
            lib.ssd_fwd.argtypes = [P] * 8 + [I] * 6 + [L] * 7 + [P]
            lib.ssd_fwd.restype = I
        libs[name] = lib
    return libs, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="flash")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_ablate: no CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref
    variants = [("base", [])] + [
        (v.split("=", 1)[0], [f for f in v.split("=", 1)[1].split(",") if f])
        for v in args.variants]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs, ptxas = build(args.kernel, variants, _build._nvcc(), _build.FLAGS)
    for name, defs in variants:
        print(f"variant {name} {' '.join(defs)}: {ptxas[name]}", flush=True)

    def time_ms(fn):
        """Device milliseconds per call: `reps` calls captured in one CUDA
        graph and replayed, so that host time between launches is left
        out."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def timed(shape, run, error, ok):
        """Check and time every variant: in order, then in reverse."""
        errs, times = {}, {name: [] for name, _ in variants}
        for name, _ in variants:
            run(libs[name])
            torch.cuda.synchronize()
            errs[name] = error()
        order = [name for name, _ in variants]
        for turn in (order, order[::-1]):
            for name in turn:
                times[name].append(time_ms(lambda: run(libs[name])))
        for name, _ in variants:
            ms = sum(times[name]) / 2
            good = ok(errs[name])
            print(f"{shape}: {name} ms={ms:.4f} (turns "
                  f"{times[name][0]:.4f} {times[name][1]:.4f}) err="
                  f"{errs[name]:.3e} {'ok' if good else 'FAIL'}", flush=True)
            rows.append({"shape": shape, "variant": name, "ms": ms,
                         "err": errs[name], "ok": good})

    if args.kernel == "ssd":
        from repro_torch.kernels.ssd import ssd_chunked
        for shape, b, s, h, p, n, xbc in SSD_SHAPES:
            dt = torch.nn.functional.softplus(
                torch.randn((b, s, h), generator=gen, device="cuda"))
            A = -torch.exp(torch.rand((h,), generator=gen, device="cuda"))
            buf = torch.randn((b, s, h * p + 2 * n), generator=gen,
                              device="cuda")
            buf = buf.to(torch.bfloat16) if xbc else buf
            x = buf[..., :h * p].view(b, s, h, p)
            B_, C_ = buf[..., h * p:h * p + n], buf[..., h * p + n:]
            yr, hr = ssd_chunked(x, dt, A, B_, C_, 64)
            y = torch.empty((b, s, h, p), device="cuda")
            hf = torch.empty((b, h, p, n), device="cuda")
            cb = torch.empty((b, -(-s // 64), 64, 64), device="cuda")

            def run(lib):
                err = lib.ssd_fwd(
                    x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                    C_.data_ptr(), cb.data_ptr(), y.data_ptr(), hf.data_ptr(),
                    1 if xbc else 0, b, s, h, p, n, *x.stride()[:3],
                    *B_.stride()[:2], *C_.stride()[:2],
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"flash_ablate: CUDA error {err}")

            def excess():   # > 0 where |out - ref| > 2e-4 + 1e-3 |ref|
                return max(float(((o - r).abs() - 1e-3 * r.abs()).max())
                           for o, r in ((y, yr), (hf, hr)))

            timed(shape, run, excess, lambda e: e <= 2e-4)
        print(json.dumps({"card": card, "kernel": "ssd", "ptxas": ptxas,
                          "rows": rows}))
        return 0 if all(r["ok"] for r in rows if r["variant"] == "base") else 1

    for shape, B, Sq, Sk, H, KH, D, causal, dt in SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device="cuda")
                   .to(dtype) for S, h in ((Sq, H), (Sk, KH), (Sk, KH)))
        o = torch.empty_like(q)
        ref = attention_ref(q, k, v, causal=causal)

        def run(lib):
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                0 if dt == "float32" else 1, B, Sq, Sk, H, KH, D, int(causal),
                0, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"flash_ablate: CUDA error {err}")

        timed(shape, run, lambda: float((o.float() - ref.float()).abs().max()),
              lambda e: e <= TOL[dt])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if causal:
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda").tril(
                Sk - Sq)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        sdpa_causal = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)) if causal and Sq == Sk else None
        print(f"{shape}: sdpa (mask) ms={sdpa:.4f}"
              + (f", sdpa is_causal ms={sdpa_causal:.4f}" if sdpa_causal
                 else ""), flush=True)
        rows.append({"shape": shape, "variant": "sdpa", "ms": sdpa,
                     "sdpa_is_causal_ms": sdpa_causal})
    print(json.dumps({"card": card, "ptxas": ptxas, "rows": rows}))
    base_ok = all(r["ok"] for r in rows if r.get("variant") == "base")
    return 0 if base_ok else 1


if __name__ == "__main__":
    sys.exit(main())
