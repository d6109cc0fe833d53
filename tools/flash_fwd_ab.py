#!/usr/bin/env python3
"""A serving forward kernel (flash attention or the SSD scan) built from
several source trees, compared on one CUDA card.

    python3 tools/flash_fwd_ab.py [--kernel flash|ssd] --src build/parent/src --src src [--src build/parent/src]

Builds the kernel's source (`flash_attention/csrc/flash_attention.cu` or
`ssd/csrc/ssd.cu` under `repro_torch/kernels`) of each tree (one nvcc per
tree, all started together, into `build/flash_fwd_ab/`), then prints,
against the first tree:

- ptxas registers and spill bytes of every instantiation (`flash_fwd`, or
  `ssd_cb_kernel` and `ssd_scan_kernel`), and those where they differ;
- for flash, the SASS of the main paths' instantiations (f32 D 72 and bf16
  D 80, 16-byte staging) with constant-bank offsets masked: the count of
  differing instructions;
- at the kernel's serving shapes (flash: DiT-XL f32 and bf16, B 8, S 256,
  H 16, D 72; zamba2 prefill bf16, B 4, S 512, H 32, D 80, causal.  ssd:
  chip_smoke's ssd phase, zamba2 prefill b 4, s 512, h 80, p = n = 64 in
  f32 and on bf16 views of the conv output, b 1 on bf16 views, a ragged
  s = 500 in f32), whether the outputs are bitwise equal, and the device ms
  per call: CUDA events around a CUDA graph of `reps` back-to-back calls,
  each tree in order and then in reverse, three rounds; a tree given twice
  shows the spread of one build.

Prints the card's name and power limit.  `--src` takes a tree's `src`
directory: unpack an older commit with `git archive <commit> | tar -x -C
build/parent`.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_fwd_ab"
P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def flash_case(torch, gen, B, S, H, D, causal, dt):
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    o = torch.empty_like(q)
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             int(dt == "bfloat16"), B, S, S, H, H, D, causal, 0,
             1.0 / math.sqrt(D)), (o,), (q, k, v))


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


KERNELS = {
    "flash": {
        "cu": "flash_attention/csrc/flash_attention.cu",
        "entry": "flash_attention_fwd", "argtypes": [P] * 4 + [I] * 9 + [F],
        "instantiation": r"flash_fwdI\w+?Lb\dE",
        "sass": ("flash_fwdIfLi72ELb1E", "flash_fwdI13__nv_bfloat16Li80ELb1E"),
        "case": flash_case, "seed": 0,
        "shapes": [  # name, B, S, H, D, causal, dtype
            ("dit-xl f32", 8, 256, 16, 72, 0, "float32"),
            ("dit-xl bf16", 8, 256, 16, 72, 0, "bfloat16"),
            ("zamba2 prefill bf16", 4, 512, 32, 80, 1, "bfloat16"),
        ]},
    "ssd": {
        "cu": "ssd/csrc/ssd.cu",
        "entry": "ssd_fwd", "argtypes": [P] * 8 + [I] * 6 + [L] * 7,
        "instantiation": r"ssd_(?:cb|scan)_kernel\w+?Lb\dE",
        "sass": (), "case": ssd_case, "seed": 2,
        "shapes": [  # name, b, s, h, p, n, bf16 views of one conv output
            ("zamba2 prefill f32", 4, 512, 80, 64, 64, False),
            ("zamba2 prefill bf16 xBC views", 4, 512, 80, 64, 64, True),
            ("b1 bf16 xBC views", 1, 512, 80, 64, 64, True),
            ("ragged 500 f32", 1, 500, 80, 64, 64, False),
        ]},
}


def build(kernel, srcs, nvcc, flags):
    """{label: (library path, {instantiation: (registers, spill bytes)})}"""
    procs = {}
    for i, src in enumerate(srcs):
        d = OUT / f"src{i}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copytree(Path(src) / "repro_torch" / "kernels", d / "kernels",
                        dirs_exist_ok=True)
        inc = [f if not f.startswith("-I") else f"-I{d / 'kernels'}"
               for f in flags]
        procs[f"src{i}"] = (d / "lib.so", subprocess.Popen(
            [nvcc, *inc, "-shared", str(d / "kernels" / kernel["cu"]), "-o",
             str(d / "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            sys.exit(f"flash_fwd_ab: nvcc failed for {label}:\n{log}")
        regs = {m.group(1): (int(m.group(3)), int(m.group(2))) for m in re.finditer(
            rf"Function properties for \w*?({kernel['instantiation']})\w*\n"
            r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers", log)}
        out[label] = (lib, regs)
    return out


def sass(lib: Path, tag: str):
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
    hits = [v for k, v in blocks.items() if tag in k]
    return hits[0] if hits else None


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
    from repro_torch.kernels import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    built = build(kernel, args.src, _build._nvcc(), _build.FLAGS)
    labels = list(built)
    ref_lib, ref_regs = built[labels[0]]
    for label in labels:
        lib, regs = built[label]
        diff = {k: (ref_regs.get(k), v) for k, v in regs.items()
                if ref_regs.get(k) != v}
        print(f"{label} ({args.src[labels.index(label)]}): registers/spill "
              f"{regs}; differing from src0: {diff}", flush=True)
        for tag in kernel["sass"]:
            a, b = sass(ref_lib, tag), sass(lib, tag)
            same = None if a is None or b is None else (
                sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))
            print(f"{label} {tag}: registers/spill {regs.get(tag)}; SASS "
                  f"instructions {None if b is None else len(b)}, differing "
                  f"from src0 (offsets masked) {same}", flush=True)
    fns = {}
    for label in labels:
        fn = getattr(ctypes.CDLL(str(built[label][0])), kernel["entry"])
        fn.argtypes, fn.restype = kernel["argtypes"] + [P], I
        fns[label] = fn
    gen = torch.Generator(device="cuda").manual_seed(kernel["seed"])
    for name, *shape in kernel["shapes"]:
        call_args, outs_of, _keep = kernel["case"](torch, gen, *shape)

        def run(label):
            err = fns[label](*call_args,
                             torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"flash_fwd_ab: CUDA error {err}")

        outs = {}
        for label in labels:
            run(label)
            torch.cuda.synchronize()
            outs[label] = [t.clone() for t in outs_of]
        equal = all(torch.equal(a, b) for x in labels
                    for a, b in zip(outs[labels[0]], outs[x]))

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

        times = {x: [] for x in labels}
        for _ in range(3):
            for turn in (labels, labels[::-1]):
                for label in turn:
                    times[label].append(time_ms(label))
        print(f"{name}: outputs bitwise equal {equal}; " + "; ".join(
            f"{x} mean {sum(t) / len(t):.5f} ms (min {min(t):.5f}, max "
            f"{max(t):.5f})" for x, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
