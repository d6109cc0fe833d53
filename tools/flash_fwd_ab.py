#!/usr/bin/env python3
"""The flash forward's serving entry point built from several source trees,
compared on one CUDA card.

    python3 tools/flash_fwd_ab.py --src build/parent/src --src src [--src build/parent/src]

Builds `repro_torch/kernels/flash_attention/csrc/flash_attention.cu` of
each tree (one nvcc per tree, all started together, into
`build/flash_fwd_ab/`), then prints, against the first tree:

- ptxas registers and spill bytes of every `flash_fwd` instantiation, and
  the instantiations where they differ;
- the SASS of the main paths' instantiations (f32 D 72 and bf16 D 80, 16-
  byte staging) with constant-bank offsets masked: the count of differing
  instructions;
- at the serving shapes (DiT-XL f32 and bf16: B 8, S 256, H 16, D 72;
  zamba2 prefill bf16: B 4, S 512, H 32, D 80, causal), whether the outputs
  are bitwise equal, and the device ms per call: CUDA events around a CUDA
  graph of `reps` back-to-back calls, each tree in order and then in
  reverse, three rounds; a tree given twice shows the spread of one build.

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
CU = "repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MAIN = ("flash_fwdIfLi72ELb1E", "flash_fwdI13__nv_bfloat16Li80ELb1E")
SHAPES = [  # name, B, S, H, D, causal, dtype
    ("dit-xl f32", 8, 256, 16, 72, 0, "float32"),
    ("dit-xl bf16", 8, 256, 16, 72, 0, "bfloat16"),
    ("zamba2 prefill bf16", 4, 512, 32, 80, 1, "bfloat16"),
]


def build(srcs, nvcc, flags):
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
            [nvcc, *inc, "-shared", str(d / "kernels" / Path(CU).relative_to(
                "repro_torch/kernels")), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            sys.exit(f"flash_fwd_ab: nvcc failed for {label}:\n{log}")
        regs = {m.group(1): (int(m.group(3)), int(m.group(2))) for m in re.finditer(
            r"Function properties for \w*?(flash_fwdI\w+?Lb\dE)\w*\n.*?(\d+) "
            r"bytes spill stores.*?\n.*?Used (\d+) registers", log)}
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
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_ab: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    built = build(args.src, _build._nvcc(), _build.FLAGS)
    labels = list(built)
    ref_lib, ref_regs = built[labels[0]]
    for label in labels:
        lib, regs = built[label]
        diff = {k: (ref_regs.get(k), v) for k, v in regs.items()
                if ref_regs.get(k) != v}
        print(f"{label} ({args.src[labels.index(label)]}): {len(regs)} "
              f"instantiations; registers/spill differing from src0: {diff}")
        for tag in MAIN:
            a, b = sass(ref_lib, tag), sass(lib, tag)
            same = None if a is None or b is None else (
                sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))
            print(f"{label} {tag}: registers/spill {regs.get(tag)}; SASS "
                  f"instructions {None if b is None else len(b)}, differing "
                  f"from src0 (offsets masked) {same}", flush=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for label in labels:
        fn = ctypes.CDLL(str(built[label][0])).flash_attention_fwd
        fn.argtypes, fn.restype = [P] * 4 + [I] * 9 + [F, P], I
        fns[label] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, S, H, D, causal, dt in SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        o = torch.empty_like(q)

        def run(label):
            err = fns[label](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), int(dt == "bfloat16"), B, S, S, H,
                             H, D, causal, 0, 1.0 / math.sqrt(D),
                             torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"flash_fwd_ab: CUDA error {err}")

        outs = {}
        for label in labels:
            run(label)
            torch.cuda.synchronize()
            outs[label] = o.clone()
        equal = all(torch.equal(outs[labels[0]], outs[x]) for x in labels)

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
