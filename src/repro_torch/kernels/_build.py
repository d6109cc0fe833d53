"""Build the port's CUDA kernels and load them with ctypes.

Every `kernels/*/csrc/*.cu` compiles, one `nvcc` process per source all
started together, for Hopper (`sm_90a`) into one shared library with a
plain C interface; `kernels/*.cuh` holds device helpers that several
sources include.  The library lands in `build/repro_torch_kernels/<hash>/`
at the repository root (listed in `.gitignore`), keyed by a hash of the
sources and flags, so an unchanged tree builds once.  A failed build
raises; nothing falls back.

Each C entry point returns `cudaGetLastError()` after its launch; the
Python wrappers raise when it is not 0.  Pointers and the stream travel as
`c_void_p` (a bare Python int would be cut to 32 bits).  `launch` is the
one host path of every wrapper: the library handle without a lock once it
is loaded, no device switch when the tensor's device is already current,
the raw current stream, one ctypes call.

Every entry point `<name>` has a query entry `<name>_plan` with the same
arguments and a record buffer in place of the stream: it runs the same
host path and records each launch it would make (`kernels/launch_plan.cuh`;
read by `repro_torch.analysis.ir.launch_lint`) instead of launching.  A
build and a load emit `repro_torch.obs.watch` events ("kernel-build",
"kernel-load"), which the retrace sentinel counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import torch

from repro_torch.obs import watch

_KERNELS = Path(__file__).resolve().parent
BUILD_ROOT = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v", f"-I{_KERNELS}"]
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib = None            # the loaded library, shared by every wrapper


def sources() -> List[Path]:
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{path}); the CUDA kernels cannot be built")
    return str(path)


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in [*srcs, *sorted(_KERNELS.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        objs = [work / (s.stem + ".o") for s in srcs]
        t0 = time.monotonic()
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]

        def finish(p):     # the compiler's report, and when it ended
            return p.communicate()[0], time.monotonic() - t0
        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, procs))
        log = "".join(f"== {s.name} (done at {sec:.1f} s)\n{text}"
                      for s, (text, sec) in zip(srcs, done))
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(work / LIB_NAME), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        (work / "build.log").write_text(log + link.stdout)
        watch.emit("kernel-build", str(lib))
        try:
            work.rename(out_dir)
        except OSError:        # another process finished the same build
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler's report (ptxas registers, shared memory, spills)."""
    path = BUILD_ROOT / _digest(sources()) / "build.log"
    return path.read_text() if path.exists() else ""


#: every C entry point; each has a query entry `<name>_plan`
ENTRIES = ("flash_attention_fwd", "flash_attention_fwd_split",
           "flash_attention_fwd_lse", "flash_attention_fwd_split_lse",
           "flash_attention_fwd_any", "flash_attention_bwd",
           "flash_attention_bwd_wide", "flash_attention_bwd_any",
           "forecast_fwd", "forecast_basis_fwd", "ssd_fwd", "ssd_fwd_any",
           "ssd_bwd", "ssd_bwd_any")
#: launches of each C entry point, counted where `launch` calls it (a CUDA
#: graph's replay adds what its capture counted): `launches.<entry>`
launches = types.SimpleNamespace(**dict.fromkeys(ENTRIES, 0))


def _declare(lib) -> None:
    """Argument and result types of every C entry point (ENTRIES) and of
    its query entry, which takes the same arguments with the record buffer
    where the stream was."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I,
                                        I, F, P]
    lib.flash_attention_fwd_split.argtypes = [P] * 4 + [I] * 10 + [F, P]
    lib.flash_attention_fwd_lse.argtypes = [P] * 5 + [I] * 9 + [F, P]
    lib.flash_attention_fwd_split_lse.argtypes = [P] * 5 + [I] * 10 + [F, P]
    lib.flash_attention_fwd_any.argtypes = [P] * 5 + [I] * 10 + [F, P]
    lib.flash_attention_bwd.argtypes = [P] * 10 + [I] * 9 + [F, P]
    lib.flash_attention_bwd_wide.argtypes = [P] * 10 + [I] * 10 + [F, P]
    lib.flash_attention_bwd_any.argtypes = [P] * 10 + [I] * 10 + [F, P]
    lib.forecast_fwd.argtypes = [P, P, P, I, I, I, L, I, P]
    lib.forecast_basis_fwd.argtypes = [P, P, P, P, P, I, I, I, L, I, I, I,
                                       ctypes.c_double, P]
    lib.ssd_fwd.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                            L, L, L, L, L, L, L, P]
    lib.ssd_fwd_any.argtypes = lib.ssd_fwd.argtypes
    lib.ssd_bwd.argtypes = [P] * 18 + [I] * 7 + [L] * 7 + [P]
    lib.ssd_bwd_any.argtypes = lib.ssd_bwd.argtypes
    for name in ENTRIES:
        fn, query = getattr(lib, name), getattr(lib, name + "_plan")
        query.argtypes = fn.argtypes
        fn.restype = query.restype = I


def _dlopen(path) -> ctypes.CDLL:
    """Load a shared library, announcing the load to `watch` listeners."""
    watch.emit("kernel-load", str(path))
    return ctypes.CDLL(str(path))


def load():
    """The loaded kernel library (built on first use; no lock after)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = _dlopen(build())
            _declare(lib)
            _lib = lib
    return _lib


def no_grad_launch(name: str, why: str, *tensors) -> None:
    """Raise before a launch that autograd would not see: grad mode on and
    an input requiring a gradient (the output would come back detached and
    the gradient would be lost without a word).  `why` says where the
    backward is to come from."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires a gradient, and the "
                           f"CUDA kernel has no backward: {why}")


def launch(entry: str, idx: int, *args) -> None:
    """Call the C entry point `entry` with `args` and the current stream of
    CUDA device `idx`, switching the current device only if it is another
    one; raise if the launch failed, else count it in `launches`."""
    fn = getattr(_lib if _lib is not None else load(), entry)
    if idx == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    setattr(launches, entry, getattr(launches, entry) + 1)
