"""CUDA launch lint: checks of every call that passes through
`repro_torch.kernels._build.launch`, the one host path of every kernel
wrapper (the counterpart of the JAX package's `ir/pallas_lint.py`).

Each wrapper is driven at the main paths' shapes (PERF.md §6: DiT-XL
serving and training, the video DiT's temporal fold, the zamba2, dense,
pixtral and MLA prefills, tinyllama, pixtral and MLA training (head dims
160 and 192 over 128: the wide backward), the forecast kernel at the
serving and video-pool sizes, the SSD scan and its backward on zamba2's
bf16 views) with `_build.launch` wrapped to capture each call: its C entry
point, its raw arguments, the tensors of the wrapper's frame whose
pointers it passes, and the wrapper's line.  Two kinds of check follow.

Python side, on the capture:
  * every tensor operand contiguous (the SSD scan's x, B and C: a unit
    last stride);
  * 16-byte aligned pointers (and, for the SSD scan, rows and strides)
    wherever the vectorised staging assumes them; a forecast launched with
    vec set, or the split and wide flash entries, depend on them outright,
    and
    elsewhere a miss drops the call to element-by-element staging;
  * one floating dtype per call, the one the dtype code names, and the
    f32 / int32 operands of their types; no float64 / complex128;
  * every `int` argument (and the products the C forms in `int`) within
    int32 — ctypes would cut a larger Python int without a word.

Plan side, on the card: the query entry `<entry>_plan` runs the same host
path with a record buffer in place of the stream
(`kernels/launch_plan.cuh`), so each site reports the plan it really
launches — grid, block, dynamic shared memory, and `cudaFuncGetAttributes`
of the instantiation chosen (registers, static shared memory, local
memory = spill bytes) — and the lint checks grid y and z <= 65535 (x <
2^31), threads <= 1024 and <= the instantiation's maximum, static plus
dynamic shared memory <= the card's opt-in limit, registers x threads <=
the registers of a block, and `cudaOccupancyMaxActiveBlocksPerMultiprocessor`
>= 1.  Spill bytes are reported per instantiation, not judged.

The lint runs on the card only: a CUDA kernel has no CPU mode, and on the
CPU the wrappers run their plain versions and never reach `launch`.  The
checks themselves take synthetic captures and plans anywhere.
"""
from __future__ import annotations

import ctypes
import inspect
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

from .op_checks import OpIssue

__all__ = ["LaunchCapture", "LaunchPlan", "ENTRY_ARGS", "PLAN_FIELDS",
           "intercept_launches", "check_capture", "check_plan",
           "query_plans", "lint_launches", "KERNEL_CASES"]

#: each C entry point's arguments, in order (the stream left out).
#: Pointer roles: ":T" floating operand in the call's dtype, ":Ts" the same
#: with strides of its own (unit last stride), ":f32", ":i32", ":host"
#: (host bytes); "?" may be null.  Bare names are scalars.
ENTRY_ARGS: Dict[str, Tuple[str, ...]] = {
    "flash_attention_fwd": ("q:T", "k:T", "v:T", "o:T", "dtype", "B", "Sq",
                            "Sk", "H", "KH", "D", "causal", "window",
                            "scale"),
    "flash_attention_fwd_split": ("q:T", "k:T", "v:T", "o:T", "dtype", "B",
                                  "Sq", "Sk", "H", "KH", "D", "Dv", "causal",
                                  "window", "scale"),
    "flash_attention_fwd_lse": ("q:T", "k:T", "v:T", "o:T", "lse:f32",
                                "dtype", "B", "Sq", "Sk", "H", "KH", "D",
                                "causal", "window", "scale"),
    "flash_attention_fwd_split_lse": ("q:T", "k:T", "v:T", "o:T", "lse:f32",
                                      "dtype", "B", "Sq", "Sk", "H", "KH",
                                      "D", "Dv", "causal", "window", "scale"),
    "flash_attention_bwd": ("q:T", "k:T", "v:T", "o:T", "dO:T", "lse:f32",
                            "delta:f32", "dq:T", "dk:T", "dv:T", "dtype", "B",
                            "Sq", "Sk", "H", "KH", "D", "causal", "window",
                            "scale"),
    "flash_attention_bwd_wide": ("q:T", "k:T", "v:T", "o:T", "dO:T",
                                 "lse:f32", "delta:f32", "dq:T", "dk:T",
                                 "dv:T", "dtype", "B", "Sq", "Sk", "H", "KH",
                                 "D", "Dv", "causal", "window", "scale"),
    "flash_attention_fwd_any": ("q:T", "k:T", "v:T", "o:T", "lse:f32?",
                                "dtype", "B", "Sq", "Sk", "H", "KH", "D",
                                "Dv", "causal", "window", "scale"),
    "flash_attention_bwd_any": ("q:T", "k:T", "v:T", "o:T", "dO:T",
                                "lse:f32", "delta:f32", "dq:T", "dk:T",
                                "dv:T", "dtype", "B", "Sq", "Sk", "H", "KH",
                                "D", "Dv", "causal", "window", "scale"),
    "forecast_fwd": ("d:T", "c:f32", "o:T", "dtype", "batch", "m1", "n",
                     "vec"),
    "forecast_basis_fwd": ("d:T", "steps:i32", "last:i32", "n_valid:i32",
                           "o:T", "dtype", "batch", "m1", "n", "vec", "basis",
                           "interval", "sigma"),
    "ssd_fwd": ("x:Ts", "dt:f32", "A:f32", "B:Ts", "C:Ts", "cb:f32", "y:f32",
                "hout:f32", "dtype", "b", "s", "h", "p", "n", "xs_b", "xs_t",
                "xs_h", "bs_b", "bs_t", "cs_b", "cs_t"),
    "ssd_bwd": ("x:Ts", "dt:f32", "A:f32", "B:Ts", "C:Ts", "dy:f32",
                "dhf:f32?", "hst:f32", "gst:f32", "decay:f32", "dx:T",
                "ddt:f32", "dbp:f32", "dcp:f32", "dapart:f32", "dB:T", "dC:T",
                "dA:f32", "dtype", "b", "s", "h", "p", "n", "group", "xs_b",
                "xs_t", "xs_h", "bs_b", "bs_t", "cs_b", "cs_t"),
}
# the general SSD units take ssd_fwd's and ssd_bwd's arguments
ENTRY_ARGS["ssd_fwd_any"] = ENTRY_ARGS["ssd_fwd"]
ENTRY_ARGS["ssd_bwd_any"] = ENTRY_ARGS["ssd_bwd"]

#: operands the vectorised staging reads in 16-byte units, beyond the
#: ":T" / ":Ts" ones (the SSD backward's f32 inputs and state scratch)
_ALIGNED_F32 = {"ssd_bwd": ("dy", "dhf", "hst", "gst")}
#: scalar arguments the C takes as `long long` (all others are `int`,
#: `float` or `double`)
_STRIDES = ("xs_b", "xs_t", "xs_h", "bs_b", "bs_t", "cs_b", "cs_t")
_LONG_ARGS = {"forecast_fwd": ("n",), "forecast_basis_fwd": ("n",),
              "ssd_fwd": _STRIDES, "ssd_bwd": _STRIDES,
              "ssd_fwd_any": _STRIDES, "ssd_bwd_any": _STRIDES}
_FLOAT_ARGS = {"scale", "sigma"}
#: products of int arguments the C forms in `int`
_INT_PRODUCTS = {"ssd_bwd": (("p", "n"),), "ssd_fwd": (("p", "n"),),
                 "ssd_bwd_any": (("p", "n"),), "ssd_fwd_any": (("p", "n"),)}
_DTYPE_CODES = {0: "torch.float32", 1: "torch.bfloat16"}
_INT32 = 2 ** 31

#: fields of one plan record (kernels/launch_plan.cuh), in order
PLAN_FIELDS = ("line", "file", "name", "grid_x", "grid_y", "grid_z",
               "block_x", "block_y", "block_z", "dyn_smem", "regs",
               "static_smem", "local_bytes", "max_threads", "active_blocks",
               "max_dyn_smem", "optin_smem", "regs_per_block",
               "binary_version", "reserved")
_PLAN_MAX = 8


@dataclass
class LaunchCapture:
    """One call through `_build.launch`."""
    entry: str
    args: Tuple = ()
    #: argument name -> the tensor of the wrapper's frame it points into
    tensors: Dict[str, object] = field(default_factory=dict)
    device: int = 0
    file: str = ""               # the wrapper's line
    line: int = 0
    case: str = ""               # the main-path case that made the call

    def arg(self, name: str):
        names = [a.split(":")[0] for a in ENTRY_ARGS[self.entry]]
        return self.args[names.index(name)]


@dataclass
class LaunchPlan:
    """What one C launch site would launch, from its query entry."""
    site: str                    # "flash_attention.cu:512"
    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    dyn_smem: int
    regs: int
    static_smem: int
    local_bytes: int             # spill bytes of the instantiation
    max_threads: int
    active_blocks: int
    max_dyn_smem: int
    optin_smem: int
    regs_per_block: int
    entry: str = ""
    case: str = ""

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    def line(self) -> str:
        return (f"{self.site} {self.kernel} [{self.case}]: regs {self.regs}, "
                f"spill {self.local_bytes} B, smem {self.static_smem} + "
                f"{self.dyn_smem} B (opt-in {self.optin_smem}), threads "
                f"{self.threads}, grid {self.grid}, active blocks/SM "
                f"{self.active_blocks}")


def _frame_tensors(frame) -> Dict[int, List]:
    """data_ptr -> tensors among a frame's locals (one level into tuples,
    lists and dicts)."""
    import torch
    out: Dict[int, List] = {}

    def add(v):
        if isinstance(v, torch.Tensor):
            out.setdefault(v.data_ptr(), []).append(v)

    for v in frame.f_locals.values():
        add(v)
        if isinstance(v, (list, tuple)):
            for w in v:
                add(w)
        elif isinstance(v, dict):
            for w in v.values():
                add(w)
    return out


def _bind_tensors(entry: str, args: Sequence, frame) -> Dict[str, object]:
    by_ptr = _frame_tensors(frame)
    bound = {}
    for spec, val in zip(ENTRY_ARGS[entry], args):
        name, _, role = spec.partition(":")
        if not role or role.startswith("host") or not val:
            continue
        cands = by_ptr.get(int(val), [])
        want = {"f32": "torch.float32", "i32": "torch.int32"}.get(
            role.rstrip("?"))
        pick = [t for t in cands if want is None or str(t.dtype) == want]
        if pick or cands:
            bound[name] = (pick or cands)[0]
    return bound


@contextmanager
def intercept_launches(records: List[LaunchCapture], case: str = ""):
    """Wrap `_build.launch` so that each call is captured (and then made):
    entry, arguments, the wrapper frame's tensors, the wrapper's line."""
    from repro_torch.kernels import _build
    real = _build.launch

    def capture(entry, idx, *args):
        frame = inspect.currentframe().f_back
        records.append(LaunchCapture(
            entry=entry, args=tuple(args),
            tensors=_bind_tensors(entry, args, frame), device=idx,
            file=frame.f_code.co_filename, line=frame.f_lineno, case=case))
        return real(entry, idx, *args)

    _build.launch = capture
    try:
        yield records
    finally:
        _build.launch = real


# ----------------------------------------------------------------------
def check_capture(cap: LaunchCapture) -> List[OpIssue]:
    """The Python-side checks of one captured call."""
    import torch
    issues: List[OpIssue] = []

    def issue(msg):
        issues.append(OpIssue("launch", f"{cap.entry}: {msg}", cap.file,
                              cap.line))

    spec = ENTRY_ARGS[cap.entry]
    if len(cap.args) != len(spec):
        issue(f"{len(cap.args)} arguments for the {len(spec)} of the C "
              f"entry point")
        return issues
    code = cap.arg("dtype")
    call_dtype = _DTYPE_CODES.get(code)
    if call_dtype is None:
        issue(f"dtype code {code} names no kernel dtype")
    per16 = 4 if code == 0 else 8
    vec_required = cap.entry in ("flash_attention_fwd_split",
                                 "flash_attention_fwd_split_lse",
                                 "flash_attention_bwd_wide") or (
        cap.entry.startswith("forecast") and bool(cap.arg("vec")))
    aligned = set(_ALIGNED_F32.get(cap.entry, ()))
    floating = set()
    for s, val in zip(spec, cap.args):
        name, _, role = s.partition(":")
        if not role:
            if name in _FLOAT_ARGS:
                continue
            lim = 2 ** 63 if name in _LONG_ARGS.get(cap.entry, ()) \
                else _INT32
            if not -lim <= int(val) < lim:
                issue(f"argument {name} = {val} does not fit the C "
                      f"{'long long' if lim > _INT32 else 'int'}")
            continue
        nullable = role.endswith("?")
        role = role.rstrip("?")
        if role == "host":
            continue
        if not val:
            if not nullable:
                issue(f"pointer {name} is null")
            continue
        t = cap.tensors.get(name)
        if t is None:
            issue(f"pointer {name} is not a tensor of the wrapper's frame: "
                  f"the lint cannot vouch for it")
            continue
        dt = str(t.dtype)
        if t.dtype in (torch.float64, torch.complex128):
            issue(f"{name} is {dt[6:]} — no kernel takes wide dtypes")
        if role in ("T", "Ts"):
            floating.add(dt)
            if call_dtype is not None and dt != call_dtype:
                issue(f"{name} is {dt[6:]} but the call's dtype code names "
                      f"{call_dtype[6:]}")
        elif role == "f32" and t.dtype != torch.float32:
            issue(f"{name} must be float32, is {dt[6:]}")
        elif role == "i32" and t.dtype != torch.int32:
            issue(f"{name} must be int32, is {dt[6:]}")
        if role == "Ts":
            if t.dim() and t.stride(-1) != 1:
                issue(f"{name} has last stride {t.stride(-1)}, the kernel "
                      f"needs 1")
        elif not t.is_contiguous():
            issue(f"{name} is not contiguous {tuple(t.shape)} strides "
                  f"{t.stride()}")
        if (role in ("T", "Ts") or name in aligned) and int(val) % 16:
            how = ("the kernel needs it" if vec_required else
                   "the call drops to element-by-element staging")
            issue(f"{name} pointer is {int(val) % 16} bytes off 16-byte "
                  f"alignment; {how}")
    if len(floating) > 1:
        issue(f"mixed floating dtypes {sorted(floating)} in one call")
    if cap.entry.startswith("ssd"):
        p, n = cap.arg("p"), cap.arg("n")
        strides = [cap.arg(k) for k in _STRIDES]
        if p % per16 or n % per16 or any(v % per16 for v in strides):
            issue(f"rows (p {p}, n {n}) or strides {strides} are not whole "
                  f"16-byte units; the call drops to element-by-element "
                  f"staging")
    for prod in _INT_PRODUCTS.get(cap.entry, ()):
        v = 1
        for k in prod:
            v *= int(cap.arg(k))
        if v >= _INT32:
            issue(f"{' * '.join(prod)} = {v} overflows the C int")
    return issues


def check_plan(plan: LaunchPlan, file: str = "", line: int = 0
               ) -> List[OpIssue]:
    """The plan-side checks of one recorded launch."""
    issues: List[OpIssue] = []

    def issue(msg):
        issues.append(OpIssue("launch", f"{plan.site} {plan.kernel}: {msg}",
                              file, line))

    gx, gy, gz = plan.grid
    if not 1 <= gx < _INT32:
        issue(f"grid x {gx} outside 1 .. 2^31 - 1")
    if not (1 <= gy <= 65535 and 1 <= gz <= 65535):
        issue(f"grid y / z ({gy}, {gz}) outside 1 .. 65535")
    if plan.threads > 1024 or plan.threads < 1:
        issue(f"{plan.threads} threads a block (at most 1024)")
    elif plan.max_threads and plan.threads > plan.max_threads:
        issue(f"{plan.threads} threads a block over the instantiation's "
              f"{plan.max_threads}")
    if plan.static_smem + plan.dyn_smem > plan.optin_smem:
        issue(f"shared memory {plan.static_smem} + {plan.dyn_smem} B over "
              f"the card's opt-in {plan.optin_smem} B")
    if plan.dyn_smem > max(plan.max_dyn_smem, 48 * 1024):
        issue(f"dynamic shared memory {plan.dyn_smem} B over the "
              f"{plan.max_dyn_smem} B the kernel was raised to")
    if plan.regs * plan.threads > plan.regs_per_block:
        issue(f"{plan.regs} registers x {plan.threads} threads over the "
              f"{plan.regs_per_block} of a block")
    if plan.active_blocks < 1:
        issue("no block fits on an SM (occupancy 0)")
    return issues


def query_plans(cap: LaunchCapture) -> List[LaunchPlan]:
    """Run the captured call's query entry on the card: the plan of every
    launch site the call passes."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.load()
    n = len(PLAN_FIELDS)
    buf = (ctypes.c_longlong * (1 + _PLAN_MAX * n))()
    with torch.cuda.device(cap.device):
        err = getattr(lib, cap.entry + "_plan")(*cap.args, buf)
    if err != 0:
        raise RuntimeError(f"{cap.entry}_plan: CUDA error {err}")
    plans = []
    for i in range(buf[0]):
        r = dict(zip(PLAN_FIELDS, buf[1 + i * n: 1 + (i + 1) * n]))
        site = os.path.basename(ctypes.string_at(r["file"]).decode())
        plans.append(LaunchPlan(
            site=f"{site}:{r['line']}",
            kernel=ctypes.string_at(r["name"]).decode(),
            grid=(r["grid_x"], r["grid_y"], r["grid_z"]),
            block=(r["block_x"], r["block_y"], r["block_z"]),
            dyn_smem=r["dyn_smem"], regs=r["regs"],
            static_smem=r["static_smem"], local_bytes=r["local_bytes"],
            max_threads=r["max_threads"], active_blocks=r["active_blocks"],
            max_dyn_smem=r["max_dyn_smem"], optin_smem=r["optin_smem"],
            regs_per_block=r["regs_per_block"], entry=cap.entry,
            case=cap.case))
    return plans


# ----------------------------------------------------------------------
# the main paths' shapes (PERF.md §6): each family yields (case, run)
def _gen(torch):
    return torch.Generator(device="cuda").manual_seed(0)


def _drive_flash(torch):
    from repro_torch.kernels import flash_attention
    g = _gen(torch)

    def qkv(B, S, H, KH, D, dtype, Dv=None, Sk=None):
        Sk = Sk or S
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, Sk, KH, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, Sk, KH, Dv or D), generator=g,
                        device="cuda").to(dtype)
        return q, k, v

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("dit-xl serving f32", (8, 256, 16, 16, 72, f32), False),
             ("dit-xl serving bf16", (8, 256, 16, 16, 72, bf16), False),
             ("dit-video temporal", (512, 16, 16, 16, 72, f32), False),
             ("zamba2 prefill", (4, 512, 32, 32, 80, bf16), True),
             ("tinyllama prefill", (4, 512, 32, 4, 64, bf16), True),
             ("pixtral prefill D160", (2, 1088, 32, 8, 160, bf16), True),
             ("deepseek-v2 MLA prefill", (4, 512, 128, 128, 192, bf16, 128),
              True),
             # the general unit: f32 above 128, and bf16 at Gemma's 256
             ("pixtral prefill f32 D160", (2, 1088, 32, 8, 160, f32), True),
             ("gemma-7b prefill D256", (2, 1024, 16, 16, 256, bf16), True)]
    for name, shape, causal in cases:
        yield name, (lambda s=shape, c=causal:
                     flash_attention(*qkv(*s), causal=c))
    for name, shape, causal in (
            ("dit-xl train bf16", (8, 256, 16, 16, 72, bf16), False),
            ("dit-xl train f32", (8, 256, 16, 16, 72, f32), False),
            ("tinyllama train", (8, 128, 32, 4, 64, bf16), True),
            ("pixtral train D160", (2, 1088, 32, 8, 160, bf16), True),
            ("deepseek-v2 MLA train", (4, 512, 128, 128, 192, bf16, 128),
             True),
            ("deepseek-v2 MLA train f32", (4, 512, 128, 128, 192, f32, 128),
             True)):
        def train(s=shape, c=causal):
            q, k, v = (t.requires_grad_(True) for t in qkv(*s))
            flash_attention(q, k, v, causal=c).float().square().sum() \
                .backward()
        yield name, train


def _drive_forecast(torch):
    import numpy as np
    from repro_torch.kernels.forecast import forecast, forecast_basis
    g = _gen(torch)
    for name, batch, n, dtype in (
            ("dit-xl 4 slots f32", 4, 256 * 16, torch.float32),
            ("dit-xl 4 slots bf16", 4, 256 * 16, torch.bfloat16),
            ("dit-video pool", 2, 4096 * 16, torch.float32)):
        def run(b=batch, n=n, dt=dtype):
            d = torch.randn((b, 3, n), generator=g, device="cuda").to(dt)
            c = torch.rand((b, 3), generator=g, device="cuda")
            forecast(d, c)
            last = torch.zeros((b,), dtype=torch.int32, device="cuda")
            nv = torch.full((b,), 2, dtype=torch.int32, device="cuda")
            forecast_basis(d, np.arange(1, b + 1), last, nv, 4, "taylor")
        yield name, run


def _drive_ssd(torch):
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_backward
    g = _gen(torch)

    def inputs(b, s, h, p, n, xbc):
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=g, device="cuda"))
        A = -torch.exp(torch.rand((h,), generator=g, device="cuda"))
        if xbc:       # bf16 views of one conv output, as mamba2 passes them
            w = h * p
            buf = torch.randn((b, s, w + 2 * n), generator=g,
                              device="cuda").to(torch.bfloat16)
            return (buf[..., :w].view(b, s, h, p), dt, A, buf[..., w:w + n],
                    buf[..., w + n:])
        return (torch.randn((b, s, h, p), generator=g, device="cuda"), dt, A,
                torch.randn((b, s, n), generator=g, device="cuda"),
                torch.randn((b, s, n), generator=g, device="cuda"))

    for name, shape, xbc in (("zamba2 prefill f32", (4, 512, 80, 64, 64),
                              False),
                             ("zamba2 prefill bf16 views",
                              (4, 512, 80, 64, 64), True),
                             ("ragged s 500", (1, 500, 80, 64, 64), True)):
        yield name, (lambda s=shape, x=xbc: ssd_scan(*inputs(*s, x)))

    # the general unit: zamba2's Mamba2 layer at the published state 128
    yield "zamba2 n 128 bf16 views", (
        lambda: ssd_scan(*inputs(4, 512, 80, 64, 128, True)))

    def backward(n=64):
        b, s, h, p = 8, 128, 80, 64
        x, dt, A, B_, C_ = inputs(b, s, h, p, n, True)
        dy = torch.randn((b, s, h, p), generator=g, device="cuda")
        dh = torch.randn((b, h, p, n), generator=g, device="cuda")
        ssd_scan_backward(x, dt, A, B_, C_, dy, dh)
    yield "zamba2 train bf16 views", backward
    yield "zamba2 n 128 train bf16 views", lambda: backward(128)


KERNEL_CASES: Dict[str, Callable] = {
    "flash_attention": _drive_flash,
    "forecast": _drive_forecast,
    "ssd": _drive_ssd,
}


@dataclass
class LaunchLintResult:
    issues: List[OpIssue] = field(default_factory=list)
    plans: List[LaunchPlan] = field(default_factory=list)
    captures: int = 0
    entries: List[str] = field(default_factory=list)

    def site_lines(self) -> List[str]:
        seen, out = set(), []
        for p in self.plans:
            key = (p.site, p.kernel, p.regs, p.grid, p.dyn_smem)
            if key not in seen:
                seen.add(key)
                out.append(p.line())
        return out


def lint_launches() -> LaunchLintResult:
    """Drive every wrapper at the main paths' shapes under interception,
    check each capture and the plan of each site it passes.  A case that
    errors, or a C entry point no case reached, is itself an issue:
    a launch the lint cannot reach is not one it vouches for."""
    import torch
    res = LaunchLintResult()
    for family, cases in sorted(KERNEL_CASES.items()):
        for case, run in cases(torch):
            records: List[LaunchCapture] = []
            try:
                with intercept_launches(records, case=f"{family}: {case}"):
                    run()
                torch.cuda.synchronize()
            except Exception as e:
                res.issues.append(OpIssue(
                    "launch", f"{family} [{case}]: the case failed ({e!r}) — "
                    f"launch unlintable"))
                continue
            if not records:
                res.issues.append(OpIssue(
                    "launch", f"{family} [{case}]: the case launched "
                    f"nothing — the wrapper no longer reaches _build.launch"))
            for cap in records:
                res.captures += 1
                res.issues.extend(check_capture(cap))
                try:
                    plans = query_plans(cap)
                except Exception as e:
                    res.issues.append(OpIssue(
                        "launch", f"{cap.entry}: plan query failed ({e!r})",
                        cap.file, cap.line))
                    continue
                if not plans:
                    res.issues.append(OpIssue(
                        "launch", f"{cap.entry}: the query recorded no "
                        f"launch", cap.file, cap.line))
                for p in plans:
                    res.plans.append(p)
                    res.issues.extend(check_plan(p, cap.file, cap.line))
                if cap.entry not in res.entries:
                    res.entries.append(cap.entry)
    from repro_torch.kernels import _build
    for entry in _build.ENTRIES:
        if entry not in res.entries:
            res.issues.append(OpIssue(
                "launch", f"{entry}: no case reached this C entry point"))
    return res
