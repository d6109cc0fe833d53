"""Operator records of one program run, and the contract checks over them
(the counterpart of the JAX package's `ir/jaxpr_checks.py`).

The eager port has no jaxpr: the record of a program is what one run of
it dispatches.  `OpRecorder`, a `TorchDispatchMode`, sees every aten
operator a run makes (after autograd, before the kernels) and keeps:

  * host syncs: `aten._local_scalar_dense` (`.item()`, `float(t)`,
    `int(t)`, `bool(t)`), `aten.is_nonzero`, `aten.equal`, the operators
    whose output shape depends on the data (`nonzero`, `masked_select`,
    `unique*`, `bincount`, `repeat_interleave` without `output_size`,
    indexing by a boolean mask), copies from a CUDA tensor into a CPU
    one, and blocking copies from a CPU tensor into a CUDA one (torch
    ends a pageable host-to-device copy in a cudaStreamSynchronize: the
    host waits for every kernel queued before it;
    `repro_torch.device.to_device` is the copy that does not);
  * float64 and complex128 outputs;
  * the storages each operator wrote in place (the in-place report a
    train step's donation check reads);
  * the priced reads: `repro_torch.obs.watch.host_read` calls, and the
    copies and scalar reads made inside them, which are the designed read
    of a program and not a stray sync;
  * for the checks of captured programs: the operator sequence (name,
    and the shapes and dtypes of the tensor arguments), tensors made from
    host data (`aten.lift_fresh`: `torch.tensor`, `torch.as_tensor` of a
    numpy array, `torch.from_numpy`; a CUDA graph would freeze their
    values), and every storage the run read that no operator of the run
    made (what a graph of the program pins beyond its temporaries).

On the card the recorder also turns on `torch.cuda.set_sync_debug_mode`
for the run: every synchronizing CUDA call torch makes warns, and each
warning outside a priced read is a second-channel sync.  It also sees
the copies no operator shows: `torch.as_tensor(data, device="cuda")`
copies inside tensor construction, below the dispatch mode.  A device-to-host
copy made by `.cpu()` or `.tolist()` of a CPU tensor moves nothing, so on
the CPU only the scalar reads and the data-dependent operators show;
`.item()`, `float()`, `nonzero` and float64 show on either device.

JAX's check of weak-typed outputs has no torch meaning: torch has no weak
types (a Python scalar operand promotes by torch's category rules inside
one operator and leaves no typed residue behind), so there is nothing to
record.

Every check returns `OpIssue`s — (category, message, file, line) — that
`verify` turns into registry Findings.  An issue carries the user frame
that dispatched the operator (the first frame outside torch and this
package), so inline `# repro-lint: disable=` suppressions apply.
"""
from __future__ import annotations

import os
import sys
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.obs import watch

__all__ = ["OpIssue", "OpEvent", "OpRecord", "OpRecorder", "record_program",
           "check_record", "inplace_report", "check_donation",
           "check_const_bloat", "DonationError", "SYNC_OPS",
           "DATA_DEPENDENT_OPS", "HOST_DATA_OPS", "CONST_THRESHOLD"]

#: operators that read a device value on the host
SYNC_OPS = frozenset({"_local_scalar_dense", "is_nonzero", "equal", "item"})
#: operators whose output shape depends on the data (a sync on the card)
DATA_DEPENDENT_OPS = frozenset({
    "nonzero", "nonzero_numpy", "argwhere", "masked_select", "unique",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "bincount"})
#: indexing operators that sync when an index is a boolean mask
_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                        "_index_put_impl_"})
#: operators that may copy device -> host
_COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from",
                       "_copy_from_and_resize"})
_WIDE = (torch.float64, torch.complex128)
#: operators that make a tensor from host data
HOST_DATA_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
#: undeclared storages a program reads above this many bytes are flagged
#: (JAX's const-bloat threshold); small tables and scalars are normal
CONST_THRESHOLD = 1 << 16

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB_DIR = os.path.dirname(os.path.abspath(os.__file__))
_HERE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WATCH_FILE = os.path.abspath(watch.__file__).rstrip("c")


@dataclass(frozen=True)
class OpIssue:
    """One contract violation found in a program's record."""
    category: str                # "host-sync" | "dtype" | "donation" | ...
    message: str
    file: str = ""               # absolute source path when known
    line: int = 0


class DonationError(RuntimeError):
    """A step that did not update every state leaf in place; `.issue`
    holds the OpIssue."""

    def __init__(self, issue: "OpIssue"):
        super().__init__(issue.message)
        self.issue = issue


@dataclass(frozen=True)
class OpEvent:
    """One operator of interest: what it was and which user line ran it."""
    op: str
    kind: str      # "sync" | "dtoh" | "htod" | "data-dependent" | "wide"
    detail: str = ""
    file: str = ""
    line: int = 0


@dataclass
class OpRecord:
    """What one run of a program dispatched."""
    key: object = None
    ops: int = 0
    op_counts: Counter = field(default_factory=Counter)
    syncs: List[OpEvent] = field(default_factory=list)       # unpriced
    priced: List[OpEvent] = field(default_factory=list)      # inside reads
    priced_reads: int = 0                                     # host_read calls
    sync_warnings: List[OpEvent] = field(default_factory=list)  # card only
    wide: List[OpEvent] = field(default_factory=list)
    written: Set[int] = field(default_factory=set)            # storage ptrs
    #: (op name, ((shape, dtype) of each tensor argument, ...)) in order
    sequence: List[Tuple] = field(default_factory=list)
    host_data: List[OpEvent] = field(default_factory=list)
    #: storage ptr -> (bytes, shape, dtype) of storages read but not made
    reads: Dict[int, Tuple] = field(default_factory=dict)
    produced: Set[int] = field(default_factory=set)           # storage ptrs


def _user_frame() -> Tuple[str, int]:
    """(file, line) of the innermost frame outside torch, this package and
    the watch module — the source line that dispatched the operator."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not (fn.startswith((_TORCH_DIR, _HERE_DIR, _STDLIB_DIR, "<"))
                or fn == _WATCH_FILE):
            return fn, f.f_lineno
        f = f.f_back
    return "", 0


def _device_type(x) -> str:
    return x.device.type if isinstance(x, torch.Tensor) else ""


class OpRecorder(TorchDispatchMode):
    """Record one program run: `with OpRecorder(key) as rec: fn()`, then
    `rec.record`.  Nests under other dispatch modes (FlopCounterMode)."""

    def __init__(self, key=None, sync_debug: Optional[bool] = None):
        super().__init__()
        self.record = OpRecord(key=key)
        self._depth = 0          # inside host_read
        if sync_debug is None:
            sync_debug = torch.cuda.is_available() \
                and torch.cuda.is_initialized()
        self._sync_debug = sync_debug
        self._prev_mode = None
        self._warn_ctx = None
        self._prev_show = None

    # -- watch listener: priced reads ----------------------------------
    def _on_event(self, kind: str, detail) -> None:
        if kind == "priced-read":
            self._depth += int(detail)
            if int(detail) > 0:
                self.record.priced_reads += 1

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None) -> None:
        text = str(message)
        if "called a synchronizing" not in text:
            self._prev_show(message, category, filename, lineno, file, line)
            return
        ev = OpEvent("cuda-sync", "sync", text.splitlines()[0],
                     *_user_frame())
        (self.record.priced if self._depth else
         self.record.sync_warnings).append(ev)

    def __enter__(self):
        watch.listen(self._on_event)
        if self._sync_debug:
            self._warn_ctx = warnings.catch_warnings()
            self._warn_ctx.__enter__()
            warnings.simplefilter("always")
            self._prev_show = warnings.showwarning
            warnings.showwarning = self._on_warning
            self._prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._sync_debug:
                torch.cuda.set_sync_debug_mode(self._prev_mode)
                self._warn_ctx.__exit__(*exc)
            watch.unlisten(self._on_event)

    # -- the dispatch hook ----------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.record
        sig = []
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                sig.append((tuple(t.shape), str(t.dtype)))
                st = t.untyped_storage()
                ptr = st.data_ptr()
                if ptr and ptr not in rec.produced and ptr not in rec.reads:
                    rec.reads[ptr] = (st.nbytes(), tuple(t.shape),
                                      str(t.dtype))
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                rec.produced.add(t.untyped_storage().data_ptr())
        rec.ops += 1
        name = func._overloadpacket.__name__
        rec.op_counts[name] += 1
        rec.sequence.append((name, tuple(sig)))
        if name in HOST_DATA_OPS:
            rec.host_data.append(OpEvent(str(func), "host-data",
                                         "a tensor made from host data",
                                         *_user_frame()))
            for t in tree_leaves(out):       # reported as host data only
                if isinstance(t, torch.Tensor):
                    rec.reads.pop(t.untyped_storage().data_ptr(), None)
        kind, detail = self._classify(name, func, args, kwargs, out)
        if kind is not None:
            ev = OpEvent(str(func), kind, detail, *_user_frame())
            if kind == "wide":
                rec.wide.append(ev)
            elif self._depth:
                rec.priced.append(ev)
            else:
                rec.syncs.append(ev)
        for i, a in enumerate(func._schema.arguments):
            info = a.alias_info
            if info is None or not info.is_write:
                continue
            val = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            for t in tree_leaves(val):
                if isinstance(t, torch.Tensor):
                    rec.written.add(t.untyped_storage().data_ptr())
        return out

    @staticmethod
    def _classify(name, func, args, kwargs, out):
        if name in SYNC_OPS:
            return "sync", f"{name}: a device value read on the host"
        if name in DATA_DEPENDENT_OPS:
            return "data-dependent", (f"{name}: output shape depends on the "
                                      f"data (the host waits for it)")
        if name == "repeat_interleave" and kwargs.get("output_size") is None \
                and args and isinstance(args[0], torch.Tensor) \
                and len(args) == 1:
            return "data-dependent", ("repeat_interleave without "
                                      "output_size: its length is read on "
                                      "the host")
        if name in _INDEX_OPS and len(args) > 1:
            idx = args[1] if isinstance(args[1], (list, tuple)) else []
            if any(isinstance(t, torch.Tensor)
                   and t.dtype in (torch.bool, torch.uint8) for t in idx):
                return "data-dependent", (f"{name} by a boolean mask: the "
                                          f"mask's nonzero count is read on "
                                          f"the host")
        if name in _COPY_OPS:
            if name == "_to_copy":
                src, dst = (args[0] if args else None), out
            else:
                dst, src = (args[0] if args else None), \
                    (args[1] if len(args) > 1 else None)
            if _device_type(src) == "cuda" and _device_type(dst) == "cpu":
                return "dtoh", f"{name}: a CUDA tensor copied to the host"
            if _device_type(src) == "cpu" and _device_type(dst) == "cuda" \
                    and not kwargs.get("non_blocking", False) \
                    and not (name == "copy_" and len(args) > 2 and args[2]):
                return "htod", (f"{name}: a blocking host-to-device copy "
                                f"(the stream drains first; "
                                f"repro_torch.device.to_device does not "
                                f"wait)")
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype in _WIDE:
                return "wide", f"{name} produces {str(t.dtype)[6:]}"
        return None, ""


def record_program(key, fn: Callable[[], object],
                   sync_debug: Optional[bool] = None):
    """Run fn() once under an OpRecorder; (fn's result, OpRecord)."""
    with OpRecorder(key, sync_debug=sync_debug) as rec:
        out = fn()
    return out, rec.record


def check_record(record: OpRecord, *, priced_reads: int = 0,
                 label: str = "program") -> List[OpIssue]:
    """The program contract over one record: no host sync outside its
    priced reads, exactly `priced_reads` of those, no float64 / complex128
    tensor."""
    issues: List[OpIssue] = []
    for e in record.syncs:
        issues.append(OpIssue(
            "host-sync", f"{label}: {e.detail} ({e.op}) — a host sync "
            f"outside the program's priced read", e.file, e.line))
    for e in record.sync_warnings:
        issues.append(OpIssue(
            "host-sync", f"{label}: torch's sync debug mode: {e.detail}",
            e.file, e.line))
    if record.priced_reads != priced_reads:
        issues.append(OpIssue(
            "host-sync", f"{label}: {record.priced_reads} priced read(s), "
            f"expected exactly {priced_reads}"))
    for e in record.wide:
        issues.append(OpIssue(
            "dtype", f"{label}: '{e.op}' {e.detail} — a wide dtype on the "
            f"device path", e.file, e.line))
    return issues


def check_const_bloat(record: OpRecord, declared=(), *,
                      threshold: int = CONST_THRESHOLD,
                      label: str = "program") -> List[OpIssue]:
    """The captured-program contract over one record: no tensor made from
    host data inside the program (a CUDA graph freezes its value), and no
    storage above `threshold` bytes read that the run did not make and
    the owner does not declare (`declared`: tensors — the param leaves and
    the static buffers).  Such a storage is pinned by the graph: a closed-
    over table that belongs in a static buffer, or freed memory the replay
    would read."""
    issues = [OpIssue("const-bloat", f"{label}: {e.detail} ({e.op}) inside "
                      f"the captured program — a replay would see the value "
                      f"of the capture", e.file, e.line)
              for e in record.host_data]
    known = {t.untyped_storage().data_ptr() for t in declared
             if isinstance(t, torch.Tensor)}
    for ptr, (nbytes, shape, dtype) in sorted(record.reads.items()):
        if ptr in known or nbytes <= threshold:
            continue
        issues.append(OpIssue(
            "const-bloat", f"{label}: reads an undeclared {dtype} tensor "
            f"of shape {shape} ({nbytes} bytes > {threshold}) that it did "
            f"not make: a captured graph pins it — make it a param, a "
            f"static buffer or an argument"))
    return issues


def _leaves(tree) -> List:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def inplace_report(record: OpRecord, before, after) -> List[Dict]:
    """For each tensor leaf of `before` (a state a step took) and `after`
    (the state it returned): was it updated in place — same storage, and
    written during the step?"""
    b, a = _leaves(before), _leaves(after)
    out = []
    for i, (x, y) in enumerate(zip(b, a)):
        px = x.untyped_storage().data_ptr()
        same = px == y.untyped_storage().data_ptr()
        out.append({"leaf": i,
                    "same_storage": same,
                    "written": px in record.written,
                    "in_place": same and px in record.written})
    if len(b) != len(a):
        out.append({"leaf": "<structure>", "same_storage": False,
                    "written": False, "in_place": False})
    return out


def check_donation(record: OpRecord, before, after,
                   label: str = "step") -> Optional[OpIssue]:
    """None when every leaf of the state was updated in place; an issue
    naming the leaves that were not (a step that returns copies holds two
    of every leaf, the eager form of a donation that silently no-ops)."""
    report = inplace_report(record, before, after)
    bad = [r["leaf"] for r in report if not r["in_place"]]
    if not bad:
        return None
    return OpIssue(
        "donation", f"{label}: {len(bad)} of {len(report)} state leaves "
        f"not updated in place (leaf indices {bad[:8]}"
        f"{'...' if len(bad) > 8 else ''}) — the step holds a second copy "
        f"of each")
