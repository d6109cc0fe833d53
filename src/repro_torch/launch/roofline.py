"""Roofline terms of a traced step on one rank of the mesh (the JAX
package's `launch/roofline.py`, on an H100 in place of a v5e).

Three terms per (arch x shape x mesh), in seconds, per rank:

  compute    = FLOPs            / PEAK_FLOPS
  memory     = HBM bytes        / HBM_BW
  collective = collective bytes / LINK_BW

The peaks are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W power limit: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
of HBM3, 80 GB of it, and NVLink 4 at 900 GB/s per GPU, 450 GB/s each
way.  None is measured here.

`StepCounter` is a dispatch mode that counts what one rank runs.  It sits
below DTensor: for an operator on DTensors it returns NotImplemented, so
DTensor runs first and the mode sees the local operators DTensor issues
on each rank's shards, and the collectives its redistributions and the
models' own `spmd` helpers issue.  So every count is per rank, as XLA's
per-partition cost analysis is (a `FlopCounterMode` above DTensor would
see global shapes).

  flops       `torch.utils.flop_counter`'s formula of each local operator
  hbm bytes   each local operator's tensor inputs read once and outputs
              written once (views move nothing): eager PyTorch runs one
              kernel an operator, so this is the traffic of the step
              without fusion
  collectives the result bytes of each functional collective, by kind
              (JAX's accounting of the HLO's collectives)
  peak        the most bytes that local operators' outputs hold alive at
              once (a weak reference on each output), the activation
              peak above the arguments

DTensor works out an operator's output shape the first time it meets its
shardings by running it on global-shaped fake tensors; the counter skips
those runs (they are found on the call stack), else a trace would count
one layer at the global size.

On the CPU (the dry run, `dryrun.py`) a kernel wrapper takes its plain
version: flash attention's FLOPs are those of `attention_ref`'s two
products, the kernel's own count, but its bytes and the peak include the
plain version's score chunks, which the kernel never writes.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12        # H100 SXM data sheet: dense bf16, tensor cores
HBM_BW = 3.35e12           # H100 SXM data sheet: HBM3 bytes/s
HBM_BYTES = 80e9           # H100 SXM data sheet: HBM3 capacity
LINK_BW = 450e9            # H100 SXM data sheet: NVLink 4, one direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _propagation_codes() -> tuple:
    """The code of DTensor's output-shape propagation (its name differs
    across torch versions; a cached one is unwrapped)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    codes = []
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        fn = getattr(ShardingPropagator, name, None)
        fn = getattr(fn, "__wrapped__", fn)
        if getattr(fn, "__code__", None) is not None:
            codes.append(fn.__code__)
    return tuple(codes)


def _in(codes) -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in codes:
            return True
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, HBM bytes, collective bytes by kind and
    live-output peak (module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._propagation = _propagation_codes()

    def _freed(self, n):
        self.live -= n

    def extrapolate(self, fewer: "StepCounter", n: int) -> None:
        """Add n more of what this count holds beyond `fewer`'s (a step
        traced with one more microbatch than `fewer`'s); the peak stays."""
        self.flops += n * (self.flops - fewer.flops)
        self.hbm_bytes += n * (self.hbm_bytes - fewer.hbm_bytes)
        for k in self.coll_bytes:
            self.coll_bytes[k] += n * (self.coll_bytes[k]
                                       - fewer.coll_bytes[k])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in(self._propagation):
            return out
        if func.namespace in _COLLECTIVE_NS:
            kind = _KIND.get(func._opname)
            if kind is not None:
                self.coll_bytes[kind] += sum(_nbytes(t) for t in
                                             _tensors(out))
            return out
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            outs = list(_tensors(out))
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._freed, n)
            self.peak = max(self.peak, self.live)
        return out


@dataclass
class Roofline:
    flops: float                 # per-rank FLOPs counted (StepCounter)
    hbm_bytes: float             # per-rank bytes read and written
    coll_bytes: Dict[str, int]   # per kind, per rank
    chips: int
    #: the analytic MODEL_FLOPS floor per rank (6 N D / 2 N D over chips)
    analytic_flops_per_chip: float = 0.0

    @property
    def compute_s(self) -> float:
        return max(self.flops, self.analytic_flops_per_chip) / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "analytic_flops_per_chip": self.analytic_flops_per_chip,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": dict(self.coll_bytes),
            "coll_bytes_total": float(sum(self.coll_bytes.values())),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "chips": self.chips,
            "peaks": {"flops_per_s": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                      "link_bytes_per_s": LINK_BW,
                      "source": "H100 SXM data sheet, 700 W"},
        }


def analyze(counter: StepCounter, chips: int,
            analytic_flops: float = 0.0) -> Roofline:
    """The roofline terms of a step `counter` watched.  `analytic_flops`
    is the global MODEL_FLOPS estimate, the compute floor after division
    by the chips."""
    return Roofline(flops=float(counter.flops),
                    hbm_bytes=float(counter.hbm_bytes),
                    coll_bytes=dict(counter.coll_bytes), chips=chips,
                    analytic_flops_per_chip=analytic_flops / max(chips, 1))


def model_flops(cfg, shape) -> float:
    """Survey-style MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) for a
    train step; 2*N*D forward-only for prefill; 2*N_active per decode
    token (a DiT decodes all its patch tokens)."""
    from repro_torch.models import active_param_count
    n = active_param_count(cfg)
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    if cfg.is_dit:
        tokens = shape.global_batch * cfg.dit_patch_tokens
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "LINK_BW", "COLLECTIVES",
           "StepCounter", "Roofline", "analyze", "model_flops"]
