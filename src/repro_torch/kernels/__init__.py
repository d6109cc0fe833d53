"""Hand-written Hopper kernels of the port, each beside its plain version.

  flash_attention — online-softmax attention (every DiT self-attention and
                    every LLM prefill attention, MLA's with v's head dim
                    below q/k's), and its backward
                    (`flash_attention_backward`, every DiT self-attention
                    under training)
  forecast        — fused weighted sum over a finite-difference stack (every
                    forecast step of the predictive cache policies)
  ssd             — the Mamba2 chunked SSD scan (every Mamba2 layer's
                    prefill), and its backward (`ssd_scan_backward`,
                    every Mamba2 layer under training)

Every head dim of flash attention and every p and n of the SSD scan has a
kernel: the widths the main instantiations do not take go to general
units (`_build.launches` counts the launches of each C entry point).

Each subpackage holds `csrc/*.cu` (the CUDA kernel, built for sm_90a by
`_build`), `ops.py` (the wrapper: plain version for CPU tensors, kernel or
an error for CUDA tensors, launch counter) and `ref.py` (plain PyTorch).
Nothing is compiled at import time.
"""
from .flash_attention import flash_attention, flash_attention_backward
from .forecast import forecast
from .ssd import ssd_scan, ssd_scan_backward

KERNELS = (flash_attention, forecast, ssd_scan, flash_attention_backward,
           ssd_scan_backward)

__all__ = ["flash_attention", "flash_attention_backward", "forecast",
           "ssd_scan", "ssd_scan_backward", "KERNELS"]
