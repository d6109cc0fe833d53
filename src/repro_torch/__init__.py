"""repro_torch — the PyTorch/CUDA port of the `repro` package for NVIDIA
Hopper (H100).

Mirrors the JAX package module for module; the JAX package stays the
reference the port is tested against.  This package imports torch and
numpy, never JAX and never `repro`.  Entry points run on the GPU unless
the caller passes device="cpu".  See README.md ("PyTorch/H100 port") and
ROADMAP.md for what is ported.
"""
__version__ = "0.1.0"
