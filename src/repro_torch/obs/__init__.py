"""repro_torch.obs — the serving stack's clock."""
from .clock import monotonic

__all__ = ["monotonic"]
