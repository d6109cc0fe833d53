"""repro_torch.serving — serving engines of the port (diffusion so far)."""
from .common import RequestQueue

__all__ = ["RequestQueue"]
