from .ops import MAX_GRID_Z, check_grid, flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "check_grid", "MAX_GRID_Z"]
