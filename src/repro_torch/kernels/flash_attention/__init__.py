from .ops import (MAX_GRID_Z, Route, check_grid, flash_attention,
                  flash_attention_backward, route)
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_backward", "attention_ref",
           "attention_lse_ref", "attention_bwd_ref", "check_grid",
           "MAX_GRID_Z", "Route", "route"]
