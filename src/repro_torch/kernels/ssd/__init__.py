from .ops import general, ssd_scan, ssd_scan_backward
from .ref import ssd_bwd_ref, ssd_chunked, ssd_ref

__all__ = ["ssd_scan", "ssd_scan_backward", "ssd_chunked", "ssd_ref",
           "ssd_bwd_ref", "general"]
