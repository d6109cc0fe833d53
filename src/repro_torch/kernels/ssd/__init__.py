from .ops import ssd_scan
from .ref import ssd_chunked, ssd_ref

__all__ = ["ssd_scan", "ssd_chunked", "ssd_ref"]
