from .ops import forecast
from .ref import basis_coeffs, forecast_ref

__all__ = ["forecast", "forecast_ref", "basis_coeffs"]
