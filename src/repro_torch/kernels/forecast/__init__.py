from .ops import forecast, forecast_basis
from .ref import basis_coeffs, forecast_ref

__all__ = ["forecast", "forecast_basis", "forecast_ref", "basis_coeffs"]
