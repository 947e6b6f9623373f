from .coupling import (
    Coupling,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .wrapper import CoupledRationalQuadraticSpline

__all__ = [
    "CoupledRationalQuadraticSpline",
    "Coupling",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
]
