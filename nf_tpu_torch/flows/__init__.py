from .base import Composite, Flow, Reverse
from .mixing import LULinear, LULinearPermute
from .neural_spline import (
    CoupledRationalQuadraticSpline,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)

__all__ = [
    "Composite",
    "CoupledRationalQuadraticSpline",
    "Flow",
    "LULinear",
    "LULinearPermute",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
    "Reverse",
]
