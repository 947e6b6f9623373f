from .autoregressive import Autoregressive
from .base import Composite, Flow, Reverse
from .mixing import LULinear, LULinearPermute
from .neural_spline import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
    MaskedPiecewiseRationalQuadraticAutoregressive,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .periodic import PeriodicShift, PeriodicWrap

__all__ = [
    "Autoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "Composite",
    "CoupledRationalQuadraticSpline",
    "Flow",
    "LULinear",
    "LULinearPermute",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "PeriodicShift",
    "PeriodicWrap",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
    "Reverse",
]
