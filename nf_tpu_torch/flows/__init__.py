from .affine import AffineConstFlow, MaskedAffineFlow
from .autoregressive import Autoregressive, MaskedAffineAutoregressive
from .base import Composite, Flow, Reverse, Scanned
from .mixing import LULinear, LULinearPermute, Permute
from .neural_spline import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
    MaskedPiecewiseRationalQuadraticAutoregressive,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .normalization import ActNorm
from .periodic import PeriodicShift, PeriodicWrap

__all__ = [
    "ActNorm",
    "AffineConstFlow",
    "Autoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "Composite",
    "CoupledRationalQuadraticSpline",
    "Flow",
    "LULinear",
    "LULinearPermute",
    "MaskedAffineAutoregressive",
    "MaskedAffineFlow",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "PeriodicShift",
    "PeriodicWrap",
    "Permute",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
    "Reverse",
    "Scanned",
]
