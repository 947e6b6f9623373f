from .autoregressive import MaskedPiecewiseRationalQuadraticAutoregressive
from .coupling import (
    Coupling,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .wrapper import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CircularCoupledRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
)

__all__ = [
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "CircularCoupledRationalQuadraticSpline",
    "CoupledRationalQuadraticSpline",
    "Coupling",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
]
