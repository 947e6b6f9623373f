from .autoregressive import MaskedPiecewiseRationalQuadraticAutoregressive
from .coupling import (
    Coupling,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .wrapper import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
)

__all__ = [
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "CoupledRationalQuadraticSpline",
    "Coupling",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
]
