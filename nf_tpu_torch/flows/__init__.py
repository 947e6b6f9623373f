from .affine import (
    AffineConstFlow,
    AffineCoupling,
    AffineCouplingBlock,
    CCAffineConst,
    MaskedAffineFlow,
)
from .autoregressive import Autoregressive, MaskedAffineAutoregressive
from .base import Composite, Flow, Reverse, Scanned
from .glow import GlowBlock
from .mixing import Invertible1x1Conv, LULinear, LULinearPermute, Permute
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
from .reshape import Merge, Split, Squeeze

__all__ = [
    "ActNorm",
    "AffineConstFlow",
    "AffineCoupling",
    "AffineCouplingBlock",
    "Autoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CCAffineConst",
    "CircularAutoregressiveRationalQuadraticSpline",
    "Composite",
    "CoupledRationalQuadraticSpline",
    "Flow",
    "GlowBlock",
    "Invertible1x1Conv",
    "LULinear",
    "LULinearPermute",
    "MaskedAffineAutoregressive",
    "MaskedAffineFlow",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "Merge",
    "PeriodicShift",
    "PeriodicWrap",
    "Permute",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
    "Reverse",
    "Scanned",
    "Split",
    "Squeeze",
]
