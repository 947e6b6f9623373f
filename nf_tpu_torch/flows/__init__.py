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
    CircularCoupledRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
    MaskedPiecewiseRationalQuadraticAutoregressive,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .normalization import ActNorm
from .periodic import PeriodicShift, PeriodicWrap
from .planar import Planar
from .radial import Radial
from .reshape import Merge, Split, Squeeze
from .residual import (
    Residual,
    fixed_point_stats,
    iResBlock,
    set_exact_logdet,
)

__all__ = [
    "ActNorm",
    "AffineConstFlow",
    "AffineCoupling",
    "AffineCouplingBlock",
    "Autoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CCAffineConst",
    "CircularAutoregressiveRationalQuadraticSpline",
    "CircularCoupledRationalQuadraticSpline",
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
    "Planar",
    "PiecewiseRationalQuadraticCDF",
    "PiecewiseRationalQuadraticCoupling",
    "Radial",
    "Residual",
    "Reverse",
    "Scanned",
    "Split",
    "Squeeze",
    "fixed_point_stats",
    "iResBlock",
    "set_exact_logdet",
]
