from .affine import (
    AffineConstFlow,
    AffineCoupling,
    AffineCouplingBlock,
    CCAffineConst,
    MaskedAffineFlow,
)
from .autoregressive import Autoregressive, MaskedAffineAutoregressive
from .base import Composite, Flow, Reverse, Scanned, zero_log_det_like_z
from .glow import GlowBlock
from .mixing import (
    Invertible1x1Conv,
    InvertibleAffine,
    LULinear,
    LULinearPermute,
    Permute,
)
from .neural_spline import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CircularCoupledRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
    MaskedPiecewiseRationalQuadraticAutoregressive,
    PiecewiseRationalQuadraticCDF,
    PiecewiseRationalQuadraticCoupling,
)
from .neural_spline.coupling import Coupling
from .normalization import ActNorm, BatchNorm
from .periodic import PeriodicShift, PeriodicWrap
from .planar import Planar
from .radial import Radial
from .reshape import Merge, Split, Squeeze
from .stochastic import HamiltonianMonteCarlo, MetropolisHastings
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
    "BatchNorm",
    "CCAffineConst",
    "CircularAutoregressiveRationalQuadraticSpline",
    "CircularCoupledRationalQuadraticSpline",
    "Composite",
    "Coupling",
    "CoupledRationalQuadraticSpline",
    "Flow",
    "GlowBlock",
    "HamiltonianMonteCarlo",
    "Invertible1x1Conv",
    "InvertibleAffine",
    "LULinear",
    "LULinearPermute",
    "MaskedAffineAutoregressive",
    "MaskedAffineFlow",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "Merge",
    "MetropolisHastings",
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
    "zero_log_det_like_z",
]
