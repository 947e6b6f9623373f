from .base import (
    AffineGaussian,
    BaseDistribution,
    ClassCondDiagGaussian,
    ConditionalDiagGaussian,
    DiagGaussian,
    GaussianMixture,
    GaussianPCA,
    GlowBase,
    Uniform,
    UniformGaussian,
)
from .decoder import BaseDecoder, NNBernoulliDecoder, NNDiagGaussianDecoder
from .encoder import BaseEncoder, ConstDiagGaussian, Dirac, NNDiagGaussian
from .encoder import Uniform as UniformEncoder
from .linear_interpolation import LinearInterpolation
from .mh_proposal import DiagGaussianProposal, MHProposal
from .prior import (
    ImagePrior,
    PriorDistribution,
    Sinusoidal,
    Sinusoidal_gap,
    Sinusoidal_split,
    Smiley,
    TwoModes,
)
from .target import ConditionalDiagGaussian as ConditionalDiagGaussianTarget
from .target import (
    CircularGaussianMixture,
    RingMixture,
    Target,
    TwoIndependent,
    TwoMoons,
    rejection_sample,
)

__all__ = ["AffineGaussian", "BaseDecoder", "BaseDistribution",
           "BaseEncoder", "CircularGaussianMixture",
           "ClassCondDiagGaussian", "ConditionalDiagGaussian",
           "ConditionalDiagGaussianTarget", "ConstDiagGaussian",
           "DiagGaussian", "DiagGaussianProposal", "Dirac",
           "GaussianMixture", "GaussianPCA", "GlowBase", "ImagePrior",
           "LinearInterpolation", "MHProposal", "NNBernoulliDecoder",
           "NNDiagGaussian", "NNDiagGaussianDecoder", "PriorDistribution",
           "RingMixture", "Sinusoidal", "Sinusoidal_gap",
           "Sinusoidal_split", "Smiley", "Target",
           "TwoIndependent", "TwoModes", "TwoMoons", "Uniform",
           "UniformEncoder", "UniformGaussian", "rejection_sample"]
