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

__all__ = ["AffineGaussian", "BaseDistribution", "CircularGaussianMixture",
           "ClassCondDiagGaussian", "ConditionalDiagGaussian",
           "ConditionalDiagGaussianTarget", "DiagGaussian",
           "GaussianMixture", "GaussianPCA", "GlowBase", "ImagePrior",
           "PriorDistribution", "RingMixture", "Sinusoidal",
           "Sinusoidal_gap", "Sinusoidal_split", "Smiley", "Target",
           "TwoIndependent", "TwoModes", "TwoMoons", "Uniform",
           "UniformGaussian", "rejection_sample"]
