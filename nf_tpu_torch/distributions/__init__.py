from .base import (
    BaseDistribution,
    ClassCondDiagGaussian,
    ConditionalDiagGaussian,
    DiagGaussian,
    GlowBase,
    UniformGaussian,
)
from .prior import PriorDistribution, TwoModes
from .target import ConditionalDiagGaussian as ConditionalDiagGaussianTarget
from .target import Target, TwoMoons, rejection_sample

__all__ = ["BaseDistribution", "ClassCondDiagGaussian",
           "ConditionalDiagGaussian", "ConditionalDiagGaussianTarget",
           "DiagGaussian", "GlowBase",
           "PriorDistribution", "Target", "TwoModes", "TwoMoons",
           "UniformGaussian", "rejection_sample"]
