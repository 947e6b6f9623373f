from .base import (
    BaseDistribution,
    ConditionalDiagGaussian,
    DiagGaussian,
    UniformGaussian,
)
from .prior import PriorDistribution, TwoModes
from .target import ConditionalDiagGaussian as ConditionalDiagGaussianTarget
from .target import Target, TwoMoons, rejection_sample

__all__ = ["BaseDistribution", "ConditionalDiagGaussian",
           "ConditionalDiagGaussianTarget", "DiagGaussian",
           "PriorDistribution", "Target", "TwoModes", "TwoMoons",
           "UniformGaussian", "rejection_sample"]
