from .base import BaseDistribution, DiagGaussian, UniformGaussian
from .target import Target, TwoMoons, rejection_sample

__all__ = ["BaseDistribution", "DiagGaussian", "Target", "TwoMoons",
           "UniformGaussian", "rejection_sample"]
