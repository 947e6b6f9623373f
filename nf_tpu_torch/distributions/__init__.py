from .base import BaseDistribution, DiagGaussian
from .target import Target, TwoMoons, rejection_sample

__all__ = ["BaseDistribution", "DiagGaussian", "Target", "TwoMoons",
           "rejection_sample"]
