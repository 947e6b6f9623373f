from .base import BaseDistribution, DiagGaussian

__all__ = ["BaseDistribution", "DiagGaussian"]
