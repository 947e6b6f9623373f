"""Dequantisation transforms for data loading
(``nf_tpu/utils/preprocessing.py``; reference
``normflows/utils/preprocessing.py``): ``x * 255/256 + U(0, 1/256)``,
then the logit."""

from __future__ import annotations

import torch


class Logit:
    """``logit(alpha + (1 - alpha) * x)`` (reference
    ``preprocessing.py:4-27``)."""

    def __init__(self, alpha=0.0):
        self.alpha = alpha

    def __call__(self, x):
        x_ = self.alpha + (1 - self.alpha) * x
        return torch.log(x_ / (1 - x_))

    def inverse(self, x):
        return (torch.sigmoid(x) - self.alpha) / (1 - self.alpha)


class Jitter:
    """Add uniform dequantisation noise ``U(0, scale)`` (reference
    ``preprocessing.py:28-44``), drawn from an explicit
    ``torch.Generator`` on ``x``'s device."""

    def __init__(self, scale=1.0 / 256):
        self.scale = scale

    def __call__(self, x, generator=None):
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)
        return x + u * self.scale


class Scale:
    """Rescale, by 255/256 by default (reference
    ``preprocessing.py:45-57``)."""

    def __init__(self, scale=255.0 / 256.0):
        self.scale = scale

    def __call__(self, x):
        return x * self.scale
