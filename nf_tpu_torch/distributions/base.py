"""Base distributions (``nf_tpu/distributions/base.py``; reference
``normflows/distributions/base.py``).

``forward(num_samples, generator=None) -> (z, log_p)`` samples with log
density; ``log_prob(z)`` evaluates it. Randomness comes from an explicit
``torch.Generator`` on the distribution's device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_LOG2PI = math.log(2 * math.pi)


class BaseDistribution(nn.Module):
    """Abstract base distribution (reference ``distributions/base.py:8``)."""

    def forward(self, num_samples=1, generator=None):
        raise NotImplementedError

    def log_prob(self, z):
        raise NotImplementedError

    def sample(self, num_samples=1, generator=None):
        z, _ = self.forward(num_samples, generator=generator)
        return z


class DiagGaussian(BaseDistribution):
    """Diagonal Gaussian with loc/log_scale (reference ``base.py:52-103``).
    A non-trainable one keeps them as buffers, as the reference does."""

    def __init__(self, shape, trainable=True, dtype=torch.float32):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape)
        self.d = math.prod(self.shape)
        loc = torch.zeros((1,) + self.shape, dtype=dtype)
        log_scale = torch.zeros((1,) + self.shape, dtype=dtype)
        if trainable:
            self.loc = nn.Parameter(loc)
            self.log_scale = nn.Parameter(log_scale)
        else:
            self.register_buffer("loc", loc)
            self.register_buffer("log_scale", log_scale)

    def forward(self, num_samples=1, generator=None):
        eps = torch.randn((num_samples,) + self.shape, generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        z = self.loc + torch.exp(self.log_scale) * eps
        log_p = -0.5 * self.d * _LOG2PI - torch.sum(
            self.log_scale + 0.5 * eps ** 2, dim=tuple(range(1, eps.ndim)))
        return z, log_p

    def log_prob(self, z):
        eps = (z - self.loc) / torch.exp(self.log_scale)
        return -0.5 * self.d * _LOG2PI - torch.sum(
            self.log_scale + 0.5 * eps ** 2, dim=tuple(range(1, z.ndim)))
