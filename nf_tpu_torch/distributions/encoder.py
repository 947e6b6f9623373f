"""VAE encoders q(z|x) with ``(batch, num_samples, ...)`` outputs
(``nf_tpu/distributions/encoder.py``; reference
``normflows/distributions/encoder.py``).

``forward(x, num_samples=1, generator=None) -> (z, log_q)``. A drawing
encoder takes its noise through ``draw(shape, generator, like)`` (the
dtype and device of ``like``), where the JAX package draws from a key, so
a test can hand both frameworks the same noise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_LOG2PI = math.log(2 * math.pi)


def _normal(shape, generator, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _as_batch(z):
    """A single sample or a flat batch as ``(1, ..., d)``, as the JAX
    package's ``log_prob`` takes them."""
    if z.ndim == 1:
        z = z[None]
    if z.ndim == 2:
        z = z[None]
    return z


class BaseEncoder(nn.Module):
    """Abstract conditional base distribution q(z|x) (reference
    ``encoder.py:6-37``)."""

    def forward(self, x, num_samples=1, generator=None):
        raise NotImplementedError

    def log_prob(self, z, x):
        raise NotImplementedError


class Dirac(BaseEncoder):
    """Deterministic encoder ``z = x`` (reference ``encoder.py:40-52``)."""

    def forward(self, x, num_samples=1, generator=None):
        z = x[:, None].repeat_interleave(num_samples, dim=1)
        return z, torch.zeros(z.shape[0:2], dtype=z.dtype, device=z.device)

    def log_prob(self, z, x):
        return torch.zeros(z.shape[0:2], dtype=z.dtype, device=z.device)


class Uniform(BaseEncoder):
    """Uniform encoder on ``[zmin, zmax)`` (reference
    ``encoder.py:55-72``); its draw is ``z`` itself."""

    def __init__(self, zmin=0.0, zmax=1.0):
        super().__init__()
        self.zmin = float(zmin)
        self.zmax = float(zmax)

    def draw(self, shape, generator, like):
        u = torch.rand(shape, generator=generator, dtype=like.dtype,
                       device=like.device)
        return self.zmin + (self.zmax - self.zmin) * u

    def forward(self, x, num_samples=1, generator=None):
        z = self.draw((x.shape[0], num_samples) + tuple(x.shape[1:]),
                      generator, x)
        return z, self.log_prob(z, x)

    def log_prob(self, z, x):
        return torch.full(z.shape[0:2], -math.log(self.zmax - self.zmin),
                          dtype=z.dtype, device=z.device)


class ConstDiagGaussian(BaseEncoder):
    """Diagonal Gaussian with x-independent parameters ``loc`` ``(1, 1,
    d)`` and ``scale`` (reference ``encoder.py:75-130``)."""

    def __init__(self, loc, scale, dtype=torch.float32):
        super().__init__()
        self.loc = nn.Parameter(
            torch.as_tensor(loc, dtype=dtype).reshape(1, 1, -1).clone())
        self.scale = nn.Parameter(torch.as_tensor(scale, dtype=dtype).clone())

    @property
    def d(self):
        return self.loc.shape[-1]

    def draw(self, shape, generator, like):
        return _normal(shape, generator, like)

    def forward(self, x=None, num_samples=1, generator=None):
        batch_size = x.shape[0] if x is not None else 1
        eps = self.draw((batch_size, num_samples, self.d), generator,
                        self.loc)
        z = self.loc + self.scale * eps
        log_q = -0.5 * self.d * _LOG2PI - torch.sum(
            torch.log(self.scale) + 0.5 * eps ** 2, dim=2)
        return z, log_q

    def log_prob(self, z, x):
        z = _as_batch(z)
        return -0.5 * self.d * _LOG2PI - torch.sum(
            torch.log(self.scale) + 0.5 * ((z - self.loc) / self.scale) ** 2,
            dim=2)


class NNDiagGaussian(BaseEncoder):
    """Diagonal Gaussian whose mean and log-variance come from ``net(x)``,
    stacked along axis 1 (reference ``encoder.py:133-188``)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def _mean_log_var(self, x):
        mean_std = self.net(x)
        n_hidden = mean_std.shape[1] // 2
        return (mean_std[:, :n_hidden][:, None],
                mean_std[:, n_hidden:2 * n_hidden][:, None])

    def draw(self, shape, generator, like):
        return _normal(shape, generator, like)

    def forward(self, x, num_samples=1, generator=None):
        mean, log_var = self._mean_log_var(x)
        std = torch.exp(0.5 * log_var)
        eps = self.draw((x.shape[0], num_samples) + tuple(mean.shape[2:]),
                        generator, x)
        z = mean + std * eps
        d = math.prod(z.shape[2:])
        log_q = -0.5 * d * _LOG2PI - torch.sum(
            torch.log(std) + 0.5 * eps ** 2, dim=tuple(range(2, z.ndim)))
        return z, log_q

    def log_prob(self, z, x):
        z = _as_batch(z)
        mean, log_var = self._mean_log_var(x)
        var = torch.exp(log_var)
        d = math.prod(z.shape[2:])
        return -0.5 * d * _LOG2PI - 0.5 * torch.sum(
            torch.log(var) + (z - mean) ** 2 / var,
            dim=tuple(range(2, z.ndim)))
