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

from ..utils.nn import complement_indices

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


class UniformGaussian(BaseDistribution):
    """Per-index mix of uniform entries (width ``scale``, centred at 0) at
    ``ind`` and Gaussian ones elsewhere (``nf_tpu/distributions/base.py:
    160-205``; reference ``base.py:198-270``): the base of the circular
    NSF. Buffers ``scale``, ``ind``, ``ind_`` and ``inv_perm`` carry the
    reference's names."""

    def __init__(self, ndim, ind, scale=None, dtype=torch.float32):
        super().__init__()
        ind, other, inv_perm = complement_indices(ndim, ind)
        self.ndim = ndim
        scale = (torch.ones(ndim, dtype=dtype) if scale is None
                 else torch.as_tensor(scale, dtype=dtype).clone())
        self.register_buffer("scale", scale)
        self.register_buffer("ind", torch.tensor(ind, dtype=torch.int64))
        self.register_buffer("ind_", torch.tensor(other, dtype=torch.int64))
        self.register_buffer("inv_perm",
                             torch.tensor(inv_perm, dtype=torch.int64))

    def forward(self, num_samples=1, generator=None):
        z = self.sample(num_samples, generator=generator)
        return z, self.log_prob(z)

    def sample(self, num_samples=1, generator=None):
        kw = dict(generator=generator, dtype=self.scale.dtype,
                  device=self.scale.device)
        eps_u = torch.rand((num_samples, self.ind.shape[0]), **kw) - 0.5
        eps_g = torch.randn((num_samples, self.ind_.shape[0]), **kw)
        z = torch.cat([eps_u, eps_g], dim=-1)[..., self.inv_perm]
        return self.scale * z

    def log_prob(self, z):
        log_p_u = torch.broadcast_to(-torch.log(self.scale[self.ind]),
                                     (z.shape[0], self.ind.shape[0]))
        sc = self.scale[self.ind_]
        log_p_g = (-0.5 * _LOG2PI - torch.log(sc)
                   - 0.5 * (z[..., self.ind_] / sc) ** 2)
        return torch.sum(log_p_u, -1) + torch.sum(log_p_g, -1)
