"""Affine flow layers (``nf_tpu/flows/affine.py``; reference
``normflows/flows/affine/coupling.py``): the constant scale-and-shift
layer and RealNVP's masked coupling. Both are elementwise around plain
products; no kernel of the JAX package runs here."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.nn import sum_except_batch
from .base import Flow


class AffineConstFlow(Flow):
    """Learned constant scale and shift per dimension, ``z * exp(s) + t``
    (``affine.py:24-78``; reference ``coupling.py:9-54``). ``s`` and ``t``
    have shape ``(1, *shape)``, possibly with broadcast axes of size 1;
    the log-det multiplies ``sum(s)`` by the number of positions each
    entry of ``s`` covers. The JAX package's ``scale=False`` /
    ``shift=False`` switches are not ported: none of its builders or
    layers turns them off."""

    def __init__(self, shape, dtype=torch.float32):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        self.s = nn.Parameter(torch.zeros((1,) + tuple(shape), dtype=dtype))
        self.t = nn.Parameter(torch.zeros((1,) + tuple(shape), dtype=dtype))

    def _log_det(self, z, sign):
        n = math.prod(z.shape[i] for i in range(1, z.ndim)
                      if self.s.shape[i] == 1)
        return (sign * n * torch.sum(self.s)).to(z.dtype).expand(z.shape[0])

    def forward(self, z, context=None):
        return z * torch.exp(self.s) + self.t, self._log_det(z, 1)

    def inverse(self, z, context=None):
        return (z - self.t) * torch.exp(-self.s), self._log_det(z, -1)


class MaskedAffineFlow(Flow):
    """RealNVP's masked coupling ``f(z) = b*z + (1-b)*(z*exp(s(b*z)) +
    t(b*z))`` (``affine.py:211-250``; reference ``coupling.py:174-229``).
    ``b`` is a buffer of shape ``(1, D)``; ``s`` and ``t`` are the scale
    and shift nets (None: no scaling, no shift). A non-finite output of a
    net becomes NaN, the reference's guard, with no read of the device."""

    def __init__(self, b, t=None, s=None):
        super().__init__()
        self.register_buffer("b", torch.as_tensor(b).clone()[None])
        self.s = s
        self.t = t

    def _nets(self, z_masked):
        scale = _finite_or_nan(self.s(z_masked)) if self.s is not None \
            else torch.zeros_like(z_masked)
        trans = _finite_or_nan(self.t(z_masked)) if self.t is not None \
            else torch.zeros_like(z_masked)
        return scale, trans

    def forward(self, z, context=None):
        z_masked = self.b * z
        scale, trans = self._nets(z_masked)
        z_ = z_masked + (1 - self.b) * (z * torch.exp(scale) + trans)
        return z_, sum_except_batch((1 - self.b) * scale)

    def inverse(self, z, context=None):
        z_masked = self.b * z
        scale, trans = self._nets(z_masked)
        z_ = z_masked + (1 - self.b) * (z - trans) * torch.exp(-scale)
        return z_, -sum_except_batch((1 - self.b) * scale)


def _finite_or_nan(x):
    return torch.where(torch.isfinite(x), x, torch.nan)
