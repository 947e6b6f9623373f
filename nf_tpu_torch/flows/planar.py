"""Planar flow (``nf_tpu/flows/planar.py:20-77``; reference
``normflows/flows/planar.py:8-81``).

``f(z) = z + u h(w . z + b)`` with the invertibility reparameterisation
``u <- u + (softplus(w . u) - 1 - w . u) w / |w|^2``, which keeps
``w . u > -1``. ``tanh`` has no algebraic inverse (its ``inverse``
raises, as in the JAX package); ``leaky_relu`` (slope 0.2) has one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.nn import softplus
from .base import Flow

_NEG_SLOPE = 0.2


class Planar(Flow):
    """The parameters ``u`` and ``w`` (1, *shape) and ``b`` (1,) carry the
    reference's names; ``u`` and ``w`` are drawn uniformly from
    ``generator`` unless given."""

    def __init__(self, shape, act="tanh", u=None, w=None, b=None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if act not in ("tanh", "leaky_relu"):
            raise NotImplementedError("Nonlinearity is not implemented.")
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        lim_w = float(np.sqrt(2.0 / np.prod(shape)))
        lim_u = float(np.sqrt(2.0))

        def uniform(lim):
            r = torch.rand((1,) + shape, generator=generator, dtype=dtype)
            return (2.0 * r - 1.0) * lim

        u = uniform(lim_u) if u is None else torch.as_tensor(u, dtype=dtype)
        w = uniform(lim_w) if w is None else torch.as_tensor(w, dtype=dtype)
        b = torch.zeros(1, dtype=dtype) if b is None \
            else torch.as_tensor(b, dtype=dtype)
        self.u = nn.Parameter(u)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        self.act = act

    def _constrained_u(self):
        inner = torch.sum(self.w * self.u)
        return self.u + (softplus(inner) - 1 - inner) * self.w \
            / torch.sum(self.w ** 2)

    def forward(self, z, context=None, generator=None):
        red = tuple(range(1, self.w.ndim))
        lin = torch.sum(self.w * z, dim=red, keepdim=True) + self.b
        u = self._constrained_u()
        if self.act == "tanh":
            h = torch.tanh(lin)
            h_prime = 1.0 / torch.cosh(lin.reshape(-1)) ** 2
        else:
            h = F.leaky_relu(lin, negative_slope=_NEG_SLOPE)
            h_prime = torch.where(lin.reshape(-1) < 0, _NEG_SLOPE, 1.0)
        log_det = torch.log(torch.abs(1 + torch.sum(self.w * u) * h_prime))
        return z + u * h, log_det

    def inverse(self, z, context=None, generator=None):
        if self.act != "leaky_relu":
            raise NotImplementedError("This flow has no algebraic inverse.")
        red = tuple(range(1, self.w.ndim))
        lin = torch.sum(self.w * z, dim=red) + self.b
        a = torch.where(lin < 0, _NEG_SLOPE, 1.0)  # the slope, into u
        u = self._constrained_u()
        dims = (-1,) + (u.ndim - 1) * (1,)
        u = a.reshape(dims) * u
        inner = torch.sum(self.w * u, dim=red)
        z_ = z - u * (lin / (1 + inner)).reshape(dims)
        return z_, -torch.log(torch.abs(1 + inner))
