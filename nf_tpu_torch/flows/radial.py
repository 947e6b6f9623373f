"""Radial flow (``nf_tpu/flows/radial.py:17-46``; reference
``normflows/flows/radial.py:8-46``).

``f(z) = z + beta h(alpha, r) (z - z_0)`` with ``h = 1 / (alpha + r)``.
Forward only: it has no algebraic inverse, and its ``inverse`` raises, as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.nn import softplus
from .base import Flow


class Radial(Flow):
    """The parameters ``beta``, ``alpha`` (1,) and ``z_0`` (1, *shape) and
    the buffer ``d`` (the dimension) carry the reference's names;
    ``beta``, ``alpha`` and (unless given) ``z_0`` are drawn from
    ``generator``."""

    def __init__(self, shape, z_0=None, generator=None, dtype=torch.float32):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.dim = int(np.prod(shape))
        lim = 1.0 / np.prod(shape)

        def uniform(lo, hi):
            r = torch.rand((1,), generator=generator, dtype=dtype)
            return lo + (hi - lo) * r

        self.beta = nn.Parameter(uniform(-lim - 1.0, lim - 1.0))
        self.alpha = nn.Parameter(uniform(-lim, lim))
        z_0 = (torch.randn((1,) + shape, generator=generator, dtype=dtype)
               if z_0 is None else torch.as_tensor(z_0, dtype=dtype))
        self.z_0 = nn.Parameter(z_0)
        self.register_buffer("d", torch.tensor(float(self.dim),
                                               dtype=dtype))

    def forward(self, z, context=None, generator=None):
        beta = softplus(self.beta) - torch.abs(self.alpha)
        dz = z - self.z_0
        red = tuple(range(1, self.z_0.ndim))
        r = torch.sqrt(torch.sum(dz ** 2, dim=red, keepdim=True))
        h_arr = beta / (torch.abs(self.alpha) + r)
        h_arr_ = -beta * r / (torch.abs(self.alpha) + r) ** 2
        log_det = (self.dim - 1) * torch.log(1 + h_arr) \
            + torch.log(1 + h_arr + h_arr_)
        return z + h_arr * dz, log_det.reshape(-1)
