"""Mixing layers of the NSF stack (``nf_tpu/flows/mixing.py:204-365``;
reference ``normflows/flows/mixing.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.nn import softplus
from .base import Flow


class _Permutation(Flow):
    """Index-select permutation along ``dim`` (reference
    ``mixing.py:213-247``); the buffer keeps the reference's name."""

    def __init__(self, permutation, dim=1):
        super().__init__()
        self.register_buffer("_permutation",
                             torch.as_tensor(permutation, dtype=torch.int64))
        self.dim = dim

    def forward(self, z, context=None):
        z_ = torch.index_select(z, self.dim, self._permutation)
        return z_, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)

    def inverse(self, z, context=None):
        z_ = torch.index_select(z, self.dim, torch.argsort(self._permutation))
        return z_, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


class _RandomPermutation(_Permutation):
    """Random fixed permutation (reference ``mixing.py:250-254``)."""

    def __init__(self, features, dim=1, generator=None):
        super().__init__(torch.randperm(features, generator=generator), dim)


class LULinear(Flow):
    """``y = L U x + b`` with unit-diagonal L and ``diag(U) = softplus(raw)
    + eps`` (reference ``mixing.py:368-532``); the inverse is two
    triangular solves and the log-det is ``sum(log diag(U))``."""

    def __init__(self, features, eps=1e-3, dtype=torch.float32):
        super().__init__()
        n_tri = ((features - 1) * features) // 2
        # identity init: L = U = I
        self.lower_entries = nn.Parameter(torch.zeros(n_tri, dtype=dtype))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri, dtype=dtype))
        self.unconstrained_upper_diag = nn.Parameter(torch.full(
            (features,), math.log(math.exp(1 - eps) - 1), dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))
        self.register_buffer("_lower_indices",
                             torch.tril_indices(features, features, -1),
                             persistent=False)
        self.register_buffer("_upper_indices",
                             torch.triu_indices(features, features, 1),
                             persistent=False)
        self.features = features
        self.eps = eps

    @property
    def upper_diag(self):
        return softplus(self.unconstrained_upper_diag) + self.eps

    def _create_lower_upper(self):
        n = self.features
        dtype, device = self.lower_entries.dtype, self.lower_entries.device
        lower = torch.zeros(n, n, dtype=dtype, device=device)
        lower = lower.index_put(tuple(self._lower_indices),
                                self.lower_entries)
        lower = lower + torch.eye(n, dtype=dtype, device=device)
        upper = torch.zeros(n, n, dtype=dtype, device=device)
        upper = upper.index_put(tuple(self._upper_indices),
                                self.upper_entries)
        upper = upper + torch.diag(self.upper_diag)
        return lower, upper

    def logabsdet(self):
        return torch.sum(torch.log(self.upper_diag))

    def forward(self, z, context=None):
        lower, upper = self._create_lower_upper()
        out = (z @ upper.T) @ lower.T + self.bias
        ld = self.logabsdet()
        return out, torch.broadcast_to(ld, (z.shape[0],)).to(z.dtype)

    def inverse(self, z, context=None):
        lower, upper = self._create_lower_upper()
        rhs = (z - self.bias).T
        sol = torch.linalg.solve_triangular(lower, rhs, upper=False,
                                            unitriangular=True)
        sol = torch.linalg.solve_triangular(upper, sol, upper=True)
        ld = -self.logabsdet()
        return sol.T, torch.broadcast_to(ld, (z.shape[0],)).to(z.dtype)


class LULinearPermute(Flow):
    """Fixed random permutation composed with an LU linear transform, the
    NSF mixing layer (reference ``mixing.py:535-563``). ``forward``
    applies ``linear.inverse`` then ``permutation.inverse``."""

    def __init__(self, num_channels, generator=None):
        super().__init__()
        self.permutation = _RandomPermutation(num_channels,
                                              generator=generator)
        self.linear = LULinear(num_channels)

    def forward(self, z, context=None):
        z, log_det = self.linear.inverse(z, context=context)
        z, _ = self.permutation.inverse(z, context=context)
        return z, log_det

    def inverse(self, z, context=None):
        z, _ = self.permutation.forward(z, context=context)
        z, log_det = self.linear.forward(z, context=context)
        return z, log_det
