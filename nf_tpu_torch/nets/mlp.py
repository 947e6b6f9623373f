"""Dense layer (``nf_tpu/nets/mlp.py:24-72``).

``W @ x_t + b[:, None]`` stays ``torch.matmul``: a plain product that the
JAX package also leaves to the compiler.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Linear(nn.Module):
    """Dense layer ``y = x @ W^T + b`` with the reference's init,
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, drawn from ``generator``."""

    def __init__(self, in_features, out_features, bias=True, generator=None,
                 dtype=torch.float32):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)

        def uniform(*shape):
            u = torch.rand(shape, generator=generator, dtype=dtype)
            return (2.0 * u - 1.0) * bound

        self.weight = nn.Parameter(uniform(out_features, in_features))
        self.bias = nn.Parameter(uniform(out_features)) if bias else None

    def forward(self, x):
        y = torch.matmul(x, self.weight.T)
        if self.bias is not None:
            y = y + self.bias
        return y

    def call_transposed(self, x):
        """``y^T = W @ x^T`` -> ``(out, batch)``: the bin-major head emits
        spline parameters in the kernels' ``(K, N)`` plane layout."""
        return self.matmul_t(x.T)

    def matmul_t(self, x_t):
        """Apply to an already-transposed ``(in, batch)`` input:
        ``W @ x_t + b[:, None]`` (transposed conditioner execution)."""
        y = torch.matmul(self.weight, x_t)
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y
