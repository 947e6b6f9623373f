"""Small neural-net helpers (reference ``normflows/utils/nn.py``)."""

from __future__ import annotations

import torch


def sum_except_batch(x, num_batch_dims=1):
    """Sum over all but the first ``num_batch_dims`` axes
    (reference ``utils/nn.py:190``)."""
    dims = tuple(range(num_batch_dims, x.ndim))
    return torch.sum(x, dim=dims) if dims else x


def softplus(x):
    """``log(1 + exp(x))`` in the form ``jax.nn.softplus`` evaluates it
    (``max(x, 0) + log1p(exp(-|x|))``), with no threshold cut-over, so the
    port and the JAX package agree to rounding; the CUDA kernels use the
    same form (``csrc/rqs_math.cuh``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
