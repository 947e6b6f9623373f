"""Small neural-net helpers (reference ``normflows/utils/nn.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sum_except_batch(x, num_batch_dims=1):
    """Sum over all but the first ``num_batch_dims`` axes
    (reference ``utils/nn.py:190``)."""
    dims = tuple(range(num_batch_dims, x.ndim))
    return torch.sum(x, dim=dims) if dims else x


def one_hot(y, num_classes, dtype):
    """Integer labels (B,) as one-hot (B, num_classes) rows of ``dtype``
    (by comparison: no range check that would wait for the device); a
    one-hot (B, num_classes) input unchanged."""
    if y.ndim == 1:
        classes = torch.arange(num_classes, device=y.device)
        return (y[:, None] == classes).to(dtype)
    return y


def softplus(x):
    """``log(1 + exp(x))`` in the form ``jax.nn.softplus`` evaluates it
    (``max(x, 0) + log1p(exp(-|x|))``), with no threshold cut-over, so the
    port and the JAX package agree to rounding; the CUDA kernels use the
    same form (``csrc/rqs_math.cuh``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def complement_indices(ndim, ind):
    """``(ind, the other indices, the inverse of the permutation ind +
    other)`` as int lists (``nf_tpu/utils/nn.py:29``)."""
    ind = [int(i) for i in np.asarray(ind).reshape(-1)]
    other = [i for i in range(ndim) if i not in ind]
    inv_perm = [0] * ndim
    for i, p in enumerate(ind + other):
        inv_perm[p] = i
    return ind, other, inv_perm


class PeriodicFeaturesElementwise(nn.Module):
    """Replace the circular coordinates f with ``w1*sin(s*f) + w2*cos(s*f)``
    elementwise (``nf_tpu/utils/nn.py:39-80``; reference
    ``utils/nn.py:64-131``). The parameter ``weights`` (len(ind), 2), the
    optional ``bias`` and the buffers ``scale``, ``ind``, ``ind_`` and
    ``inv_perm`` carry the reference's names."""

    def __init__(self, ndim, ind, scale=1.0, bias=False, activation=None,
                 dtype=torch.float32):
        super().__init__()
        ind_a, other, inv_perm = complement_indices(ndim, ind)
        self.ndim = ndim
        self.activation = activation
        self.weights = nn.Parameter(torch.ones((len(ind_a), 2), dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(len(ind_a), dtype=dtype))
                     if bias else None)
        scale = torch.broadcast_to(torch.as_tensor(scale, dtype=dtype),
                                   (len(ind_a),)).clone()
        self.register_buffer("scale", scale)
        self.register_buffer("ind", torch.tensor(ind_a, dtype=torch.int64))
        self.register_buffer("ind_", torch.tensor(other, dtype=torch.int64))
        self.register_buffer("inv_perm",
                             torch.tensor(inv_perm, dtype=torch.int64))

    def forward(self, inputs):
        x = inputs[..., self.ind] * self.scale
        x = (self.weights[:, 0] * torch.sin(x)
             + self.weights[:, 1] * torch.cos(x))
        if self.bias is not None:
            x = x + self.bias
        if self.activation is not None:
            x = self.activation(x)
        out = torch.cat([x, inputs[..., self.ind_]], dim=-1)
        return out[..., self.inv_perm]


class PeriodicFeaturesCat(nn.Module):
    """Replace the circular coordinates f with ``[sin(s*f), cos(s*f)]``
    concatenated (``nf_tpu/utils/nn.py:82-103``; reference
    ``utils/nn.py:133-178``): ``ndim + len(ind)`` output features, ordered
    ``[sin, cos, the other features]``. No parameters; the buffers
    ``scale``, ``ind`` and ``ind_`` carry the reference's names."""

    def __init__(self, ndim, ind, scale=1.0, dtype=torch.float32):
        super().__init__()
        ind_a, other, _ = complement_indices(ndim, ind)
        self.ndim = ndim
        scale = torch.broadcast_to(torch.as_tensor(scale, dtype=dtype),
                                   (len(ind_a),)).clone()
        self.register_buffer("scale", scale)
        self.register_buffer("ind", torch.tensor(ind_a, dtype=torch.int64))
        self.register_buffer("ind_", torch.tensor(other, dtype=torch.int64))

    def forward(self, inputs):
        x = inputs[..., self.ind] * self.scale
        return torch.cat([torch.sin(x), torch.cos(x), inputs[..., self.ind_]],
                         dim=-1)


def tile(x, n):
    """Interleaved tiling (reference ``utils/nn.py:181``):
    ``tile([a, b], 2) == [a, a, b, b]``, the input flattened first."""
    return torch.repeat_interleave(x.reshape(-1), n)


class ConstScaleLayer(nn.Module):
    """Multiply by a fixed constant (``nf_tpu/utils/nn.py:106-112``;
    reference ``utils/nn.py:7-24``)."""

    def __init__(self, scale=1.0):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return x * self.scale


class ClampExp(nn.Module):
    """Nonlinearity ``min(exp(lam * x), 1)`` (``nf_tpu/utils/nn.py:
    115-121``; reference ``utils/nn.py:46-62``)."""

    def __init__(self, lam=1.0):
        super().__init__()
        self.lam = lam

    def forward(self, x):
        return torch.clamp_max(torch.exp(self.lam * x), 1.0)
