"""Dense layer and MLP conditioner (``nf_tpu/nets/mlp.py:24-134``).

``W @ x_t + b[:, None]`` stays ``torch.matmul``: a plain product that the
JAX package also leaves to the compiler.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import _dropout


class Linear(nn.Module):
    """Dense layer ``y = x @ W^T + b`` with the reference's init,
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, drawn from ``generator``."""

    def __init__(self, in_features, out_features, bias=True, generator=None,
                 init_zeros=False, dtype=torch.float32):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)

        def uniform(*shape):
            u = torch.rand(shape, generator=generator, dtype=dtype)
            return (2.0 * u - 1.0) * bound

        self.weight = nn.Parameter(uniform(out_features, in_features))
        self.bias = nn.Parameter(uniform(out_features)) if bias else None
        if init_zeros:
            with torch.no_grad():
                for p in self.parameters():
                    p.zero_()

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


def clamp_exp(x):
    """Nonlinearity ``min(exp(x), 1)`` (reference ``utils/nn.py:60``)."""
    return torch.clamp_max(torch.exp(x), 1.0)


_OUTPUT_FNS = {"sigmoid": torch.sigmoid, "relu": F.relu, "tanh": torch.tanh,
               "clampexp": clamp_exp}


class MLP(nn.Module):
    """Leaky-ReLU MLP with an optional zero-init last layer and output map
    (``nf_tpu/nets/mlp.py:88-134``; reference ``nets/mlp.py:5-58``).
    ``layers`` lists the widths; ``output_fn`` in {None, "sigmoid",
    "relu", "tanh", "clampexp"} is applied as ``output_scale *
    output_fn(score_scale * out)``.

    ``net`` is the reference's ``nn.Sequential``: a Linear at indices 0,
    2, 4, ... with a LeakyReLU after each but the last, and, when
    ``dropout`` is given, a slot before the last Linear that shifts it to
    an odd index, as the reference's ``nn.Dropout`` does
    (``nf_tpu/compat_export.py:95-103``). The slot drops the last hidden
    activations at probability ``dropout`` when ``forward`` gets a
    ``generator`` (``nf_tpu/nets/mlp.py:120-126``), and passes them
    through otherwise, as the JAX package does without a key."""

    def __init__(self, layers, leaky=0.0, score_scale=None, output_fn=None,
                 output_scale=None, init_zeros=False, dropout=None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if output_fn is not None and output_fn not in _OUTPUT_FNS:
            raise ValueError(f"unknown output_fn {output_fn!r}")
        n = len(layers) - 1
        mods = []
        for k in range(n):
            if k == n - 1 and dropout is not None:
                mods.append(_DropoutSlot(dropout))
            mods.append(Linear(layers[k], layers[k + 1], generator=generator,
                               init_zeros=init_zeros and k == n - 1,
                               dtype=dtype))
            if k < n - 1:
                mods.append(nn.LeakyReLU(leaky))
        self.net = nn.Sequential(*mods)
        self.score_scale = score_scale
        self.output_fn = output_fn
        self.output_scale = output_scale

    def forward(self, x, generator=None):
        for layer in self.net:
            x = layer(x, generator) if isinstance(layer, _DropoutSlot) \
                else layer(x)
        if self.output_fn is not None:
            if self.score_scale is not None:
                x = x * self.score_scale
            x = _OUTPUT_FNS[self.output_fn](x)
            if self.output_scale is not None:
                x = x * self.output_scale
        return x


class _DropoutSlot(nn.Module):
    """The reference's ``nn.Dropout`` position in ``MLP.net``: no
    parameters, so the last Linear keeps the reference's index; the
    mask's owner."""

    def __init__(self, probability):
        super().__init__()
        self.probability = probability

    def forward(self, x, generator=None):
        return _dropout.dropout(x, self.probability, generator, self)
