"""Convolutional conditioners (``nf_tpu/nets/cnn.py:16-113``; reference
``normflows/nets/cnn.py``), NCHW with OIHW weights.

Convolutions are cuDNN's, as the JAX package leaves them to XLA, and they
compute in float32 whatever ``torch.backends.cudnn.allow_tf32`` says (its
default, True, would run every float32 convolution in TF32, with about
three decimal digits), and by deterministic algorithms, as XLA's are
(cuDNN's default may pick a backward that sums with atomics, and then no
two training runs, eager or graphed, agree bit for bit): :func:`conv2d`
sets ``allow_tf32 = False`` and ``deterministic = True`` around the
forward and the backward convolutions of a CUDA tensor and puts both
back. A bfloat16 conditioner (``MixedPrecision``) is the one
lower-precision route, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable


@contextlib.contextmanager
def _float32_convs(x):
    """cuDNN convolutions in full float32, by deterministic algorithms,
    while the block runs (CUDA only; the CPU's are both already)."""
    if not x.is_cuda:
        yield
        return
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before


class _Conv2d(torch.autograd.Function):
    """A stride-1 same-padded convolution whose backward convolutions run
    under the same flags as its forward (autograd's own backward would
    read the process-wide flag when it runs)."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        ctx.has_bias = bias is not None
        with _float32_convs(x):
            return F.conv2d(x, weight, bias, padding=padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        p = ctx.padding
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with _float32_convs(x):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, weight, [weight.shape[0]] if ctx.has_bias else None,
                [1, 1], [p, p], [1, 1], False, [0, 0], 1, mask)
        return gx, gw, gb if ctx.has_bias else None, None


def conv2d(x, weight, bias=None):
    """Same-padded stride-1 ``F.conv2d``, forward and backward in the
    dtype of ``x`` (float32: never TF32) and deterministic."""
    return _Conv2d.apply(x, weight, bias, weight.shape[-1] // 2)


class Conv2d(nn.Module):
    """Same-padded 2D convolution (``cnn.py:16-55``): ``weight`` (out, in,
    k, k) and ``bias`` (out,), drawn from ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))`` (``N(0, weight_std²)`` for the weight when given;
    zeros with ``init_zeros``)."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True,
                 init_zeros=False, weight_std=None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        shape = (out_channels, in_channels, kernel_size, kernel_size)
        bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)

        def uniform(*s):
            u = torch.rand(s, generator=generator, dtype=dtype)
            return (2.0 * u - 1.0) * bound

        if init_zeros:
            weight = torch.zeros(shape, dtype=dtype)
        elif weight_std is not None:
            weight = weight_std * torch.randn(shape, generator=generator,
                                              dtype=dtype)
        else:
            weight = uniform(*shape)
        self.weight = nn.Parameter(weight)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(
                torch.zeros(out_channels, dtype=dtype) if init_zeros
                else uniform(out_channels))

    def forward(self, x):
        return conv2d(x, self.weight, self.bias)


class _NetActNorm(nn.Module):
    """The ActNorm between ``ConvNet2d`` layers (``cnn.py:58-72``;
    reference ``utils/nn.py:27-43``): a per-channel ``x * exp(s) + t``,
    forward only, no data-dependent initialisation (as in the JAX
    package)."""

    def __init__(self, shape, dtype=torch.float32):
        super().__init__()
        self.s = nn.Parameter(torch.zeros((1,) + tuple(shape), dtype=dtype))
        self.t = nn.Parameter(torch.zeros((1,) + tuple(shape), dtype=dtype))

    def forward(self, x):
        return x * torch.exp(self.s) + self.t


class ConvNet2d(nn.Module):
    """Glow's coupling conditioner (``cnn.py:75-113``; reference
    ``nets/cnn.py:5-63``): convolutions with LeakyReLU between them, the
    last one zero-initialised (``init_zeros``), with an optional ActNorm
    after each inner convolution (those then have no bias).
    ``channels`` lists the input channels first; ``kernel_size`` gives
    each layer's kernel (Glow's (3, 1, 3)). The layers sit in ``net`` at
    the reference's ``nn.Sequential`` indices (convolutions at 0, 2, 4
    without ActNorms), the names the weight bridge reads."""

    def __init__(self, channels, kernel_size, leaky=0.0, init_zeros=True,
                 actnorm=False, weight_std=None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        n = len(kernel_size)
        layers = []
        for i in range(n - 1):
            layers.append(Conv2d(channels[i], channels[i + 1],
                                 kernel_size[i], bias=not actnorm,
                                 weight_std=weight_std, generator=generator,
                                 dtype=dtype))
            if actnorm:
                layers.append(_NetActNorm((channels[i + 1], 1, 1), dtype))
            layers.append(nn.LeakyReLU(leaky))
        layers.append(Conv2d(channels[n - 1], channels[n], kernel_size[-1],
                             init_zeros=init_zeros, generator=generator,
                             dtype=dtype))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)
