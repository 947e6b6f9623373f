"""Residual conditioners (``nf_tpu/nets/resnet.py:59,130,214,258``;
reference ``normflows/nets/resnet.py``): the MLP ``ResidualNet`` and the
convolutional ``ConvResidualNet`` of the image NSF.

Pre-activation residual blocks with optional GLU-style context gating
(``h * sigmoid(W_ctx c)``). Module and parameter names follow the
reference (``initial_layer``, ``blocks.i.linear_layers.j`` or
``blocks.i.conv_layers.j``, ``context_layer``, ``final_layer``) so
reference state dicts load by name (``nf_tpu_torch.compat``), batch norm
under ``blocks.i.batch_norm_layers.j``.

``use_batch_norm=True`` normalises with the batch's statistics and a
learned affine, train mode always and no running statistics, eps 1e-3
(``nf_tpu/nets/resnet.py:26-57``). ``dropout_probability`` drops the
activations before each block's second product when the caller passes a
``generator`` (:func:`~nf_tpu_torch.nets._dropout.dropout`), one mask per
block in block order, as the JAX package folds its key in per block.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import _batch_stats, _dropout
from .cnn import Conv2d
from .mlp import Linear


class _BatchAffineNorm(nn.Module):
    """Batch-statistics normalisation with a learned affine
    (``nf_tpu/nets/resnet.py:26-46``): a BatchNorm that is always in
    train mode and keeps no running statistics; the variance is the
    biased one, eps 1e-3. ``weight`` and ``bias`` are the reference's
    names for JAX's ``gamma`` and ``beta``. On ``(B, F)`` it reduces over
    the batch, on ``(B, C, H, W)`` over all but the channels, and
    :meth:`transposed` over the batch of feature-major ``(F, B)`` data;
    inside a sharded step over the global batch
    (``nets/_batch_stats.py``)."""

    def __init__(self, features, eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))

    def _normalize(self, x, dims):
        shared = _batch_stats.moments(x, dims, 0)
        if shared is None:
            mean = torch.mean(x, dim=dims, keepdim=True)
            var = torch.var(x, dim=dims, keepdim=True, correction=0)
        else:  # the global batch of a sharded step (nets/_batch_stats.py)
            mean, var = shared
        return (x - mean) * torch.rsqrt(var + self.eps)

    def forward(self, x):
        if x.ndim == 2:
            return self._normalize(x, (0,)) * self.weight + self.bias
        return (self._normalize(x, (0, 2, 3)) * self.weight[:, None, None]
                + self.bias[:, None, None])

    def transposed(self, x_t):
        """``_bn_t`` (``resnet.py:49-56``): the batch on axis 1, the
        affine broadcast over it."""
        return (self._normalize(x_t, (1,)) * self.weight[:, None]
                + self.bias[:, None])


def _batch_norms(use_batch_norm, features, dtype):
    return (nn.ModuleList([_BatchAffineNorm(features, dtype=dtype)
                           for _ in range(2)])
            if use_batch_norm else None)


def _norm(block, i, temps, transposed=False):
    """``block``'s i-th batch norm applied to ``temps``, or ``temps``
    without batch norm."""
    if block.batch_norm_layers is None:
        return temps
    bn = block.batch_norm_layers[i]
    return bn.transposed(temps) if transposed else bn(temps)


class ResidualBlock(nn.Module):
    """Pre-activation residual block (reference ``resnet.py:7-51``)."""

    def __init__(self, features, context_features=None,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False, generator=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.dropout_probability = dropout_probability
        self.batch_norm_layers = _batch_norms(use_batch_norm, features, dtype)
        self.linear_layers = nn.ModuleList([
            Linear(features, features, generator=generator, dtype=dtype),
            Linear(features, features, generator=generator, dtype=dtype)])
        _small_uniform(self.linear_layers[1], generator, dtype)
        self.context_layer = (
            Linear(context_features, features, generator=generator,
                   dtype=dtype)
            if context_features is not None else None)

    def forward(self, inputs, context=None, generator=None):
        temps = self.activation(_norm(self, 0, inputs))
        temps = self.linear_layers[0](temps)
        temps = self.activation(_norm(self, 1, temps))
        temps = _dropout.dropout(temps, self.dropout_probability, generator,
                                 self)
        temps = self.linear_layers[1](temps)
        if context is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(self.context_layer(context))
        return inputs + temps

    def call_transposed(self, inputs_t, context_t=None, generator=None):
        """The same block on feature-major ``(features, batch)``
        activations; every matmul goes through ``Linear.matmul_t``, batch
        norm reduces over axis 1, and the dropout mask is drawn in the
        ``(features, batch)`` shape."""
        temps = self.activation(_norm(self, 0, inputs_t, True))
        temps = self.linear_layers[0].matmul_t(temps)
        temps = self.activation(_norm(self, 1, temps, True))
        temps = _dropout.dropout(temps, self.dropout_probability, generator,
                                 self)
        temps = self.linear_layers[1].matmul_t(temps)
        if context_t is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(
                self.context_layer.matmul_t(context_t))
        return inputs_t + temps


class ResidualNet(nn.Module):
    """Residual MLP conditioner (reference ``resnet.py:54-104``).

    ``bin_major_head``: None, or ``(features, mult)``. The head then emits
    its output TRANSPOSED, ``(out, batch)``, with rows ordered param-major
    (row ``p*D + d``), which is the spline kernels' ``(K, N)`` plane
    layout. The reference orders rows feature-major (row ``d*mult + p``);
    ``compat.load_reference_state_dict`` permutes the final layer's rows.

    ``preprocessing``: a module applied to the inputs before the trunk
    (``nf_tpu/nets/resnet.py:179-180``; the circular coupling's
    ``PeriodicFeaturesElementwise``), in ``forward`` and in
    ``features_transposed`` alike; ``in_features`` counts its outputs.
    """

    def __init__(self, in_features, out_features, hidden_features,
                 context_features=None, num_blocks=2,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False,
                 bin_major_head: Optional[tuple] = None,
                 preprocessing: Optional[nn.Module] = None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.preprocessing = preprocessing
        if bin_major_head is not None:
            feats, mult = bin_major_head
            if feats * mult != out_features:
                raise ValueError(
                    f"bin_major_head {bin_major_head} does not factor "
                    f"out_features={out_features}")
            bin_major_head = (int(feats), int(mult))
        self.hidden_features = hidden_features
        self.context_features = context_features
        self.bin_major_head = bin_major_head
        in_total = in_features + (context_features or 0)
        self.initial_layer = Linear(in_total, hidden_features,
                                    generator=generator, dtype=dtype)
        self.blocks = nn.ModuleList([
            ResidualBlock(hidden_features, context_features, activation,
                          dropout_probability, use_batch_norm,
                          generator=generator, dtype=dtype)
            for _ in range(num_blocks)])
        self.final_layer = Linear(hidden_features, out_features,
                                  generator=generator, dtype=dtype)

    def forward(self, inputs, context=None, generator=None):
        temps = inputs if self.preprocessing is None \
            else self.preprocessing(inputs)
        if context is not None:
            temps = torch.cat([temps, context], dim=1)
        temps = self.initial_layer(temps)
        for block in self.blocks:
            temps = block(temps, context=context, generator=generator)
        if self.bin_major_head is not None:
            return self.final_layer.call_transposed(temps)
        return self.final_layer(temps)

    def features_transposed(self, inputs, context=None, generator=None):
        """Hidden activations before the final layer, feature-major
        ``(hidden, batch)``: the trunk runs transposed, and the fused
        head+spline kernel (``ops.spline_head_fused``) computes the final
        layer's product itself. The preprocessing (periodic features of
        a circular coupling's angles) runs on the ``(batch, features)``
        input, before the one small transpose."""
        temps = inputs if self.preprocessing is None \
            else self.preprocessing(inputs)
        temps_t = temps.T
        context_t = context.T if context is not None else None
        if context_t is not None:
            temps_t = torch.cat([temps_t, context_t], dim=0)
        temps_t = self.initial_layer.matmul_t(temps_t)
        for block in self.blocks:
            temps_t = block.call_transposed(temps_t, context_t,
                                            generator=generator)
        return temps_t


def _small_uniform(module, generator, dtype):
    """The reference's zero_initialization: ``module``'s parameters drawn
    from U(-1e-3, 1e-3), so a residual block starts near the identity."""
    with torch.no_grad():
        for p in module.parameters():
            u = torch.rand(p.shape, generator=generator, dtype=dtype)
            p.copy_((2.0 * u - 1.0) * 1e-3)


class ConvResidualBlock(nn.Module):
    """Pre-activation convolutional residual block (``resnet.py:214-255``;
    reference ``resnet.py:107-156``): two 3x3 convolutions, the second
    near zero at init, and an optional 1x1 context gate."""

    def __init__(self, channels, context_channels=None,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False, generator=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.dropout_probability = dropout_probability
        self.batch_norm_layers = _batch_norms(use_batch_norm, channels, dtype)
        self.conv_layers = nn.ModuleList([
            Conv2d(channels, channels, 3, generator=generator, dtype=dtype)
            for _ in range(2)])
        _small_uniform(self.conv_layers[1], generator, dtype)
        self.context_layer = (
            Conv2d(context_channels, channels, 1, generator=generator,
                   dtype=dtype)
            if context_channels is not None else None)

    def forward(self, inputs, context=None, generator=None):
        temps = self.activation(_norm(self, 0, inputs))
        temps = self.conv_layers[0](temps)
        temps = self.activation(_norm(self, 1, temps))
        temps = _dropout.dropout(temps, self.dropout_probability, generator,
                                 self)
        temps = self.conv_layers[1](temps)
        if context is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(self.context_layer(context))
        return inputs + temps


class ConvResidualNet(nn.Module):
    """The image NSF's conditioner (``resnet.py:258-300``; reference
    ``resnet.py:159-209``): a 1x1 convolution to ``hidden_channels``,
    ``num_blocks`` residual blocks, a 1x1 convolution out. The coupling
    reads ``hidden_channels`` for its softmax scale."""

    def __init__(self, in_channels, out_channels, hidden_channels,
                 context_channels=None, num_blocks=2,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False, generator=None, dtype=torch.float32):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.context_channels = context_channels
        self.initial_layer = Conv2d(in_channels + (context_channels or 0),
                                    hidden_channels, 1, generator=generator,
                                    dtype=dtype)
        self.blocks = nn.ModuleList([
            ConvResidualBlock(hidden_channels, context_channels, activation,
                              dropout_probability, use_batch_norm,
                              generator=generator, dtype=dtype)
            for _ in range(num_blocks)])
        self.final_layer = Conv2d(hidden_channels, out_channels, 1,
                                  generator=generator, dtype=dtype)

    def forward(self, inputs, context=None, generator=None):
        temps = inputs if context is None else torch.cat([inputs, context],
                                                         dim=1)
        temps = self.initial_layer(temps)
        for block in self.blocks:
            temps = block(temps, context=context, generator=generator)
        return self.final_layer(temps)
