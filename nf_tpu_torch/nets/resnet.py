"""Residual MLP conditioner (``nf_tpu/nets/resnet.py:59,130``; reference
``normflows/nets/resnet.py``).

Pre-activation residual blocks with optional GLU-style context gating
(``h * sigmoid(W_ctx c)``). Module and parameter names follow the
reference (``initial_layer``, ``blocks.i.linear_layers.j``,
``context_layer``, ``final_layer``) so reference state dicts load by name
(``nf_tpu_torch.compat``). Batch norm and dropout are not ported: the
JAX package's builders make these nets without batch norm, and its
dropout needs a training-step key the serving path never passes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import Linear


class ResidualBlock(nn.Module):
    """Pre-activation residual block (reference ``resnet.py:7-51``)."""

    def __init__(self, features, context_features=None,
                 activation: Callable = F.relu, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.linear_layers = nn.ModuleList([
            Linear(features, features, generator=generator, dtype=dtype),
            Linear(features, features, generator=generator, dtype=dtype)])
        # the reference's zero_initialization: the block starts near the
        # identity, its second layer drawn from U(-1e-3, 1e-3)
        with torch.no_grad():
            for p in self.linear_layers[1].parameters():
                u = torch.rand(p.shape, generator=generator, dtype=dtype)
                p.copy_((2.0 * u - 1.0) * 1e-3)
        self.context_layer = (
            Linear(context_features, features, generator=generator,
                   dtype=dtype)
            if context_features is not None else None)

    def forward(self, inputs, context=None):
        temps = self.activation(inputs)
        temps = self.linear_layers[0](temps)
        temps = self.activation(temps)
        temps = self.linear_layers[1](temps)
        if context is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(self.context_layer(context))
        return inputs + temps

    def call_transposed(self, inputs_t, context_t=None):
        """The same block on feature-major ``(features, batch)``
        activations; every matmul goes through ``Linear.matmul_t``."""
        temps = self.activation(inputs_t)
        temps = self.linear_layers[0].matmul_t(temps)
        temps = self.activation(temps)
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
    """

    def __init__(self, in_features, out_features, hidden_features,
                 context_features=None, num_blocks=2,
                 activation: Callable = F.relu,
                 bin_major_head: Optional[tuple] = None, generator=None,
                 dtype=torch.float32):
        super().__init__()
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
                          generator=generator, dtype=dtype)
            for _ in range(num_blocks)])
        self.final_layer = Linear(hidden_features, out_features,
                                  generator=generator, dtype=dtype)

    def forward(self, inputs, context=None):
        temps = inputs
        if context is not None:
            temps = torch.cat([temps, context], dim=1)
        temps = self.initial_layer(temps)
        for block in self.blocks:
            temps = block(temps, context=context)
        if self.bin_major_head is not None:
            return self.final_layer.call_transposed(temps)
        return self.final_layer(temps)

    def features_transposed(self, inputs, context=None):
        """Hidden activations before the final layer, feature-major
        ``(hidden, batch)``: the trunk runs transposed, and the fused
        head+spline kernel (``ops.spline_head_fused``) computes the final
        layer's product itself."""
        temps_t = inputs.T
        context_t = context.T if context is not None else None
        if context_t is not None:
            temps_t = torch.cat([temps_t, context_t], dim=0)
        temps_t = self.initial_layer.matmul_t(temps_t)
        for block in self.blocks:
            temps_t = block.call_transposed(temps_t, context_t)
        return temps_t
