"""MADE, the masked autoregressive conditioner (``nf_tpu/nets/made.py``;
reference ``normflows/nets/made.py``).

Degrees are worked out at construction time in numpy; at run time a masked
linear is one dense product with a constant 0/1 mask. Output degrees tile
the input degrees: feature d's ``output_multiplier`` parameters are
contiguous (feature-major), or, with ``bin_major_head``, all features' p-th
parameters are (param-major), the spline kernels' ``(K, N)`` plane order.
Module and buffer names are the reference's (``initial_layer``,
``blocks.i.linear_layers.j``, ``final_layer``, ``mask``, ``degrees``), so
reference state dicts load by name (``nf_tpu_torch.compat``), masks
included: a mask drawn with ``permute_mask`` comes across from the state
dict, since a ``torch.Generator`` cannot redraw a JAX permutation.

There is no ``features_transposed``: the fused head+spline kernel (B)
needs a transposed trunk, and the JAX package's MADE has none either, so
an autoregressive layer always feeds kernel A.

``dropout_probability`` drops each block's activations (a feed-forward
block's output, a residual block's before its second product) when the
caller passes a ``generator`` (:func:`~nf_tpu_torch.nets._dropout.dropout`,
``nf_tpu/nets/made.py:129-132,186-189``). ``use_batch_norm`` is taken and
ignored, as the JAX package's blocks take it and build no norm
(``made.py:116-125,151-180``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _dropout
from .mlp import Linear


def _input_degrees(in_features):
    return np.arange(1, in_features + 1)


def _hidden_degrees(in_degrees, out_features, autoregressive_features,
                    random_mask, generator):
    if random_mask:
        min_in = int(min(np.min(in_degrees), autoregressive_features - 1))
        return torch.randint(min_in, autoregressive_features, (out_features,),
                             generator=generator).numpy()
    max_ = max(1, autoregressive_features - 1)
    min_ = min(1, autoregressive_features - 1)
    return np.arange(out_features) % max_ + min_


def _output_degrees(in_degrees, out_features, autoregressive_features,
                    bin_major=False):
    mult = out_features // autoregressive_features
    if bin_major:
        return np.tile(in_degrees, mult)
    return np.repeat(in_degrees, mult)


class MaskedLinear(Linear):
    """Dense layer with a fixed autoregressive 0/1 mask (reference
    ``made.py:19-81``); buffers ``mask`` (out, in) and ``degrees`` (out,),
    and ``out_degrees``, a numpy copy of the degrees that reads the same on
    any device (``meta`` included): taken at construction, and again from
    every state dict loaded into the layer."""

    def __init__(self, in_degrees, out_features, autoregressive_features,
                 random_mask=False, is_output=False, bias=True,
                 out_degrees_=None, bin_major=False, generator=None,
                 dtype=torch.float32):
        in_degrees = np.asarray(in_degrees)
        if is_output:
            if out_degrees_ is None:
                out_degrees_ = _input_degrees(autoregressive_features)
            out_degrees = _output_degrees(np.asarray(out_degrees_),
                                          out_features,
                                          autoregressive_features,
                                          bin_major=bin_major)
            mask = out_degrees[:, None] > in_degrees
        else:
            out_degrees = _hidden_degrees(in_degrees, out_features,
                                          autoregressive_features,
                                          random_mask, generator)
            mask = out_degrees[:, None] >= in_degrees
        super().__init__(len(in_degrees), out_features, bias=bias,
                         generator=generator, dtype=dtype)
        self.register_buffer("mask", torch.from_numpy(mask.astype(
            np.float32)).to(dtype))
        self.out_degrees = np.asarray(out_degrees, np.int64)
        self.register_buffer("degrees", torch.from_numpy(
            self.out_degrees.copy()))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        degrees = state_dict.get(prefix + "degrees")
        if degrees is not None and not degrees.is_meta:
            self.out_degrees = degrees.detach().cpu().numpy().astype(np.int64)

    def forward(self, x):
        y = torch.matmul(x, (self.weight * self.mask).T)
        if self.bias is not None:
            y = y + self.bias
        return y

    def call_transposed(self, x):
        """``y^T = (W*mask) @ x^T`` -> ``(out, batch)``."""
        y = torch.matmul(self.weight * self.mask, x.T)
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y


class MaskedFeedforwardBlock(nn.Module):
    """Masked linear + activation (reference ``made.py:84-141``)."""

    def __init__(self, in_degrees, autoregressive_features,
                 context_features=None, random_mask=False,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False, generator=None, dtype=torch.float32):
        super().__init__()
        if context_features is not None:
            raise NotImplementedError()
        self.dropout_probability = dropout_probability
        self.linear = MaskedLinear(
            in_degrees, len(np.asarray(in_degrees)), autoregressive_features,
            random_mask=random_mask, is_output=False, generator=generator,
            dtype=dtype)
        self.activation = activation

    @property
    def out_degrees(self):
        return self.linear.out_degrees

    def forward(self, inputs, context=None, generator=None):
        return _dropout.dropout(self.activation(self.linear(inputs)),
                                self.dropout_probability, generator, self)


class MaskedResidualBlock(nn.Module):
    """Residual block of two masked linears (reference
    ``made.py:144-214``); the second starts near zero
    (``zero_initialization``)."""

    def __init__(self, in_degrees, autoregressive_features,
                 context_features=None, random_mask=False,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False, zero_initialization=True,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if random_mask:
            raise ValueError(
                "Masked residual block can't be used with random masks.")
        self.dropout_probability = dropout_probability
        in_degrees = np.asarray(in_degrees)
        features = len(in_degrees)
        l0 = MaskedLinear(in_degrees, features, autoregressive_features,
                          generator=generator, dtype=dtype)
        l1 = MaskedLinear(l0.out_degrees, features,
                          autoregressive_features, generator=generator,
                          dtype=dtype)
        if not np.all(l1.out_degrees >= in_degrees):
            raise RuntimeError(
                "In a masked residual block, the output degrees can't be"
                " less than the corresponding input degrees.")
        if zero_initialization:
            with torch.no_grad():
                for p in l1.parameters():
                    u = torch.rand(p.shape, generator=generator, dtype=dtype)
                    p.copy_((2.0 * u - 1.0) * 1e-3)
        self.linear_layers = nn.ModuleList([l0, l1])
        self.context_layer = (
            Linear(context_features, features, generator=generator,
                   dtype=dtype)
            if context_features is not None else None)
        self.activation = activation

    @property
    def out_degrees(self):
        return self.linear_layers[1].out_degrees

    def forward(self, inputs, context=None, generator=None):
        temps = self.activation(inputs)
        temps = self.linear_layers[0](temps)
        temps = self.activation(temps)
        temps = _dropout.dropout(temps, self.dropout_probability, generator,
                                 self)
        temps = self.linear_layers[1](temps)
        if context is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(self.context_layer(context))
        return inputs + temps


class MADE(nn.Module):
    """Masked autoregressive density estimator (reference
    ``made.py:217-304``); context is added after the initial layer.

    ``bin_major_head``: the final masked product emits TRANSPOSED
    ``(out, batch)`` output with rows ordered param-major (row ``p*D +
    d``), and ``self.bin_major_head`` is ``(features, output_multiplier)``;
    the reference orders rows feature-major (row ``d*mult + p``), and
    ``compat.load_reference_state_dict`` permutes the final layer's
    weight, bias and mask rows."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_blocks=2, output_multiplier=1, use_residual_blocks=True,
                 random_mask=False, permute_mask=False,
                 activation: Callable = F.relu, dropout_probability=0.0,
                 use_batch_norm=False,
                 preprocessing: Optional[nn.Module] = None,
                 bin_major_head=False, generator=None, dtype=torch.float32):
        super().__init__()
        if use_residual_blocks and random_mask:
            raise ValueError("Residual blocks can't be used with random "
                             "masks.")
        input_degrees_ = _input_degrees(features)
        if permute_mask:
            perm = torch.randperm(features, generator=generator).numpy()
            input_degrees_ = input_degrees_[perm]
        self.preprocessing = preprocessing
        self.initial_layer = MaskedLinear(
            input_degrees_, hidden_features, features,
            random_mask=random_mask, is_output=False, generator=generator,
            dtype=dtype)
        self.context_layer = (
            Linear(context_features, hidden_features, generator=generator,
                   dtype=dtype)
            if context_features is not None else None)
        block = (MaskedResidualBlock if use_residual_blocks
                 else MaskedFeedforwardBlock)
        blocks = []
        prev = self.initial_layer.out_degrees
        for _ in range(num_blocks):
            blk = block(prev, features, context_features=context_features,
                        random_mask=random_mask, activation=activation,
                        dropout_probability=dropout_probability,
                        use_batch_norm=use_batch_norm, generator=generator,
                        dtype=dtype)
            blocks.append(blk)
            prev = blk.out_degrees
        self.blocks = nn.ModuleList(blocks)
        self.final_layer = MaskedLinear(
            prev, features * output_multiplier, features,
            random_mask=random_mask, is_output=True,
            out_degrees_=input_degrees_, bin_major=bool(bin_major_head),
            generator=generator, dtype=dtype)
        self.bin_major_head = ((features, output_multiplier)
                               if bin_major_head else None)

    def forward(self, inputs, context=None, generator=None):
        out = inputs if self.preprocessing is None \
            else self.preprocessing(inputs)
        out = self.initial_layer(out)
        if context is not None and self.context_layer is not None:
            out = out + self.context_layer(context)
        for block in self.blocks:
            out = block(out, context=context, generator=generator)
        if self.bin_major_head is not None:
            return self.final_layer.call_transposed(out)
        return self.final_layer(out)
