"""Autoregressive flows (``nf_tpu/flows/autoregressive.py``; reference
``normflows/flows/affine/autoregressive.py``): the base class, and the
masked affine autoregressive flow (MAF).

Forward is one pass of the autoregressive net; the inverse is D sequential
passes, each fixing one more feature (the MAF asymmetry, reference
``autoregressive.py:29-38``). The JAX package runs the D passes as a
``lax.scan``; here they are a Python loop over the same body.

``generator`` reaches the autoregressive net's dropout. The JAX package
hands the flow's one key to each of the D passes, so every pass drops the
same activations; here the passes run inside
:func:`~nf_tpu_torch.nets._dropout.shared_masks`, which draws each block's
mask once and reuses it, so the inverse inverts the forward under the same
draw.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..nets._dropout import shared_masks
from ..nets.made import MADE
from ..nets.precision import MixedPrecision
from .base import Flow


class Autoregressive(Flow):
    """Elementwise transform whose parameters come from an autoregressive
    net (reference ``autoregressive.py:10-47``)."""

    def __init__(self, autoregressive_net):
        super().__init__()
        self.autoregressive_net = autoregressive_net

    def _elementwise_forward(self, inputs, autoregressive_params):
        raise NotImplementedError()

    def _elementwise_inverse(self, inputs, autoregressive_params):
        raise NotImplementedError()

    def forward(self, inputs, context=None, generator=None):
        params = self.autoregressive_net(inputs, context,
                                         generator=generator)
        return self._elementwise_forward(inputs, params)

    def inverse(self, inputs, context=None, generator=None):
        """D passes from zeros, one dropout draw shared by all of them;
        returns the last pass's outputs and log-det, as the JAX
        ``lax.scan`` does."""
        outputs = torch.zeros_like(inputs)
        logabsdet = None
        with shared_masks():
            for _ in range(math.prod(inputs.shape[1:])):
                params = self.autoregressive_net(outputs, context,
                                                 generator=generator)
                outputs, logabsdet = self._elementwise_inverse(inputs,
                                                               params)
        return outputs, logabsdet


class MaskedAffineAutoregressive(Autoregressive):
    """Masked affine autoregressive flow (MAF, arXiv 1705.07057;
    ``nf_tpu/flows/autoregressive.py:54-113``; reference
    ``autoregressive.py:50-128``): a MADE with two outputs per feature
    gives the scale ``sigmoid(s + 2) + 1e-3`` and the shift. ``forward``
    (latent -> data, the sampling direction) is one MADE pass; ``inverse``
    (the density direction) is D passes. With the bin-major head (the
    default) the MADE emits ``(2*D, B)`` rows param-major, so the scale
    and shift are contiguous ``(D, B)`` planes. ``use_batch_norm`` is taken
    and ignored, as the JAX package's MADE ignores it."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_blocks=2, use_residual_blocks=True, random_mask=False,
                 activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False, mixed_precision=False,
                 bin_major_head=True, generator=None, dtype=torch.float32):
        made = MADE(features, hidden_features,
                    context_features=context_features, num_blocks=num_blocks,
                    output_multiplier=2,
                    use_residual_blocks=use_residual_blocks,
                    random_mask=random_mask, activation=activation,
                    dropout_probability=dropout_probability,
                    use_batch_norm=use_batch_norm,
                    bin_major_head=bin_major_head, generator=generator,
                    dtype=dtype)
        super().__init__(MixedPrecision(made) if mixed_precision else made)
        self.features = features

    def _scale_shift(self, params):
        if self.autoregressive_net.bin_major_head is not None:
            p = params.reshape(2, self.features, -1)
            unconstrained_scale, shift = p[0], p[1]
        else:
            p = params.reshape(-1, self.features, 2)
            unconstrained_scale, shift = p[..., 0], p[..., 1]
        return torch.sigmoid(unconstrained_scale + 2.0) + 1e-3, shift

    def _elementwise_forward(self, inputs, autoregressive_params):
        scale, shift = self._scale_shift(autoregressive_params)
        if self.autoregressive_net.bin_major_head is not None:
            return (scale * inputs.T + shift).T, \
                torch.sum(torch.log(scale), dim=0)
        return scale * inputs + shift, torch.sum(torch.log(scale), dim=1)

    def _elementwise_inverse(self, inputs, autoregressive_params):
        scale, shift = self._scale_shift(autoregressive_params)
        if self.autoregressive_net.bin_major_head is not None:
            return ((inputs.T - shift) / scale).T, \
                -torch.sum(torch.log(scale), dim=0)
        return (inputs - shift) / scale, -torch.sum(torch.log(scale), dim=1)
