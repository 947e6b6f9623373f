"""Autoregressive flows (``nf_tpu/flows/autoregressive.py``; reference
``normflows/flows/affine/autoregressive.py``).

Forward is one pass of the autoregressive net; the inverse is D sequential
passes, each fixing one more feature (the MAF asymmetry, reference
``autoregressive.py:29-38``). The JAX package runs the D passes as a
``lax.scan``; here they are a Python loop over the same body.
"""

from __future__ import annotations

import math

import torch

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

    def forward(self, inputs, context=None):
        params = self.autoregressive_net(inputs, context)
        return self._elementwise_forward(inputs, params)

    def inverse(self, inputs, context=None):
        """D passes from zeros; returns the last pass's outputs and
        log-det, as the JAX ``lax.scan`` does."""
        outputs = torch.zeros_like(inputs)
        logabsdet = None
        for _ in range(math.prod(inputs.shape[1:])):
            params = self.autoregressive_net(outputs, context)
            outputs, logabsdet = self._elementwise_inverse(inputs, params)
        return outputs, logabsdet
