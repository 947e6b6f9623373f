"""User-facing NSF coupling layer
(``nf_tpu/flows/neural_spline/wrapper.py:60-107``; reference
``normflows/flows/neural_spline/wrapper.py``).

Direction convention (reference ``wrapper.py:79-85``): the flow's
``forward`` calls the spline coupling's *inverse* and vice versa.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...nets.resnet import ResidualNet
from ...ops.splines import DEFAULT_MIN_DERIVATIVE, linear_tail_constant
from ...utils.masks import create_alternating_binary_mask
from ..base import Flow
from .coupling import PiecewiseRationalQuadraticCoupling, split_mask


def _identity_init_resnet(net):
    """Zero head weight and slope-1 derivative bias: every spline starts as
    the identity."""
    with torch.no_grad():
        net.final_layer.weight.zero_()
        net.final_layer.bias.fill_(linear_tail_constant(
            DEFAULT_MIN_DERIVATIVE))
    return net


def _head_splits(mask, num_bins, tails):
    """(transform_features, mult) for a bin-major conditioner head, or None
    when the transform half's tails are mixed (generic feed only); the
    parameter-count rule of ``PiecewiseRationalQuadraticCoupling``."""
    _, transform_features = split_mask(mask)
    if isinstance(tails, (list, tuple)):
        tails_t = {tails[i] for i in transform_features}
        if not tails_t <= {"linear", "circular"}:
            return None
        mult = 3 * num_bins + 1
    elif tails == "linear":
        mult = 3 * num_bins - 1
    elif tails == "circular":
        mult = 3 * num_bins
    else:
        return None
    return (len(transform_features), mult)


class CoupledRationalQuadraticSpline(Flow):
    """NSF coupling layer with a ResidualNet conditioner
    (reference ``wrapper.py:14-85``)."""

    def __init__(self, num_input_channels, num_blocks, num_hidden_channels,
                 num_context_channels=None, num_bins=8, tails="linear",
                 tail_bound=3.0, activation=F.relu, reverse_mask=False,
                 init_identity=True, bin_major_head=True, generator=None,
                 dtype=torch.float32):
        super().__init__()
        mask = np.asarray(create_alternating_binary_mask(
            num_input_channels, even=reverse_mask))
        head = _head_splits(mask, num_bins, tails) if bin_major_head \
            else None

        def transform_net_create_fn(in_features, out_features):
            net = ResidualNet(
                in_features, out_features, num_hidden_channels,
                context_features=num_context_channels,
                num_blocks=num_blocks, activation=activation,
                bin_major_head=head, generator=generator, dtype=dtype)
            if init_identity:
                net = _identity_init_resnet(net)
            return net

        self.prqct = PiecewiseRationalQuadraticCoupling(
            mask, transform_net_create_fn, num_bins=num_bins, tails=tails,
            tail_bound=tail_bound,
            # True corresponds to eqs (4)-(6) in the NSF paper
            apply_unconditional_transform=True, dtype=dtype)

    def forward(self, z, context=None):
        z, log_det = self.prqct.inverse(z, context=context)
        return z, log_det.reshape(-1)

    def inverse(self, z, context=None):
        z, log_det = self.prqct.forward(z, context=context)
        return z, log_det.reshape(-1)
