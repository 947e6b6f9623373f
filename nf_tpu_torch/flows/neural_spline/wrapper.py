"""User-facing NSF layers: the coupling layers and the autoregressive ones
(``nf_tpu/flows/neural_spline/wrapper.py:60-240``; reference
``normflows/flows/neural_spline/wrapper.py``).

Direction convention (reference ``wrapper.py:79-85``): the flow's
``forward`` calls the spline coupling's *inverse* and vice versa.

``dropout_probability`` reaches every layer's conditioner, and the flow's
``generator`` reaches its dropout: the coupled layers pass it as the JAX
package's pass their key (``nf_tpu/flows/neural_spline/wrapper.py:
101-107,167-173``). The JAX package's autoregressive wrappers drop their
key (``wrapper.py:199-205,234-240``), so there a MADE's dropout never
draws; the port's pass the generator on, so that the
``dropout_probability`` both packages take acts in a keyed loss, as it
does in the MADE-spline layer the wrappers hold. At the builders' p = 0,
or without a generator, the two agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...nets.precision import MixedPrecision
from ...nets.resnet import ResidualNet
from ...ops.splines import DEFAULT_MIN_DERIVATIVE, linear_tail_constant
from ...utils.masks import create_alternating_binary_mask
from ...utils.nn import PeriodicFeaturesElementwise
from ..base import Flow
from .autoregressive import MaskedPiecewiseRationalQuadraticAutoregressive
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
    (reference ``wrapper.py:14-85``). ``mixed_precision=True`` wraps the
    conditioner in :class:`~nf_tpu_torch.nets.MixedPrecision` (bfloat16
    products; the fused head's trunk stays float32, as in the JAX
    package)."""

    def __init__(self, num_input_channels, num_blocks, num_hidden_channels,
                 num_context_channels=None, num_bins=8, tails="linear",
                 tail_bound=3.0, activation=F.relu, dropout_probability=0.0,
                 reverse_mask=False, init_identity=True,
                 mixed_precision=False, bin_major_head=True, generator=None,
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
                dropout_probability=dropout_probability,
                bin_major_head=head, generator=generator, dtype=dtype)
            if init_identity:
                net = _identity_init_resnet(net)
            if mixed_precision:
                net = MixedPrecision(net)
            return net

        self.prqct = PiecewiseRationalQuadraticCoupling(
            mask, transform_net_create_fn, num_bins=num_bins, tails=tails,
            tail_bound=tail_bound,
            # True corresponds to eqs (4)-(6) in the NSF paper
            apply_unconditional_transform=True, dtype=dtype)

    def forward(self, z, context=None, generator=None):
        z, log_det = self.prqct.inverse(z, context=context,
                                        generator=generator)
        return z, log_det.reshape(-1)

    def inverse(self, z, context=None, generator=None):
        z, log_det = self.prqct.forward(z, context=context,
                                        generator=generator)
        return z, log_det.reshape(-1)


class CircularCoupledRationalQuadraticSpline(Flow):
    """NSF coupling layer with circular coordinates
    (``nf_tpu/flows/neural_spline/wrapper.py:110-173``; reference
    ``wrapper.py:88-183``): circular tails on the features of
    ``ind_circ``, linear on the rest, and the conditioner sees the
    identity half's circular features as ``PeriodicFeaturesElementwise``
    (scale ``pi / tail_bound`` of each). ``mask`` overrides the
    alternating mask ``reverse_mask`` picks.

    Where the transformed half's tails are homogeneous (dim 2: the one
    transformed feature), the ResidualNet carries a bin-major head with
    the per-feature 3K+1 row count, and on CUDA at B*D >= 4096 the
    coupling takes kernel B (kernel E in the backward) at those tails,
    circular ones included; the identity half's CDF takes kernel A
    (kernel C)."""

    def __init__(self, num_input_channels, num_blocks, num_hidden_channels,
                 ind_circ, num_context_channels=None, num_bins=8,
                 tail_bound=3.0, activation=F.relu, dropout_probability=0.0,
                 reverse_mask=False, mask=None, init_identity=True,
                 mixed_precision=False, bin_major_head=True, generator=None,
                 dtype=torch.float32):
        super().__init__()
        if mask is None:
            mask = create_alternating_binary_mask(num_input_channels,
                                                  even=reverse_mask)
        mask = np.asarray(mask)
        identity_features, _ = split_mask(mask)
        ind_circ = [int(i) for i in ind_circ]
        ind_circ_id = [i for i, f in enumerate(identity_features)
                       if f in ind_circ]
        if np.isscalar(tail_bound):
            scale_pf = np.pi / tail_bound
        else:
            scale_pf = np.pi / np.asarray(tail_bound)[
                np.asarray(identity_features, dtype=np.int64)[ind_circ_id]]
        tails = ["circular" if i in ind_circ else "linear"
                 for i in range(num_input_channels)]
        head = _head_splits(mask, num_bins, tails) if bin_major_head \
            else None

        def transform_net_create_fn(in_features, out_features):
            pf = (PeriodicFeaturesElementwise(in_features, ind_circ_id,
                                              scale_pf, dtype=dtype)
                  if ind_circ_id else None)
            net = ResidualNet(
                in_features, out_features, num_hidden_channels,
                context_features=num_context_channels,
                num_blocks=num_blocks, activation=activation,
                dropout_probability=dropout_probability,
                bin_major_head=head, preprocessing=pf, generator=generator,
                dtype=dtype)
            if init_identity:
                net = _identity_init_resnet(net)
            if mixed_precision:
                net = MixedPrecision(net)
            return net

        self.prqct = PiecewiseRationalQuadraticCoupling(
            mask, transform_net_create_fn, num_bins=num_bins, tails=tails,
            tail_bound=tail_bound, apply_unconditional_transform=True,
            dtype=dtype)

    def forward(self, z, context=None, generator=None):
        z, log_det = self.prqct.inverse(z, context=context,
                                        generator=generator)
        return z, log_det.reshape(-1)

    def inverse(self, z, context=None, generator=None):
        z, log_det = self.prqct.forward(z, context=context,
                                        generator=generator)
        return z, log_det.reshape(-1)


class AutoregressiveRationalQuadraticSpline(Flow):
    """NSF autoregressive layer with linear tails (reference
    ``wrapper.py:186-244``). Its ``forward`` (latent -> data) is the
    MADE spline's inverse: D sequential MADE passes."""

    def __init__(self, num_input_channels, num_blocks, num_hidden_channels,
                 num_context_channels=None, num_bins=8, tail_bound=3.0,
                 activation=F.relu, dropout_probability=0.0,
                 permute_mask=False, init_identity=True,
                 mixed_precision=False, bin_major_head=True, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.mprqat = MaskedPiecewiseRationalQuadraticAutoregressive(
            num_input_channels, num_hidden_channels,
            context_features=num_context_channels, num_bins=num_bins,
            tails="linear", tail_bound=tail_bound, num_blocks=num_blocks,
            use_residual_blocks=True, random_mask=False,
            permute_mask=permute_mask, activation=activation,
            dropout_probability=dropout_probability,
            init_identity=init_identity, mixed_precision=mixed_precision,
            bin_major_head=bin_major_head, generator=generator, dtype=dtype)

    def forward(self, z, context=None, generator=None):
        z, log_det = self.mprqat.inverse(z, context=context,
                                         generator=generator)
        return z, log_det.reshape(-1)

    def inverse(self, z, context=None, generator=None):
        z, log_det = self.mprqat.forward(z, context=context,
                                         generator=generator)
        return z, log_det.reshape(-1)


class CircularAutoregressiveRationalQuadraticSpline(
        AutoregressiveRationalQuadraticSpline):
    """Circular NSF autoregressive layer (reference ``wrapper.py:247-311``):
    circular tails on the features in ``ind_circ``, linear on the rest,
    and periodic-feature preprocessing in the MADE."""

    def __init__(self, num_input_channels, num_blocks, num_hidden_channels,
                 ind_circ, num_context_channels=None, num_bins=8,
                 tail_bound=3.0, activation=F.relu, dropout_probability=0.0,
                 permute_mask=True, init_identity=True,
                 mixed_precision=False, bin_major_head=True, generator=None,
                 dtype=torch.float32):
        Flow.__init__(self)
        tails = ["circular" if i in ind_circ else "linear"
                 for i in range(num_input_channels)]
        self.mprqat = MaskedPiecewiseRationalQuadraticAutoregressive(
            num_input_channels, num_hidden_channels,
            context_features=num_context_channels, num_bins=num_bins,
            tails=tails, tail_bound=tail_bound, num_blocks=num_blocks,
            use_residual_blocks=True, random_mask=False,
            permute_mask=permute_mask, activation=activation,
            dropout_probability=dropout_probability,
            init_identity=init_identity, mixed_precision=mixed_precision,
            bin_major_head=bin_major_head, generator=generator, dtype=dtype)
