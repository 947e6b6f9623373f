"""MADE-conditioned RQ-spline autoregressive flow
(``nf_tpu/flows/neural_spline/autoregressive.py``; reference
``normflows/flows/neural_spline/autoregressive.py``).

Every spline of this layer goes through the standalone spline (kernel A
on CUDA, backward C or D): MADE has no transposed trunk, so the fused
head+spline kernel B never takes it. With ``bin_major_head`` the MADE head
emits ``(mult*D, B)`` rows param-major, views of the kernels' ``(K, N)``
planes, fed by the coupling's ``feed.kmajor_spline_feed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...nets.made import MADE
from ...nets.precision import MixedPrecision
from ...ops import rational_quadratic_spline, splines
from ...ops import unconstrained_rational_quadratic_spline
from ...utils.nn import PeriodicFeaturesElementwise, sum_except_batch
from ..autoregressive import Autoregressive
from .coupling import _tail_bound_tensor
from .feed import kmajor_spline_feed


class MaskedPiecewiseRationalQuadraticAutoregressive(Autoregressive):
    """RQ-spline autoregressive transform, with circular coordinates
    through periodic-feature preprocessing (reference
    ``neural_spline/autoregressive.py:17-134``). ``tails``: None (the
    spline on [0, 1], no tails), 'linear', 'circular', or a per-feature
    list of those two; ``tail_bound`` a float or one per feature.
    ``mixed_precision=True`` runs the MADE in bfloat16
    (:class:`~nf_tpu_torch.nets.MixedPrecision`). ``dropout_probability``
    drops the MADE's activations under a ``generator``, one draw shared by
    the inverse's D passes; ``use_batch_norm`` is ignored, as in the JAX
    package."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_bins=10, tails=None, tail_bound=1.0, num_blocks=2,
                 use_residual_blocks=True, random_mask=False,
                 permute_mask=False, activation=F.relu,
                 dropout_probability=0.0, use_batch_norm=False,
                 init_identity=True,
                 min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.DEFAULT_MIN_DERIVATIVE,
                 mixed_precision=False, bin_major_head=False, generator=None,
                 dtype=torch.float32):
        if tails == "linear":
            mult = num_bins * 3 - 1
        elif tails == "circular":
            mult = num_bins * 3
        else:  # None, or per-feature tails
            mult = num_bins * 3 + 1

        preprocessing = None
        if isinstance(tails, (list, tuple)):
            ind_circ = [i for i in range(features) if tails[i] == "circular"]
            if np.isscalar(tail_bound):
                scale_pf = np.pi / tail_bound
            else:
                scale_pf = np.pi / np.asarray(tail_bound)[ind_circ]
            preprocessing = PeriodicFeaturesElementwise(
                features, ind_circ, scale_pf, dtype=dtype)

        if bin_major_head and not (
                tails in ("linear", "circular")
                or (isinstance(tails, (list, tuple))
                    and set(tails) <= {"linear", "circular"})):
            bin_major_head = False  # no tails (None): the bin-minor feed
        made = MADE(features, hidden_features,
                    context_features=context_features, num_blocks=num_blocks,
                    output_multiplier=mult,
                    use_residual_blocks=use_residual_blocks,
                    random_mask=random_mask, permute_mask=permute_mask,
                    activation=activation,
                    dropout_probability=dropout_probability,
                    use_batch_norm=use_batch_norm,
                    preprocessing=preprocessing,
                    bin_major_head=bin_major_head, generator=generator,
                    dtype=dtype)
        if init_identity:
            # every spline starts as the identity (reference
            # ``autoregressive.py:72-77``)
            with torch.no_grad():
                made.final_layer.weight.zero_()
                made.final_layer.bias.fill_(
                    splines.linear_tail_constant(min_derivative))
        if mixed_precision:
            made = MixedPrecision(made)
        super().__init__(made)

        tb_arr = _tail_bound_tensor(tail_bound, dtype)
        self.register_buffer("tail_bound_arr", tb_arr, persistent=False)
        self.tail_bound = 1.0 if tb_arr is not None else float(tail_bound)
        self.features = features
        self.num_bins = num_bins
        self.tails = tuple(tails) if isinstance(tails, (list, tuple)) \
            else tails
        self.softmax_scale = 1.0 / math.sqrt(hidden_features)
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative

    def _elementwise(self, inputs, autoregressive_params, inverse):
        kw = dict(inverse=inverse, min_bin_width=self.min_bin_width,
                  min_bin_height=self.min_bin_height,
                  min_derivative=self.min_derivative)
        batch = inputs.shape[0]
        tb = self.tail_bound_arr if self.tail_bound_arr is not None \
            else self.tail_bound
        if self.autoregressive_net.bin_major_head is not None:
            planes = autoregressive_params.reshape(-1, self.features, batch)
            return kmajor_spline_feed(
                inputs, planes, num_bins=self.num_bins, tails=self.tails,
                tail_bound=self.tail_bound,
                tail_bound_arr=self.tail_bound_arr,
                softmax_scale=self.softmax_scale, **kw)
        K = self.num_bins
        p = autoregressive_params.reshape(batch, self.features, -1)
        uw = p[..., :K] * self.softmax_scale
        uh = p[..., K:2 * K] * self.softmax_scale
        ud = p[..., 2 * K:]
        if self.tails is None:
            outputs, logabsdet = rational_quadratic_spline(
                inputs, uw, uh, ud, **kw)
        else:
            tails = list(self.tails) if isinstance(self.tails, tuple) \
                else self.tails
            outputs, logabsdet = unconstrained_rational_quadratic_spline(
                inputs, uw, uh, ud, tails=tails, tail_bound=tb, **kw)
        return outputs, sum_except_batch(logabsdet)

    def _elementwise_forward(self, inputs, autoregressive_params):
        return self._elementwise(inputs, autoregressive_params, False)

    def _elementwise_inverse(self, inputs, autoregressive_params):
        return self._elementwise(inputs, autoregressive_params, True)
