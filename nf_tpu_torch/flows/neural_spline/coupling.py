"""Neural-spline coupling layers (``nf_tpu/flows/neural_spline/coupling.py``;
reference ``normflows/flows/neural_spline/coupling.py``).

The identity/transform split uses index buffers named as the reference
names them (``identity_features``, ``transform_features``), on 2D
``(B, D)`` inputs and on 4D ``(B, C, H, W)`` images (the channels split).
An image coupling feeds the spline bin-major: its conditioner's ``(B,
C*P, H, W)`` output viewed as ``(P, B, C, H, W)`` planes, which kernel A
(and kernel C in the backward) takes as ``(B*C, H*W)`` views with no
copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ... import ops
from ...ops import splines
from ...utils.nn import sum_except_batch
from ..base import Flow
from .feed import (
    FusedFeed,
    fused_head_eligible,
    fused_head_spline_feed,
    fused_head_wanted,
    homogeneous_tails,
    kmajor_spline_feed,
    slice_ud_planes,
)

def split_mask(mask):
    """(identity_features, transform_features): ``mask[i] > 0`` means
    feature i is transformed."""
    mask = np.asarray(mask)
    if mask.ndim != 1:
        raise ValueError("Mask must be a 1-dim tensor.")
    if mask.size == 0:
        raise ValueError("Mask can't be empty.")
    idx = np.arange(len(mask))
    return tuple(idx[mask <= 0].tolist()), tuple(idx[mask > 0].tolist())


class Coupling(Flow):
    """Mask-indexed coupling on ``(B, D)`` inputs or ``(B, C, H, W)``
    images, split along axis 1 (reference ``coupling.py:16-140``); the
    conditioner sees the identity features."""

    def __init__(self, mask, transform_net, unconditional_transform=None):
        super().__init__()
        identity, transform = split_mask(mask)
        self.register_buffer("identity_features",
                             torch.tensor(identity, dtype=torch.int64))
        self.register_buffer("transform_features",
                             torch.tensor(transform, dtype=torch.int64))
        self.num_transform_features = len(transform)
        self.transform_net = transform_net
        self.unconditional_transform = unconditional_transform

    def _coupling_transform_forward(self, inputs, transform_params):
        raise NotImplementedError()

    def _coupling_transform_inverse(self, inputs, transform_params):
        raise NotImplementedError()

    def _transform_params(self, identity_split, context, generator=None):
        return self.transform_net(identity_split, context,
                                  generator=generator)

    def _split(self, inputs):
        if inputs.ndim not in (2, 4):
            raise ValueError("Inputs must be a 2D or a 4D tensor.")
        return (inputs[:, self.identity_features],
                inputs[:, self.transform_features])

    def _scatter(self, template, identity_split, transform_split):
        out = torch.empty_like(template)
        out[:, self.identity_features] = identity_split
        out[:, self.transform_features] = transform_split
        return out

    def forward(self, inputs, context=None, generator=None):
        identity_split, transform_split = self._split(inputs)
        transform_params = self._transform_params(identity_split, context,
                                                  generator)
        transform_split, logabsdet = self._coupling_transform_forward(
            transform_split, transform_params)
        if self.unconditional_transform is not None:
            identity_split, logabsdet_id = \
                self.unconditional_transform.forward(identity_split)
            logabsdet = logabsdet + logabsdet_id
        return self._scatter(inputs, identity_split, transform_split), \
            logabsdet

    def inverse(self, inputs, context=None, generator=None):
        identity_split, transform_split = self._split(inputs)
        logabsdet = 0.0
        if self.unconditional_transform is not None:
            identity_split, logabsdet = \
                self.unconditional_transform.inverse(identity_split)
        transform_params = self._transform_params(identity_split, context,
                                                  generator)
        transform_split, logabsdet_split = self._coupling_transform_inverse(
            transform_split, transform_params)
        logabsdet = logabsdet + logabsdet_split
        return self._scatter(inputs, identity_split, transform_split), \
            logabsdet


def _reshape_params(inputs, transform_params):
    """``(B, C*P, H, W) -> (B, C, H, W, P)`` or ``(B, D*P) -> (B, D, P)``,
    bin-minor (reference ``coupling.py:150-160``)."""
    if inputs.ndim == 4:
        b, c, h, w = inputs.shape
        return transform_params.reshape(b, c, -1, h, w).permute(0, 1, 3, 4, 2)
    return transform_params.reshape(inputs.shape[0], inputs.shape[1], -1)


def _tail_bound_tensor(tail_bound, dtype=torch.float32):
    """Per-feature tail bounds as a tensor in the layer's ``dtype`` (the
    JAX package's ``jnp.asarray(tail_bound, dtype)``: in bfloat16 pi is
    3.140625), or None for a scalar bound."""
    if isinstance(tail_bound, (int, float)):
        return None
    if isinstance(tail_bound, torch.Tensor):
        return tail_bound.to(dtype)
    return torch.as_tensor(np.asarray(tail_bound, np.float32), dtype=dtype)


class PiecewiseRationalQuadraticCDF(Flow):
    """Elementwise RQ-spline flow with its own parameters, the
    unconditional transform of the identity half (reference
    ``coupling.py:170-259``). Its ``(D, K)`` parameters broadcast over the
    batch; on CUDA they reach kernel A with a batch stride of 0."""

    def __init__(self, shape, num_bins=10, tails=None, tail_bound=1.0,
                 min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.DEFAULT_MIN_DERIVATIVE,
                 dtype=torch.float32):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if tails == "linear":
            num_derivatives = num_bins - 1
        elif tails == "circular":
            num_derivatives = num_bins
        else:
            num_derivatives = num_bins + 1
        # identity init: uniform bins, slope-1 derivatives
        self.unnormalized_widths = nn.Parameter(
            torch.zeros(shape + (num_bins,), dtype=dtype))
        self.unnormalized_heights = nn.Parameter(
            torch.zeros(shape + (num_bins,), dtype=dtype))
        self.unnormalized_derivatives = nn.Parameter(torch.full(
            shape + (num_derivatives,),
            splines.linear_tail_constant(min_derivative), dtype=dtype))
        tb_arr = _tail_bound_tensor(tail_bound, dtype)
        self.register_buffer("tail_bound_arr", tb_arr, persistent=False)
        self.tail_bound = 1.0 if tb_arr is not None else float(tail_bound)
        self.tails = tuple(tails) if isinstance(tails, (list, tuple)) \
            else tails
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative

    def _spline(self, inputs, inverse):
        uw = self.unnormalized_widths[None]
        uh = self.unnormalized_heights[None]
        ud = self.unnormalized_derivatives[None]
        tb = self.tail_bound_arr if self.tail_bound_arr is not None \
            else self.tail_bound
        if (self.tail_bound_arr is not None
                and self.tail_bound_arr.ndim == 1 and inputs.ndim > 2):
            # per-channel bounds align to the channel axis of an image
            tb = tb.reshape((1, -1) + (1,) * (inputs.ndim - 2))
        kw = dict(inverse=inverse, min_bin_width=self.min_bin_width,
                  min_bin_height=self.min_bin_height,
                  min_derivative=self.min_derivative)
        if self.tails is None:
            outputs, logabsdet = ops.rational_quadratic_spline(
                inputs, uw, uh, ud, **kw)
        else:
            tails = list(self.tails) if isinstance(self.tails, tuple) \
                else self.tails
            outputs, logabsdet = ops.unconstrained_rational_quadratic_spline(
                inputs, uw, uh, ud, tails=tails, tail_bound=tb, **kw)
        return outputs, sum_except_batch(logabsdet)

    def forward(self, inputs, context=None, generator=None):
        return self._spline(inputs, inverse=False)

    def inverse(self, inputs, context=None, generator=None):
        return self._spline(inputs, inverse=True)


class PiecewiseRationalQuadraticCoupling(Coupling):
    """RQ-spline coupling (reference ``coupling.py:262-362``): per-feature
    tails, tensor tail bounds split between halves, softmax inputs scaled
    by 1/sqrt(hidden)."""

    def __init__(self, mask, transform_net_create_fn, num_bins=10,
                 tails=None, tail_bound=1.0,
                 apply_unconditional_transform=False,
                 min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.DEFAULT_MIN_DERIVATIVE,
                 dtype=torch.float32):
        identity, transform = split_mask(mask)
        if isinstance(tails, (list, tuple)):
            tails_t = tuple(tails[i] for i in transform)
            tails_id = tuple(tails[i] for i in identity)
        else:
            tails_t = tails_id = tails
        tb_arr = _tail_bound_tensor(tail_bound, dtype)
        if tb_arr is not None:
            tb_t = tb_arr[list(transform)]
            tb_id = tb_arr[list(identity)]
        else:
            tb_t, tb_id = None, tail_bound

        if tails_t == "linear":
            mult = num_bins * 3 - 1
        elif tails_t == "circular":
            mult = num_bins * 3
        else:
            mult = num_bins * 3 + 1

        transform_net = transform_net_create_fn(
            len(identity), len(transform) * mult)
        unconditional = None
        if apply_unconditional_transform:
            unconditional = PiecewiseRationalQuadraticCDF(
                [len(identity)], num_bins=num_bins, tails=tails_id,
                tail_bound=tb_id, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
                min_derivative=min_derivative, dtype=dtype)
        super().__init__(mask, transform_net, unconditional)

        hidden = (getattr(transform_net, "hidden_features", None)
                  or getattr(transform_net, "hidden_channels", None))
        self.softmax_scale = 1.0 / math.sqrt(hidden) if hidden else 1.0
        self.register_buffer("tail_bound_arr", tb_t, persistent=False)
        self.tail_bound = 1.0 if tb_arr is not None else float(tail_bound)
        self.num_bins = num_bins
        self.tails = tails_t
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative

    def _spline_kw(self, inverse):
        return dict(inverse=inverse, min_bin_width=self.min_bin_width,
                    min_bin_height=self.min_bin_height,
                    min_derivative=self.min_derivative)

    def _piecewise_cdf(self, inputs, transform_params, inverse):
        K = self.num_bins
        uw = transform_params[..., :K] * self.softmax_scale
        uh = transform_params[..., K:2 * K] * self.softmax_scale
        ud = transform_params[..., 2 * K:]
        tb = self.tail_bound_arr if self.tail_bound_arr is not None \
            else self.tail_bound
        if self.tail_bound_arr is not None and inputs.ndim > 2:
            # per-feature bounds align to the channel axis of an image
            tb = tb.reshape((1, -1) + (1,) * (inputs.ndim - 2))
        if self.tails is None:
            return ops.rational_quadratic_spline(
                inputs, uw, uh, ud, **self._spline_kw(inverse))
        tails = list(self.tails) if isinstance(self.tails, tuple) \
            else self.tails
        return ops.unconstrained_rational_quadratic_spline(
            inputs, uw, uh, ud, tails=tails, tail_bound=tb,
            **self._spline_kw(inverse))

    def _transform_params(self, identity_split, context, generator=None):
        """Route the conditioner through transposed execution when kernel B
        will consume it: the trunk emits ``(hidden, batch)`` features and
        the head product moves into the kernel. ``generator`` reaches the
        trunk's dropout on both feeds; a dropped-out trunk changes ``h_t``,
        not the head, so kernel B (and E) take it as they take any other."""
        if (fused_head_eligible(self.transform_net, self.tails,
                                self.tail_bound_arr, self.num_bins)
                and fused_head_wanted(identity_split.device,
                                      identity_split.shape[0]
                                      * self.num_transform_features)):
            return FusedFeed(self.transform_net.features_transposed(
                identity_split, context, generator=generator))
        return self.transform_net(identity_split, context,
                                  generator=generator)

    def _coupling_transform(self, inputs, transform_params, inverse):
        feed_kw = dict(num_bins=self.num_bins, tails=self.tails,
                       tail_bound=self.tail_bound,
                       tail_bound_arr=self.tail_bound_arr,
                       softmax_scale=self.softmax_scale,
                       **self._spline_kw(inverse))
        if isinstance(transform_params, FusedFeed):
            return fused_head_spline_feed(
                inputs, transform_params.h_t, self.transform_net, **feed_kw)
        homo = homogeneous_tails(self.tails)
        if inputs.ndim == 4 and homo is not None:
            return self._image_feed(inputs, transform_params, homo, inverse)
        mixed = (isinstance(self.tails, tuple)
                 and set(self.tails) <= {"linear", "circular"})
        net_bin_major = getattr(self.transform_net, "bin_major_head", None)
        if net_bin_major is not None:
            # (mult*D, B) head output, rows bin-major: a zero-copy view to
            # (mult, D, B) planes
            b = inputs.shape[0]
            p = transform_params.reshape(-1, net_bin_major[0], b)
            if homo is not None or mixed:
                return kmajor_spline_feed(inputs, p, **feed_kw)
            transform_params = torch.permute(p, (2, 1, 0)).reshape(b, -1)
        params = _reshape_params(inputs, transform_params)
        outputs, logabsdet = self._piecewise_cdf(inputs, params, inverse)
        return outputs, sum_except_batch(logabsdet)

    def _image_feed(self, inputs, transform_params, homo, inverse):
        """The bin-major image feed (``coupling.py:398-421``): the
        conditioner's ``(B, C*P, H, W)`` output viewed as ``(P, B, C, H,
        W)`` planes (channel c's parameter p at channel c*P + p), so each
        plane is H*W-contiguous runs and no element-wise transpose to the
        kernel's layout is needed; widths and heights scaled by the
        softmax scale, the derivatives padded for the tails."""
        b, c, h, w = inputs.shape
        p = transform_params.reshape(b, c, -1, h, w).permute(2, 0, 1, 3, 4)
        K = self.num_bins
        tb = self.tail_bound_arr if self.tail_bound_arr is not None \
            else self.tail_bound
        if self.tail_bound_arr is not None:
            tb = tb.reshape(1, -1, 1, 1)  # per-channel bounds
        outputs, logabsdet = \
            splines.unconstrained_rational_quadratic_spline_kmajor(
                inputs, p[:K] * self.softmax_scale,
                p[K:2 * K] * self.softmax_scale,
                slice_ud_planes(p[2 * K:], K, homo), tails=homo,
                tail_bound=tb, **self._spline_kw(inverse))
        return outputs, sum_except_batch(logabsdet)

    def _coupling_transform_forward(self, inputs, transform_params):
        return self._coupling_transform(inputs, transform_params, False)

    def _coupling_transform_inverse(self, inputs, transform_params):
        return self._coupling_transform(inputs, transform_params, True)
