"""Monotone rational-quadratic splines in plain PyTorch
(``nf_tpu/ops/splines.py``; reference ``normflows/utils/splines.py``).

These are the plain versions: the CPU path, and the reference the CUDA
kernel (``ops.splines_kernel``) is held against. The entry points
:func:`unconstrained_rational_quadratic_spline` and its ``_kmajor`` twin
dispatch on the tensor's device: a CUDA tensor goes to kernel A
(``splines_kernel.fused_unconstrained_rqs[_kmajor]``), a CPU tensor to
:func:`identity_tail_spline`. There is no switch between the two.

Parameters broadcast against the inputs over leading axes, so the
unconditional CDF passes its ``(1, D, K)`` parameters without
materialising them per batch row (on CUDA they reach the kernel with a
stride of 0).
"""

from __future__ import annotations

import math

import torch

from ..utils.nn import softplus

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def linear_tail_constant(min_derivative):
    """Derivative logit whose softplus plus ``min_derivative`` is 1."""
    return float(math.log(math.exp(1 - min_derivative) - 1))


def searchsorted(bin_locations, inputs, eps=1e-6):
    """Index of the bin containing each input, by compare-and-sum
    (reference ``splines.py:11-13``)."""
    locs = bin_locations.clone()
    locs[..., -1] += eps
    return torch.sum(inputs[..., None] >= locs, dim=-1) - 1


def _make_knots(unnormalized, num_bins, min_size, low, high):
    """softmax -> min-size floor -> cumsum -> rescale to [low, high], with
    exact endpoints (reference ``splines.py:126-152``)."""
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1 - min_size * num_bins) * sizes
    cum = torch.cumsum(sizes, dim=-1)
    cum = torch.nn.functional.pad(cum, (1, 0))
    lo = torch.as_tensor(low, dtype=cum.dtype, device=cum.device)
    hi = torch.as_tensor(high, dtype=cum.dtype, device=cum.device)
    lo_b = lo[..., None] if lo.ndim else lo
    hi_b = hi[..., None] if hi.ndim else hi
    cum = (hi_b - lo_b) * cum + lo_b
    first = torch.broadcast_to(lo_b, cum[..., :1].shape)
    last = torch.broadcast_to(hi_b, cum[..., -1:].shape)
    cum = torch.cat([first, cum[..., 1:-1], last], dim=-1)
    sizes = cum[..., 1:] - cum[..., :-1]
    return sizes, cum


def rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    left=0.0,
    right=1.0,
    bottom=0.0,
    top=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Elementwise RQ-spline map on the interval, with log-det
    (reference ``splines.py:100-219``). ``inputs`` (...,), widths and
    heights (..., K), derivatives (..., K+1); returns
    ``(outputs, logabsdet)``."""
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    widths, cumwidths = _make_knots(unnormalized_widths, num_bins,
                                    min_bin_width, left, right)
    heights, cumheights = _make_knots(unnormalized_heights, num_bins,
                                      min_bin_height, bottom, top)
    derivatives = min_derivative + softplus(unnormalized_derivatives)

    bin_idx = searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)
    # one-hot masked sum (where, not multiply: a non-finite value in an
    # unselected bin cannot poison the element through 0*inf)
    onehot = bin_idx[..., None] == torch.arange(num_bins,
                                                device=inputs.device)

    def take(arr):
        arr = torch.broadcast_to(arr[..., :num_bins], onehot.shape)
        return torch.sum(torch.where(onehot, arr, 0.0), dim=-1)

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives)
    input_derivatives_p1 = take(derivatives[..., 1:])
    input_heights = take(heights)

    d_sum = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        dy = inputs - input_cumheights
        a = dy * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - dy * d_sum
        c = -input_delta * dy
        discriminant = torch.clamp_min(b ** 2 - 4 * a * c, 0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_1mt = root * (1 - root)
        denominator = input_delta + d_sum * theta_1mt
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_p1 * root ** 2
            + 2 * input_delta * theta_1mt
            + input_derivatives * (1 - root) ** 2)
        logabsdet = torch.log(derivative_numerator) \
            - 2 * torch.log(denominator)
        return outputs, -logabsdet
    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_1mt = theta * (1 - theta)
    numerator = input_heights * (
        input_delta * theta ** 2 + input_derivatives * theta_1mt)
    denominator = input_delta + d_sum * theta_1mt
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_p1 * theta ** 2
        + 2 * input_delta * theta_1mt
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def identity_tail_spline(inputs, uw, uh, ud_padded, tb, inverse,
                         min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                         min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                         min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Symmetric-interval spline with identity tails on PADDED (K+1)
    derivatives: clamp into [-tb, tb], evaluate, select the identity
    outside (``nf_tpu/ops/splines.py:168``)."""
    inside = (inputs >= -tb) & (inputs <= tb)
    clamped = torch.clamp(inputs, -tb, tb)
    spline_out, spline_ld = rational_quadratic_spline(
        clamped, uw, uh, ud_padded, inverse=inverse, left=-tb, right=tb,
        bottom=-tb, top=tb, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_ld, 0.0)
    return outputs, logabsdet


def _tail_mask(tails, shape, device):
    lin = torch.tensor([t == "linear" for t in tails], device=device)
    circ = torch.tensor([t == "circular" for t in tails], device=device)
    if not bool(torch.all(lin | circ)):
        raise RuntimeError(f"{tails} tails are not implemented.")
    return lin.reshape(shape), circ.reshape(shape)


def pad_derivatives(ud, tails, min_derivative, axis):
    """The tail-type padding of the derivative logits to K+1 entries along
    ``axis`` (reference ``splines.py:43-56``): 'linear' pads both ends
    with the logit of slope 1, 'circular' closes the circle with entry 0,
    a per-feature list of those two overwrites the first/last of K+1
    entries per feature. For a list, the feature axis is the axis just
    before ``axis`` (bin-minor layout) or just after it (bin-major)."""
    constant = linear_tail_constant(min_derivative)
    first_sl = [slice(None)] * ud.ndim
    first_sl[axis] = slice(0, 1)
    first = ud[tuple(first_sl)]
    if tails == "linear":
        edge = torch.full_like(first, constant)
        return torch.cat([edge, ud, edge], dim=axis)
    if tails == "circular":
        return torch.cat([ud, first], dim=axis)
    if isinstance(tails, (list, tuple)):
        ax = axis % ud.ndim
        feat_ax = ax - 1 if ax == ud.ndim - 1 else ax + 1
        shape = [1] * ud.ndim
        shape[feat_ax] = len(tails)
        lin, circ = _tail_mask(tails, shape, ud.device)
        last_sl = list(first_sl)
        last_sl[axis] = slice(-1, None)
        mid_sl = list(first_sl)
        mid_sl[axis] = slice(1, -1)
        last = ud[tuple(last_sl)]
        new_first = torch.where(lin, constant, first)
        new_last = torch.where(lin, constant, torch.where(circ, first, last))
        return torch.cat([new_first, ud[tuple(mid_sl)], new_last], dim=axis)
    raise RuntimeError(f"{tails} tails are not implemented.")


def unconstrained_rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    tails="linear",
    tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """RQ spline on [-tail_bound, tail_bound] with identity tails
    (reference ``splines.py:16-97``), bin-MINOR parameters ``(..., K)``.

    ``tails``: 'linear' (K-1 derivatives), 'circular' (K), or a
    per-feature list of those over the last input axis (K+1).
    ``tail_bound`` is a scalar or a tensor broadcastable to ``inputs``.
    """
    ud = pad_derivatives(unnormalized_derivatives, tails, min_derivative,
                         axis=-1)
    if inputs.is_cuda:
        from .splines_kernel import fused_unconstrained_rqs

        return fused_unconstrained_rqs(
            inputs, unnormalized_widths, unnormalized_heights, ud,
            tail_bound, inverse=inverse, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative)
    tb = torch.broadcast_to(
        torch.as_tensor(tail_bound, dtype=inputs.dtype, device=inputs.device),
        inputs.shape)
    return identity_tail_spline(
        inputs, unnormalized_widths, unnormalized_heights, ud, tb, inverse,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)


def unconstrained_rational_quadratic_spline_kmajor(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    tails="linear",
    tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Bin-MAJOR variant (``nf_tpu/ops/splines.py:260``): widths and
    heights ``(K, *inputs.shape)``, derivatives ``(K-1, ...)`` linear,
    ``(K, ...)`` circular, or ``(K+1, ...)`` for a per-feature list along
    axis 0 of ``inputs`` (the ``(D, batch)`` layout of bin-major heads)."""
    ud = pad_derivatives(unnormalized_derivatives, tails, min_derivative,
                         axis=0)
    if inputs.is_cuda:
        from .splines_kernel import fused_unconstrained_rqs_kmajor

        return fused_unconstrained_rqs_kmajor(
            inputs, unnormalized_widths, unnormalized_heights, ud,
            tail_bound, inverse=inverse, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative)
    tb = torch.broadcast_to(
        torch.as_tensor(tail_bound, dtype=inputs.dtype, device=inputs.device),
        inputs.shape)
    return identity_tail_spline(
        inputs, torch.movedim(unnormalized_widths, 0, -1),
        torch.movedim(unnormalized_heights, 0, -1),
        torch.movedim(ud, 0, -1), tb, inverse,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
