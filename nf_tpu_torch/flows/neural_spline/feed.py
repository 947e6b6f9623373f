"""Shared bin-major ("k-major") spline-parameter feed
(``nf_tpu/flows/neural_spline/feed.py``).

A bin-major conditioner head emits ``(mult*D, B)`` output with rows
param-major, a zero-copy view of the spline kernels' ``(K, N)`` layout.
The coupling feeds it either to kernel A through :func:`kmajor_spline_feed`
or, when :func:`fused_head_wanted` says so, hands the hidden activations to
kernel B (:func:`fused_head_spline_feed`), which computes the head itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import spline_head_fused as _fused
from ...ops import splines

# The fused head takes a layer when it has at least this many elements
# (B*D). Below it, kernel B's grid has at most 16 blocks of 256 threads on
# the H100's 132 SMs, each thread runs its (3K)*H product serially, and the
# unfused feed (a library GEMM over the whole card, then kernel A) is
# expected to win. The value is the JAX package's threshold; one H100 run
# put the crossover between 4096 and 16384 elements (PERF.md), and the
# value stays until repeat runs place it.
FUSED_HEAD_MIN_ELEMENTS = 4096


class FusedFeed(NamedTuple):
    """Conditioner output for the fused head+spline path: the TRANSPOSED
    hidden activations ``(hidden, batch)``; the head product happens in
    kernel B."""

    h_t: torch.Tensor


def fused_head_wanted(device, n_elements):
    """The port's gate for kernel B: a CUDA tensor and ``B*D >= 4096``.
    The CPU takes it only inside ``ops.cpu_through_ops`` (elsewhere its
    unfused feed is the plain path)."""
    from ...ops.splines_kernel import _CPU_THROUGH_OPS

    return ((torch.device(device).type == "cuda" or _CPU_THROUGH_OPS[0])
            and n_elements >= FUSED_HEAD_MIN_ELEMENTS)


def fused_head_eligible(net, tails, tail_bound_arr, num_bins):
    """Static test for the fused head: the conditioner runs transposed and
    carries a bin-major head whose row count is the homogeneous-tail
    effective layout, or the per-feature 3K+1 layout of homogeneous
    per-feature tails (the circular coupling's transformed half); mixed
    per-feature tails stay on the k-major feed.

    The JAX package's test (``feed.py:35``) takes only the first: its
    circular coupling runs the unfused feed. The 3K+1 head differs from
    the effective one by derivative planes the tail padding overwrites
    (:func:`slice_ud_planes`), so kernel B takes its other rows
    (:func:`_effective_rows`) and computes what the unfused feed does."""
    homo = homogeneous_tails(tails)
    if homo is None:
        return False
    head = getattr(net, "bin_major_head", None)
    if head is None or not hasattr(net, "features_transposed"):
        return False
    _, mult = head
    return mult in (2 * num_bins + _fused._dplanes(num_bins, homo),
                    3 * num_bins + 1)


def _effective_rows(weight, bias, num_bins, feats, homo):
    """A 3K+1 bin-major head's rows without the derivative planes the tail
    padding overwrites (linear: the first and the last; circular: the
    last), the rows of the homogeneous layout; any other head as it is.
    Those planes get no gradient, as on the unfused feed."""
    K, D = num_bins, feats
    if weight.shape[0] != (3 * K + 1) * D:
        return weight, bias
    first = 1 if homo == "linear" else 0
    rows = slice((2 * K + first) * D, (2 * K + first
                                       + _fused._dplanes(K, homo)) * D)
    return (torch.cat([weight[:2 * K * D], weight[rows]]),
            torch.cat([bias[:2 * K * D], bias[rows]]))


def fused_head_spline_feed(inputs, h_t, net, *, num_bins, tails, tail_bound,
                           tail_bound_arr, softmax_scale, inverse,
                           min_bin_width, min_bin_height, min_derivative):
    """Kernel-B twin of :func:`kmajor_spline_feed`: ``(B, D)`` inputs and
    transposed hidden activations -> ``(outputs (B, D), log_det (B,))``."""
    homo = homogeneous_tails(tails)
    weight, bias = _effective_rows(net.final_layer.weight,
                                   net.final_layer.bias, num_bins,
                                   inputs.shape[1], homo)
    w_eff, b_eff = _fused.effective_head(
        weight, bias, num_bins=num_bins, feats=inputs.shape[1], tails=homo,
        softmax_scale=softmax_scale)
    tb = tail_bound_arr if tail_bound_arr is not None else tail_bound
    y_t, ld_t = _fused.fused_head_rqs(
        inputs.T, h_t, w_eff, b_eff, num_bins=num_bins, tails=homo,
        tail_bound=tb, inverse=inverse, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    return y_t.T, torch.sum(ld_t, dim=0)


def homogeneous_tails(tails):
    """'linear'/'circular' when every transformed feature shares that tail
    type (scalar, or a homogeneous per-feature list/tuple), else None."""
    if tails in ("linear", "circular"):
        return tails
    if isinstance(tails, (list, tuple)) and len(set(tails)) == 1 \
            and tails[0] in ("linear", "circular"):
        return tails[0]
    return None


def slice_ud_planes(ud, num_bins, homo):
    """Drop the derivative planes the tail padding would overwrite when
    params carry the per-feature-tails K+1 count (leading-axis layout)."""
    if ud.shape[0] == num_bins + 1:
        return ud[1:num_bins] if homo == "linear" else ud[:num_bins]
    return ud


def kmajor_spline_feed(inputs, planes, *, num_bins, tails, tail_bound,
                       tail_bound_arr, softmax_scale, inverse,
                       min_bin_width, min_bin_height, min_derivative):
    """The k-major spline on ``(B, D)`` inputs with bin-major ``(mult, D,
    B)`` parameter planes -> ``(outputs (B, D), log_det (B,))``."""
    uw = planes[:num_bins] * softmax_scale
    uh = planes[num_bins:2 * num_bins] * softmax_scale
    ud = planes[2 * num_bins:]
    homo = homogeneous_tails(tails)
    if homo is not None:
        ud = slice_ud_planes(ud, num_bins, homo)
        tails_arg = homo
    else:
        tails_arg = list(tails)
    tb = tail_bound_arr if tail_bound_arr is not None else tail_bound
    if tail_bound_arr is not None:
        tb = tb.reshape(-1, 1)  # per-feature bounds over (D, B) data
    y_t, ld_t = splines.unconstrained_rational_quadratic_spline_kmajor(
        inputs.T, uw, uh, ud, inverse=inverse, tails=tails_arg,
        tail_bound=tb, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    return y_t.T, torch.sum(ld_t, dim=0)
