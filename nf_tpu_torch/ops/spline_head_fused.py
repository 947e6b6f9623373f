"""Kernels B and E: conditioner head product + RQ spline in one pass (B),
and its fused backward (E).

Kernel B replaces ``nf_tpu/ops/spline_head_fused.py:_head_kernel``
(launcher ``_make_op.fwd_impl``, :216). The bin-major conditioner head
emits spline parameters as ``params = W @ h_t + b`` with rows param-major;
kernel B computes that last product inside the kernel, per element, and
feeds the sums straight into the spline, so the ``(2K+nd)*D`` parameter
planes never reach device memory. Kernel E replaces ``_head_bwd_kernel``
(launcher ``_make_op.bwd_impl``, :236): it recomputes the parameters, runs
the analytic spline transpose, folds the cotangents into head rows and
forms ``gx``, ``gh = W_eff^T @ gparams``, ``gW = gparams @ h_t^T`` and
``gb`` in its own body. The CUDA sources are ``csrc/head_rqs_fwd.cu`` and
``csrc/head_rqs_bwd.cu``; what bounds each on the H100 and what the design
does about it is noted there.

Beside the kernels:

* :func:`head_rqs_plain` and :func:`head_rqs_bwd_plain`, the plain
  versions (``torch.matmul`` for the products, then
  ``splines_kernel.rqs_plain`` / ``rqs_bwd_plain``). CPU tensors use
  :func:`head_rqs_plain` with ordinary autograd, and the tests and
  ``chip_smoke.py`` hold the kernels against both;
  :func:`head_rqs_bwd_plain_in_kernel_order` sums the head product in the
  kernels' order;
* :func:`fused_head_rqs`, the wrapper: CUDA -> :class:`_HeadRQSFunction`
  (kernel B forward, kernel E backward) or raise, CPU -> the plain version;
* ``fused_head_rqs.launches`` and ``fused_head_rqs_bwd.launches``, the
  counts of launches;
* :func:`effective_head` and :func:`_build_d_list`, ported from the JAX
  module (:329, :93).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    linear_tail_constant,
)
from .splines_kernel import SUPPORTED_BINS, rqs_bwd_plain, rqs_plain


def _dplanes(num_bins, tails):
    """Number of derivative rows the effective head weight carries."""
    return num_bins - 1 if tails == "linear" else num_bins


def _build_d_list(d_in, x_like, tails, min_derivative):
    """K+1 boundary-adjusted derivative planes from the effective rows:
    linear pads both ends with the logit of slope 1, circular closes the
    circle with plane 0 (reference ``splines.py:43-56``)."""
    if tails == "linear":
        edge = torch.full_like(x_like, linear_tail_constant(min_derivative))
        return [edge] + list(d_in) + [edge]
    return list(d_in) + [d_in[0]]


def effective_head(weight, bias, *, num_bins, feats, tails, softmax_scale):
    """Fold the width/height softmax scale into the head rows:
    ``s*(W@h+b) == (s*W)@h + s*b`` (``spline_head_fused.py:329``)."""
    K, D = num_bins, feats
    if bias is None:
        bias = torch.zeros(weight.shape[0], dtype=weight.dtype,
                           device=weight.device)
    if weight.shape[0] != (2 * K + _dplanes(K, tails)) * D:
        raise ValueError(f"head has {weight.shape[0]} rows, expected "
                         f"{(2 * K + _dplanes(K, tails)) * D}")
    if softmax_scale == 1.0:
        return weight, bias
    wh_rows = 2 * K * D
    w_eff = torch.cat([weight[:wh_rows] * softmax_scale, weight[wh_rows:]])
    b_eff = torch.cat([bias[:wh_rows] * softmax_scale, bias[wh_rows:]])
    return w_eff, b_eff


def head_rqs_plain(x_t, h_t, head_weight, head_bias, tb, *, num_bins, tails,
                   inverse, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                   min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                   min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Plain version of kernel B: ``x_t`` (D, B), ``h_t`` (H, B), effective
    head ``(2K+nd)*D x H`` and bias, ``tb`` (D,) -> ``(y, ld)`` (D, B)."""
    K, D = num_bins, x_t.shape[0]
    params = torch.matmul(head_weight, h_t) + head_bias[:, None]
    planes = [params[p * D:(p + 1) * D] for p in range(2 * K
                                                        + _dplanes(K, tails))]
    d = _build_d_list(planes[2 * K:], x_t, tails, min_derivative)
    return rqs_plain(x_t, planes[:K], planes[K:2 * K], d, tb.reshape(-1, 1),
                     inverse=inverse, min_bin_width=min_bin_width,
                     min_bin_height=min_bin_height,
                     min_derivative=min_derivative)


def head_rqs_bwd_plain(x_t, h_t, head_weight, head_bias, tb, cty, ctl, *,
                       num_bins, tails, inverse,
                       min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                       min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                       min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Plain version of kernel E: the operands of :func:`head_rqs_plain`
    plus the cotangents ``cty``, ``ctl`` (D, B) of ``(y, ld)`` -> ``(gx (D,
    B), gh (H, B), gW (M, H), gb (M,))`` (``spline_head_fused.py:129``).
    The derivative cotangents fold into head rows: linear tails drop the
    two synthesised edge planes, circular tails add ``gd[K]`` into row 0.
    The tail bound gets no gradient."""
    K, D = num_bins, x_t.shape[0]
    nd = _dplanes(K, tails)
    params = torch.matmul(head_weight, h_t) + head_bias[:, None]
    planes = [params[p * D:(p + 1) * D] for p in range(2 * K + nd)]
    d = _build_d_list(planes[2 * K:], x_t, tails, min_derivative)
    gx, gw, gh, gd = rqs_bwd_plain(
        x_t, planes[:K], planes[K:2 * K], d, tb.reshape(-1, 1), cty, ctl,
        inverse=inverse, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    if tails == "linear":
        gd_eff = [gd[j + 1] for j in range(nd)]
    else:
        gd_eff = [gd[0] + gd[K]] + [gd[j] for j in range(1, K)]
    gparams = torch.cat([gw.reshape(K * D, -1), gh.reshape(K * D, -1)]
                        + gd_eff)
    return (gx, torch.matmul(head_weight.T, gparams),
            torch.matmul(gparams, h_t.T), torch.sum(gparams, dim=1))


def head_rqs_bwd_plain_in_kernel_order(x_t, h_t, head_weight, head_bias, tb,
                                       cty, ctl, **kw):
    """:func:`head_rqs_bwd_plain` with the head product summed as kernels B
    and E sum it: j ascending from 0, one rounding per step as ``fmaf``
    gives (the product of two float32 is exact in float64), then the bias.
    The spline's derivatives carry a rounding of the parameters into gx,
    so where ``torch.matmul``'s order moves gx past the 1e-4 bar this is
    the yardstick that tells the kernel's arithmetic from its order. The
    parameters go through :func:`head_rqs_bwd_plain` as its ``h_t`` under
    an identity head, whose product is exact."""
    m = head_weight.shape[0]
    acc = torch.zeros((m, h_t.shape[1]), dtype=h_t.dtype, device=h_t.device)
    for j in range(h_t.shape[0]):
        acc = (acc.double() + head_weight[:, j, None].double()
               * h_t[j].double()).to(h_t.dtype)
    eye = torch.eye(m, dtype=h_t.dtype, device=h_t.device)
    gx, gparams, _, gb = head_rqs_bwd_plain(
        x_t, acc + head_bias[:, None], eye, torch.zeros_like(head_bias), tb,
        cty, ctl, **kw)
    return (gx, torch.matmul(head_weight.T, gparams),
            torch.matmul(gparams, h_t.T), gb)


def _launch(x_t, h_t, w, b, tb, *, num_bins, tails, inverse, mbw, mbh, md):
    from . import _build

    lib = _build.load("head_rqs_fwd")
    fn = lib.head_rqs_fwd_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    D, B = x_t.shape
    y = torch.empty((D, B), dtype=x_t.dtype, device=x_t.device)
    ld = torch.empty_like(y)
    err = fn(x_t.data_ptr(), x_t.stride(0), x_t.stride(1), h_t.data_ptr(),
             w.data_ptr(), b.data_ptr(), tb.data_ptr(), D, B, h_t.shape[0],
             num_bins, int(tails == "circular"), int(bool(inverse)),
             linear_tail_constant(md), mbw, mbh, md, y.data_ptr(),
             ld.data_ptr(), torch.cuda.current_stream(x_t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"head_rqs_fwd kernel launch failed: CUDA error {err}")
    fused_head_rqs.launches += 1
    return y, ld


# kernel E's layout (csrc/head_rqs_bwd.cu kThreads, kColPad, kJ, kG,
# kChunk, kRowPad, kTileM, kTileJ) and the shared memory a block may use
# on the H100
_E_THREADS, _E_COL_PAD, _E_WTILE, _E_GH_ROWS = 256, 4, 128, 16
_E_CHUNK, _E_ROW_PAD, _E_TILE_M, _E_TILE_J = 32, 4, 24, 32
_MAX_SHARED_BYTES = 232448


def kernel_e_shared_bytes(m, feats, hidden):
    """Dynamic shared memory of one block of kernel E at ``m`` head rows
    over ``feats`` features, float32: the block's parameter cotangents (m
    rounded up to 24, 256 + 4), the staged W_eff tile (rows, feats, P
    rounded up to 4; rows = hidden rounded up to 16, at most 128) and the
    chunks of h_t (hidden rounded up to 32, 32 + 4), two where they fit and
    else one. At one feature and hidden <= 128 the tile and the chunks sit
    side by side (gW and gh run at once on separate warps); otherwise they
    share one region."""
    pp = (m // feats + 3) // 4 * 4
    rows = min(_E_WTILE, -(-hidden // _E_GH_ROWS) * _E_GH_ROWS)
    split = feats == 1 and hidden <= _E_WTILE

    def total(buffers):
        w = rows * feats * pp
        h = (buffers * -(-hidden // _E_TILE_J) * _E_TILE_J
             * (_E_CHUNK + _E_ROW_PAD))
        return 4 * (-(-m // _E_TILE_M) * _E_TILE_M
                    * (_E_THREADS + _E_COL_PAD)
                    + (w + h if split else max(w, h)))

    return total(2) if total(2) <= _MAX_SHARED_BYTES else total(1)


def _launch_bwd(x_t, h_t, w, b, tb, cty, ctl, *, num_bins, tails, inverse,
                mbw, mbh, md):
    """Launch kernel E (two launches: the per-block pass, then the
    fixed-order sum of the blocks' gW/gb partials) -> ``(gx, gh, gW,
    gb)``. Raises on a shape, type or device the kernel does not take."""
    from . import _build

    D, B = x_t.shape
    H = h_t.shape[0]
    m = w.shape[0]
    if num_bins not in SUPPORTED_BINS:
        raise ValueError(f"kernel E is built for K in {SUPPORTED_BINS}, got "
                         f"K={num_bins}")
    shapes = (h_t.shape, w.shape, b.shape, tb.shape, cty.shape, ctl.shape)
    want = ((H, B), (m, H), (m,), (D,), (D, B), (D, B))
    if m != (2 * num_bins + _dplanes(num_bins, tails)) * D or shapes != want:
        raise ValueError(f"kernel E shapes: x_t {tuple(x_t.shape)}, then "
                         f"{[tuple(s) for s in shapes]}; expected {want} with "
                         f"m = (2K + nd) * D for K={num_bins}, "
                         f"tails={tails!r}")
    smem = kernel_e_shared_bytes(m, D, H)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"kernel E needs {smem} bytes of shared memory per "
                         f"block at {m} head rows over {D} features and "
                         f"hidden {H}; the H100 gives {_MAX_SHARED_BYTES}")
    for t in (x_t, h_t, w, b, tb, cty, ctl):
        if t.dtype != torch.float32 or t.device != x_t.device:
            raise TypeError(f"kernel E takes float32 operands on "
                            f"{x_t.device}, got {t.dtype} on {t.device}")
    lib = _build.load(f"head_rqs_bwd@{num_bins}")
    fn = lib.head_rqs_bwd_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   * 2
                   + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    blocks = (B + _E_THREADS - 1) // _E_THREADS
    gx = torch.empty((D, B), dtype=x_t.dtype, device=x_t.device)
    gh = torch.empty((H, B), dtype=x_t.dtype, device=x_t.device)
    gw = torch.empty((m, H), dtype=x_t.dtype, device=x_t.device)
    gb = torch.empty((m,), dtype=x_t.dtype, device=x_t.device)
    partials = torch.empty((max(blocks, 1), m * (H + 1)), dtype=x_t.dtype,
                           device=x_t.device)
    err = fn(x_t.data_ptr(), x_t.stride(0), x_t.stride(1), h_t.data_ptr(),
             w.data_ptr(), b.data_ptr(), tb.data_ptr(),
             cty.data_ptr(), cty.stride(0), cty.stride(1),
             ctl.data_ptr(), ctl.stride(0), ctl.stride(1), D, B, H,
             num_bins, int(tails == "circular"), int(bool(inverse)),
             linear_tail_constant(md), mbw, mbh, md, gx.data_ptr(),
             gh.data_ptr(), gw.data_ptr(), gb.data_ptr(),
             partials.data_ptr(),
             torch.cuda.current_stream(x_t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"head_rqs_bwd kernel launch failed: CUDA error {err}")
    fused_head_rqs_bwd.launches += 1
    return gx, gh, gw, gb


def fused_head_rqs_bwd(x_t, h_t, head_weight, head_bias, tb, cty, ctl, *,
                       num_bins, tails, inverse,
                       min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                       min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                       min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel E on CUDA tensors (the operands of :func:`head_rqs_bwd_plain`)
    -> ``(gx, gh, gW, gb)``: the backward :func:`fused_head_rqs` runs,
    exposed for the parity checks."""
    if x_t.device.type != "cuda":
        raise ValueError(f"kernel E runs on CUDA tensors, got {x_t.device}")
    return _launch_bwd(x_t, h_t.contiguous(), head_weight.contiguous(),
                       head_bias.contiguous(), tb.contiguous(), cty, ctl,
                       num_bins=num_bins, tails=tails, inverse=inverse,
                       mbw=float(min_bin_width), mbh=float(min_bin_height),
                       md=float(min_derivative))


class _HeadRQSFunction(torch.autograd.Function):
    """Kernel B forward, kernel E backward. The residuals are the inputs,
    as in the JAX custom VJP (``spline_head_fused.py:263-276``); the tail
    bound gets no gradient."""

    @staticmethod
    def forward(ctx, x_t, h_t, w, b, tb, kw):
        ctx.save_for_backward(x_t, h_t, w, b, tb)
        ctx.kw = kw
        return _launch(x_t, h_t, w, b, tb, **kw)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        gx, gh, gw, gb = _launch_bwd(*ctx.saved_tensors, gy, gld, **ctx.kw)
        return gx, gh, gw, gb, None, None


def fused_head_rqs(
    x_t,
    h_t,
    head_weight,
    head_bias,
    *,
    num_bins,
    tails="linear",
    tail_bound=1.0,
    inverse=False,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Head product + unconstrained RQ spline (``spline_head_fused.py:279``).

    ``x_t`` (D, B) feature-major inputs; ``h_t`` (H, B) transposed hidden
    activations (``ResidualNet.features_transposed``); ``head_weight``
    ((2K+nd)*D, H) the EFFECTIVE bin-major head rows (softmax scale folded
    in, :func:`effective_head`); ``head_bias`` ((2K+nd)*D,) or None.
    ``tails``: 'linear' or 'circular'. ``tail_bound``: scalar or (D,).
    Returns ``(y (D, B), log_det (D, B))``.
    """
    if tails not in ("linear", "circular"):
        raise ValueError(f"fused head takes homogeneous 'linear' or "
                         f"'circular' tails, got {tails!r}")
    D, B = x_t.shape
    K = int(num_bins)
    m = (2 * K + _dplanes(K, tails)) * D
    if head_bias is None:
        head_bias = torch.zeros(m, dtype=x_t.dtype, device=x_t.device)
    if isinstance(tail_bound, torch.Tensor):
        tb = torch.broadcast_to(tail_bound.reshape(-1), (D,))
    else:  # a fill, not a host-to-device copy (which would sync the host)
        tb = torch.full((D,), float(tail_bound), dtype=x_t.dtype,
                        device=x_t.device)
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    if x_t.device.type == "cpu":
        return head_rqs_plain(x_t, h_t, head_weight, head_bias, tb,
                              min_bin_width=min_bin_width,
                              min_bin_height=min_bin_height,
                              min_derivative=min_derivative, **kw)
    if x_t.device.type != "cuda":
        raise ValueError(f"no fused head kernel for device {x_t.device}")
    if K not in SUPPORTED_BINS:
        raise ValueError(f"the fused head kernel is built for K in "
                         f"{SUPPORTED_BINS}, got K={K}")
    H = h_t.shape[0]
    if (h_t.shape != (H, B) or head_weight.shape != (m, H)
            or head_bias.shape != (m,)):
        raise ValueError(
            f"fused head shapes: x_t {tuple(x_t.shape)}, h_t "
            f"{tuple(h_t.shape)}, weight {tuple(head_weight.shape)}, bias "
            f"{tuple(head_bias.shape)}; expected weight ({m}, H), bias "
            f"({m},) for K={K}, tails={tails!r}")
    operands = (x_t, h_t, head_weight, head_bias, tb)
    for t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused head kernel takes float32, got "
                            f"{t.dtype}")
        if t.device != x_t.device:
            raise ValueError("all operands must be on the same CUDA device")
    kw.update(mbw=float(min_bin_width), mbh=float(min_bin_height),
              md=float(min_derivative))
    return _HeadRQSFunction.apply(
        x_t, h_t.contiguous(), head_weight.contiguous(),
        head_bias.contiguous(), tb.contiguous(), kw)


fused_head_rqs.launches = 0
fused_head_rqs_bwd.launches = 0
