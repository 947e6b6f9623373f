"""Kernel A: the standalone unconstrained RQ-spline kernel, forward
direction (value and log-det) in both spline directions.

Replaces ``nf_tpu/ops/splines_pallas.py:_rqs_kernel`` (launcher
``_pallas_impl``, :450). The CUDA source is ``csrc/rqs_fwd.cu``; its
per-element math, shared with kernel B, is ``csrc/rqs_math.cuh``. What
bounds it on the H100 and what the design does about it is noted there.

Beside the kernel:

* :func:`rqs_plain`, the plain PyTorch version: a port of
  ``splines_pallas._rqs_math`` on ``(K, ...)`` planes. CPU tensors use it,
  and the tests and ``chip_smoke.py`` hold the kernel against it;
* :func:`rqs_fwd`, the wrapper: a CUDA tensor launches the kernel (or the
  call raises), a CPU tensor runs :func:`rqs_plain`;
* ``rqs_fwd.launches``, the count of kernel launches.

Both layouts of the JAX package enter here: :func:`fused_unconstrained_rqs`
(bin-minor ``(..., K)``, ``splines_pallas.py:605``) and
:func:`fused_unconstrained_rqs_kmajor` (bin-major ``(K, ...)``, :644). They
hand the kernel strided views, so broadcast parameters (stride 0) and
transposed inputs are never copied.

There is no backward kernel yet: a CUDA call that would need a gradient
raises ``NotImplementedError``. On the CPU the plain version keeps full
autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.nn import softplus
from .splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
)

SUPPORTED_BINS = (4, 8, 10)  # the K values csrc/rqs_fwd.cu instantiates
NO_BACKWARD = ("backward kernels arrive with the training slice: this CUDA "
               "call needs a gradient (run it under torch.no_grad() or "
               "torch.inference_mode(), or on the CPU)")


# --- plain version ---------------------------------------------------------

def _normalized_sizes(rows, min_size):
    m = rows[0]
    for r in rows[1:]:
        m = torch.maximum(m, r)
    exps = [torch.exp(r - m) for r in rows]
    total = exps[0]
    for e in exps[1:]:
        total = total + e
    si = (1.0 - min_size * len(rows)) * (1.0 / total)
    return [min_size + e * si for e in exps]


def _knots(sizes, tb):
    lo = -tb
    span = tb - lo
    cums = [lo]
    acc = None
    for k in range(len(sizes) - 1):
        acc = sizes[k] if acc is None else acc + sizes[k]
        cums.append(lo + span * acc)
    cums.append(tb)
    return [cums[k + 1] - cums[k] for k in range(len(sizes))], cums


def rqs_plain(x, w, h, d, tb, *, inverse, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
              min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
              min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch ``_rqs_math``: ``x`` and ``tb`` (...), ``w``/``h``
    (K, ...) and ``d`` (K+1, ...) planes (sequences or stacked tensors),
    each plane broadcastable to ``x`` -> ``(y, log_det)`` shaped like x."""
    K = len(w)
    if not isinstance(tb, torch.Tensor):
        tb = float(tb)  # a Python number: no host-to-device copy
    widths, cumw = _knots(_normalized_sizes([w[k] for k in range(K)],
                                            min_bin_width), tb)
    heights, cumh = _knots(_normalized_sizes([h[k] for k in range(K)],
                                             min_bin_height), tb)
    xin = torch.clamp(x, -tb, tb)
    cref = cumh if inverse else cumw
    steps = ([torch.ones_like(xin, dtype=torch.bool)]
             + [xin >= cref[k] for k in range(1, K)]
             + [torch.zeros_like(xin, dtype=torch.bool)])
    masks = [steps[k] & ~steps[k + 1] for k in range(K)]

    def select(rows):
        out = torch.where(masks[0], rows[0], 0.0)
        for k in range(1, K):
            out = out + torch.where(masks[k], rows[k], 0.0)
        return out

    in_cw = select(cumw[:K])
    in_w = select(widths)
    in_ch = select(cumh[:K])
    in_h = select(heights)
    in_d = min_derivative + softplus(select([d[k] for k in range(K)]))
    in_dp1 = min_derivative + softplus(select([d[k + 1] for k in range(K)]))
    in_delta = in_h / in_w
    d_sum = in_d + in_dp1 - 2.0 * in_delta

    if inverse:
        dy = xin - in_ch
        a = dy * d_sum + in_h * (in_delta - in_d)
        b = in_h * in_d - dy * d_sum
        c = -in_delta * dy
        disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
        root = (2.0 * c) / (-b - torch.sqrt(disc))
        y = root * in_w + in_cw
        t1mt = root * (1.0 - root)
        denom = in_delta + d_sum * t1mt
        dnum = in_delta * in_delta * (
            in_dp1 * root * root + 2.0 * in_delta * t1mt
            + in_d * (1.0 - root) * (1.0 - root))
        ld = -(torch.log(dnum) - 2.0 * torch.log(denom))
    else:
        theta = (xin - in_cw) / in_w
        t1mt = theta * (1.0 - theta)
        numer = in_h * (in_delta * theta * theta + in_d * t1mt)
        denom = in_delta + d_sum * t1mt
        y = in_ch + numer / denom
        dnum = in_delta * in_delta * (
            in_dp1 * theta * theta + 2.0 * in_delta * t1mt
            + in_d * (1.0 - theta) * (1.0 - theta))
        ld = torch.log(dnum) - 2.0 * torch.log(denom)

    inside = (x >= -tb) & (x <= tb)
    return torch.where(inside, y, x), torch.where(inside, ld, 0.0)


# --- kernel wrapper ----------------------------------------------------------

def _as_2d(x):
    if x.ndim == 2:
        return x
    if x.ndim == 1:
        return x[None]
    raise NotImplementedError(
        f"the CUDA spline kernel takes 1D or 2D inputs, got {x.ndim}D "
        "(the 4D image feed arrives with the image slice)")


def kernel_strides(x, w, h, d, tb):
    """The 13 element strides ``csrc/rqs_fwd.cu`` reads: x (rows, cols);
    w, h (K, rows, cols); d (K+1, rows, cols); tb (rows, cols) or None."""
    out = list(x.stride())
    for t in (w, h, d):
        out += list(t.stride())
    out += list(tb.stride()) if tb is not None else [0, 0]
    return out


def _check(x, planes, tb, num_bins):
    if num_bins not in SUPPORTED_BINS:
        raise ValueError(f"the CUDA spline kernel is built for K in "
                         f"{SUPPORTED_BINS}, got K={num_bins}")
    for t in (x, *planes) + ((tb,) if tb is not None else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA spline kernel takes float32, "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError("all operands must be on the same CUDA device")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *planes)
            + ((tb,) if tb is not None else ())):
        raise NotImplementedError(NO_BACKWARD)


def _launch(x2, w, h, d, tb, inverse, mbw, mbh, md):
    """Launch kernel A on a 2D ``x2`` with (K, rows, cols) parameter views
    and an optional (rows, cols) ``tb`` view (None: a Python float)."""
    from . import _build

    lib = _build.load("rqs_fwd")
    fn = lib.rqs_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    rows, cols = x2.shape
    tb_t = tb if isinstance(tb, torch.Tensor) else None
    tb_scalar = 0.0 if tb_t is not None else float(tb)
    strides = (ctypes.c_longlong * 13)(*kernel_strides(x2, w, h, d, tb_t))
    y = torch.empty((rows, cols), dtype=x2.dtype, device=x2.device)
    ld = torch.empty_like(y)
    err = fn(x2.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
             tb_t.data_ptr() if tb_t is not None else None, tb_scalar,
             strides, rows, cols, w.shape[0], int(bool(inverse)), mbw, mbh,
             md, y.data_ptr(), ld.data_ptr(),
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rqs_fwd kernel launch failed: CUDA error {err}")
    rqs_fwd.launches += 1
    return y, ld


def rqs_fwd(x, w, h, d, tb, *, inverse,
            min_bin_width=DEFAULT_MIN_BIN_WIDTH,
            min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
            min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel A: ``x`` (rows, cols) or (n,); ``w``/``h`` (K, *x.shape) and
    ``d`` (K+1, *x.shape), any strides (``.expand`` views included);
    ``tb`` a float or a tensor broadcastable to ``x``. Returns
    ``(y, log_det)`` shaped like ``x``. CUDA -> the kernel; CPU ->
    :func:`rqs_plain`."""
    kw = dict(inverse=inverse, min_bin_width=min_bin_width,
              min_bin_height=min_bin_height, min_derivative=min_derivative)
    if x.device.type == "cpu":
        return rqs_plain(x, w, h, d, tb, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no spline kernel for device {x.device}")
    K = w.shape[0]
    if h.shape[0] != K or d.shape[0] != K + 1:
        raise ValueError(f"expected K={K} width/height planes and K+1 "
                         f"derivative planes, got {h.shape[0]} and "
                         f"{d.shape[0]}")
    if isinstance(tb, torch.Tensor) and tb.numel() == 1:
        # one element: by value from the host, or a 0-d view that expands
        # with stride 0 on the card (reading it back would sync the host)
        tb = float(tb) if tb.device.type == "cpu" else tb.reshape(())
    _check(x, (w, h, d), tb if isinstance(tb, torch.Tensor) else None, K)
    x2, w3, h3, d3, tb = kernel_views(x, w, h, d, tb)
    y, ld = _launch(x2, w3, h3, d3, tb, inverse, float(min_bin_width),
                    float(min_bin_height), float(min_derivative))
    return y.view(x.shape), ld.view(x.shape)


def kernel_views(x, w, h, d, tb):
    """The views kernel A is launched on, none of them copied: ``x`` as
    (rows, cols); ``w``/``h``/``d`` as (planes, rows, cols), broadcast with
    ``expand`` (stride 0 where a parameter is shared); a tensor ``tb`` as
    (rows, cols) (a float stays a float)."""
    x2 = _as_2d(x)
    try:
        w3, h3, d3 = (t.expand(t.shape[0], *x.shape) for t in (w, h, d))
        if isinstance(tb, torch.Tensor):
            tb = tb.expand(x.shape)
    except RuntimeError as e:
        raise ValueError(f"spline parameters {tuple(w.shape)} do not "
                         f"broadcast to (K, {tuple(x.shape)})") from e
    if x.ndim == 1:
        w3, h3, d3 = w3[:, None], h3[:, None], d3[:, None]
        if isinstance(tb, torch.Tensor):
            tb = tb[None]
    return x2, w3, h3, d3, tb


rqs_fwd.launches = 0


# --- the JAX package's two entry points --------------------------------------

def fused_unconstrained_rqs(
    inputs, unnormalized_widths, unnormalized_heights, padded_derivatives,
    tail_bound, inverse=False, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Bin-MINOR entry (``splines_pallas.py:605``): widths/heights
    ``(..., K)`` and padded derivatives ``(..., K+1)``, broadcastable to
    ``inputs.shape + (K,)``."""
    K = unnormalized_widths.shape[-1]
    shape = tuple(inputs.shape)
    w = unnormalized_widths.expand(*shape, K).movedim(-1, 0)
    h = unnormalized_heights.expand(*shape, K).movedim(-1, 0)
    d = padded_derivatives.expand(*shape, K + 1).movedim(-1, 0)
    return rqs_fwd(inputs, w, h, d, tail_bound, inverse=inverse,
                   min_bin_width=min_bin_width, min_bin_height=min_bin_height,
                   min_derivative=min_derivative)


def fused_unconstrained_rqs_kmajor(
    inputs, unnormalized_widths, unnormalized_heights, padded_derivatives,
    tail_bound, inverse=False, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Bin-MAJOR entry (``splines_pallas.py:644``): widths/heights
    ``(K, ...)`` and padded derivatives ``(K+1, ...)``."""
    return rqs_fwd(inputs, unnormalized_widths, unnormalized_heights,
                   padded_derivatives, tail_bound, inverse=inverse,
                   min_bin_width=min_bin_width, min_bin_height=min_bin_height,
                   min_derivative=min_derivative)


def rqs_ops_per_element(num_bins, inverse):
    """Arithmetic operations per element of the spline, for the roofline
    bound in ``chip_smoke.py``: two floored softmaxes (max, subtract, exp,
    add, scale: 5K each) and knot sums (3K each), K bin-search compares,
    six K-way masked selects (2K each), two softplus (4 each) and the RQ
    map with its log-det (~30 forward, ~40 inverse with the root)."""
    K = num_bins
    return 2 * 5 * K + 2 * 3 * K + K + 6 * 2 * K + 8 + (40 if inverse else 30)
