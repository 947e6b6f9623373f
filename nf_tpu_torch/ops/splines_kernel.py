"""Kernels A and C: the standalone unconstrained RQ spline, its value and
log-det (A) and their analytic backward (C), in both spline directions.

Kernel A replaces ``nf_tpu/ops/splines_pallas.py:_rqs_kernel`` (launcher
``_pallas_impl``, :450); its CUDA source is ``csrc/rqs_fwd.cu``, its
per-element math, shared with kernel B, ``csrc/rqs_math.cuh``. Kernel C
replaces ``_rqs_bwd_kernel_analytic`` (launcher ``_pallas_bwd_impl``,
:474); its CUDA source is ``csrc/rqs_bwd.cu``, its per-element math,
shared with kernel E, ``csrc/rqs_bwd_math.cuh``. What bounds each on the
H100 and what the design does about it is noted in the sources.

Beside the kernels:

* :func:`rqs_plain` and :func:`rqs_bwd_plain`, the plain PyTorch versions:
  ports of ``splines_pallas._rqs_math`` and ``_rqs_bwd_math`` on
  ``(K, ...)`` planes. CPU tensors use :func:`rqs_plain` (with ordinary
  autograd), and the tests and ``chip_smoke.py`` hold the kernels against
  both;
* :func:`rqs_fwd`, the wrapper: a CUDA tensor goes through
  :class:`_RQSFunction`, whose forward launches kernel A and whose
  backward launches kernel C (or the call raises); a CPU tensor runs
  :func:`rqs_plain`;
* ``rqs_fwd.launches`` and ``rqs_bwd.launches``, the counts of launches.

Both layouts of the JAX package enter here: :func:`fused_unconstrained_rqs`
(bin-minor ``(..., K)``, ``splines_pallas.py:605``) and
:func:`fused_unconstrained_rqs_kmajor` (bin-major ``(K, ...)``, :644). They
hand the kernels strided views, so broadcast parameters (stride 0) and
transposed inputs are never copied. Kernel C writes its parameter
cotangents into fresh contiguous ``(K, rows, cols)`` planes; where a
parameter was broadcast, autograd's ``expand`` backward sums them, as XLA
sums the transpose of the JAX package's broadcast.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..utils.nn import softplus
from .splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
)

SUPPORTED_BINS = (4, 8, 10)  # the K values the CUDA sources instantiate


# --- plain versions ----------------------------------------------------------

def _softmax_terms(rows, min_size):
    """``(sizes, exps, 1/total, c)``: the floored softmax ``min_size + c *
    softmax`` with ``c = 1 - min_size * K``, and the terms its transpose
    reuses (``splines_pallas._normalized_sizes``)."""
    m = rows[0]
    for r in rows[1:]:
        m = torch.maximum(m, r)
    exps = [torch.exp(r - m) for r in rows]
    total = exps[0]
    for e in exps[1:]:
        total = total + e
    c = 1.0 - min_size * len(rows)
    inv_total = 1.0 / total
    si = c * inv_total
    return [min_size + e * si for e in exps], exps, inv_total, c


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
    widths, cumw = _knots(_softmax_terms([w[k] for k in range(K)],
                                         min_bin_width)[0], tb)
    heights, cumh = _knots(_softmax_terms([h[k] for k in range(K)],
                                          min_bin_height)[0], tb)
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


def rqs_bwd_plain(x, w, h, d, tb, cty, ctl, *, inverse,
                  min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                  min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                  min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch ``_rqs_bwd_math`` (``splines_pallas.py:241``): the
    operands of :func:`rqs_plain` plus the cotangents ``cty``, ``ctl`` of
    ``(y, log_det)`` -> ``(gx, gw (K, *x.shape), gh (K, ...), gd (K+1,
    ...))``, one gradient per element (broadcast parameters are not summed
    here). The tail bound gets none. Recompute, then the hand-derived
    transpose: ``du/dtheta = wd * J``; the inverse differentiates the root
    implicitly through the forward equation; the softmax gradients go
    through the pinned knots from the bin-search step planes."""
    K = len(w)
    if not isinstance(tb, torch.Tensor):
        tb = float(tb)
    sz_w, exps_w, inv_tw, c_w = _softmax_terms([w[k] for k in range(K)],
                                               min_bin_width)
    sz_h, exps_h, inv_th, c_h = _softmax_terms([h[k] for k in range(K)],
                                               min_bin_height)
    sw = [e * inv_tw for e in exps_w]
    sh = [e * inv_th for e in exps_h]
    widths, cumw = _knots(sz_w, tb)
    heights, cumh = _knots(sz_h, tb)

    xin = torch.clamp(x, -tb, tb)
    cref = cumh if inverse else cumw
    steps_b = ([torch.ones_like(xin, dtype=torch.bool)]
               + [xin >= cref[k] for k in range(1, K)]
               + [torch.zeros_like(xin, dtype=torch.bool)])
    masks = [steps_b[k] & ~steps_b[k + 1] for k in range(K)]
    steps = [s.to(x.dtype) for s in steps_b]
    maskf = [m.to(x.dtype) for m in masks]

    def select(rows):
        out = torch.where(masks[0], rows[0], 0.0)
        for k in range(1, K):
            out = out + torch.where(masks[k], rows[k], 0.0)
        return out

    cw = select(cumw[:K])
    wd = select(widths)
    ch = select(cumh[:K])
    hh = select(heights)
    draw0 = select([d[k] for k in range(K)])
    draw1 = select([d[k + 1] for k in range(K)])
    d0 = min_derivative + softplus(draw0)
    d1 = min_derivative + softplus(draw1)
    sig0 = torch.sigmoid(draw0)
    sig1 = torch.sigmoid(draw1)
    delta = hh / wd
    s = d0 + d1 - 2.0 * delta

    if inverse:
        dy = xin - ch
        a = dy * s + hh * (delta - d0)
        b = hh * d0 - dy * s
        c2 = -delta * dy
        disc = torch.clamp_min(b * b - 4.0 * a * c2, 0.0)
        theta = (2.0 * c2) / (-b - torch.sqrt(disc))
        u = dy  # = numer/denom at the root, by the defining equation
    else:
        theta = (xin - cw) / wd

    t = theta * (1.0 - theta)
    om = 1.0 - theta
    dtdth = 1.0 - 2.0 * theta
    denom = delta + s * t
    inv_denom = 1.0 / denom
    if not inverse:
        u = hh * (delta * theta * theta + d0 * t) * inv_denom
    dnum = delta * delta * (d1 * theta * theta + 2.0 * delta * t
                            + d0 * om * om)
    inv_dnum = 1.0 / dnum
    J = dnum * inv_denom * inv_denom

    u_th = wd * J
    u_delta = (hh * theta * theta - u * (1.0 - 2.0 * t)) * inv_denom
    u_d0 = t * (hh - u) * inv_denom
    u_d1 = -u * t * inv_denom
    u_hh = u / hh
    denom_th = s * dtdth
    dnum_th = delta * delta * (2.0 * d1 * theta + 2.0 * delta * dtdth
                               - 2.0 * d0 * om)
    ld_th = dnum_th * inv_dnum - 2.0 * denom_th * inv_denom
    ld_delta = (2.0 / delta + 2.0 * delta * delta * t * inv_dnum
                - 2.0 * (1.0 - 2.0 * t) * inv_denom)
    ld_d0 = delta * delta * om * om * inv_dnum - 2.0 * t * inv_denom
    ld_d1 = (delta * delta * theta * theta * inv_dnum
             - 2.0 * t * inv_denom)

    if inverse:
        A = cty * wd - ctl * ld_th
        inv_uth = 1.0 / u_th
        g_x_in = A * inv_uth
        g_delta = -A * u_delta * inv_uth - ctl * ld_delta
        g_d0 = -A * u_d0 * inv_uth - ctl * ld_d0
        g_d1 = -A * u_d1 * inv_uth - ctl * ld_d1
        g_hh = -A * u_hh * inv_uth + g_delta / wd
        g_ch = -g_x_in
        g_cw = cty
        g_wd = cty * theta - g_delta * delta / wd
    else:
        g_th = cty * u_th + ctl * ld_th
        g_delta = cty * u_delta + ctl * ld_delta
        g_d0 = cty * u_d0 + ctl * ld_d0
        g_d1 = cty * u_d1 + ctl * ld_d1
        g_hh = cty * u_hh + g_delta / wd
        g_wd = -(g_th * theta + g_delta * delta) / wd
        g_x_in = g_th / wd
        g_cw = -g_x_in
        g_ch = cty

    inside = (x >= -tb) & (x <= tb)

    def zero_out(v):  # identity tail: parameters get no gradient outside
        return torch.where(inside, v, 0.0)

    gsp0 = g_d0 * sig0
    gsp1 = g_d1 * sig1
    gd = [zero_out(torch.where(masks[0], gsp0, 0.0))]
    for k in range(1, K):
        gd.append(zero_out(torch.where(masks[k], gsp0, 0.0)
                           + torch.where(masks[k - 1], gsp1, 0.0)))
    gd.append(zero_out(torch.where(masks[K - 1], gsp1, 0.0)))

    span = 2.0 * tb
    m_last = maskf[K - 1]

    def logits_grad(g_cum, g_size, sm, c):
        a = (span * c) * g_cum
        b2 = (span * c) * g_size
        bm = b2 * m_last
        gsm = [a * steps[j + 1] + b2 * maskf[j] - bm for j in range(K - 1)]
        gsm.append(torch.zeros_like(xin))  # size_{K-1} is pinned away
        S = sm[0] * gsm[0]
        for j in range(1, K - 1):
            S = S + sm[j] * gsm[j]
        return torch.stack([zero_out(sm[j] * (gsm[j] - S))
                            for j in range(K)])

    gw = logits_grad(g_cw, g_wd, sw, c_w)
    gh = logits_grad(g_ch, g_hh, sh, c_h)
    gx = torch.where(inside, g_x_in, cty)
    return gx, gw, gh, torch.stack(gd)


# --- kernel wrappers ---------------------------------------------------------

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


def _launch_bwd(x2, w, h, d, tb, cty, ctl, inverse, mbw, mbh, md):
    """Launch kernel C on the operands of :func:`_launch` plus the (rows,
    cols) cotangents (any strides) -> fresh contiguous ``gx`` (rows, cols),
    ``gw``/``gh`` (K, rows, cols), ``gd`` (K+1, rows, cols)."""
    from . import _build

    lib = _build.load("rqs_bwd")
    fn = lib.rqs_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    for t in (cty, ctl):
        if t.dtype != torch.float32 or t.device != x2.device:
            raise TypeError(f"kernel C takes float32 cotangents on "
                            f"{x2.device}, got {t.dtype} on {t.device}")
    rows, cols = x2.shape
    K = w.shape[0]
    tb_t = tb if isinstance(tb, torch.Tensor) else None
    tb_scalar = 0.0 if tb_t is not None else float(tb)
    strides = (ctypes.c_longlong * 17)(
        *kernel_strides(x2, w, h, d, tb_t), *cty.stride(), *ctl.stride())
    gx = torch.empty((rows, cols), dtype=x2.dtype, device=x2.device)
    gw = torch.empty((K, rows, cols), dtype=x2.dtype, device=x2.device)
    gh = torch.empty_like(gw)
    gd = torch.empty((K + 1, rows, cols), dtype=x2.dtype, device=x2.device)
    err = fn(x2.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
             tb_t.data_ptr() if tb_t is not None else None, cty.data_ptr(),
             ctl.data_ptr(), tb_scalar, strides, rows, cols, K,
             int(bool(inverse)), mbw, mbh, md, gx.data_ptr(), gw.data_ptr(),
             gh.data_ptr(), gd.data_ptr(),
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rqs_bwd kernel launch failed: CUDA error {err}")
    rqs_bwd.launches += 1
    return gx, gw, gh, gd


def rqs_bwd(x, w, h, d, tb, cty, ctl, *, inverse,
            min_bin_width=DEFAULT_MIN_BIN_WIDTH,
            min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
            min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel C on the operands of :func:`rqs_fwd` and the cotangents of
    its ``(y, log_det)`` -> ``(gx, gw, gh, gd)``, one gradient per element
    as :func:`rqs_bwd_plain` returns them. CUDA tensors only: this is the
    backward :func:`rqs_fwd` runs, exposed for the parity checks."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel C runs on CUDA tensors, got {x.device}")
    K = w.shape[0]
    _check(x, (w, h, d), tb if isinstance(tb, torch.Tensor) else None, K)
    x2, w3, h3, d3, tb = kernel_views(x, w, h, d, tb)
    gx, gw, gh, gd = _launch_bwd(
        x2, w3, h3, d3, tb, cty.reshape(x2.shape), ctl.reshape(x2.shape),
        inverse, float(min_bin_width), float(min_bin_height),
        float(min_derivative))
    return (gx.view(x.shape), gw.view(K, *x.shape), gh.view(K, *x.shape),
            gd.view(K + 1, *x.shape))


class _RQSFunction(torch.autograd.Function):
    """Kernel A forward, kernel C backward. The residuals are the inputs,
    as in the JAX custom VJP (``splines_pallas.py:556-563``); the tail
    bound gets no gradient."""

    @staticmethod
    def forward(ctx, x2, w3, h3, d3, tb, opts):
        tb_t = tb if isinstance(tb, torch.Tensor) else None
        ctx.save_for_backward(x2, w3, h3, d3, tb_t)
        ctx.tb_scalar = None if tb_t is not None else tb
        ctx.opts = opts
        return _launch(x2, w3, h3, d3, tb, *opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        x2, w3, h3, d3, tb_t = ctx.saved_tensors
        tb = tb_t if tb_t is not None else ctx.tb_scalar
        gx, gw, gh, gd = _launch_bwd(x2, w3, h3, d3, tb, gy, gld, *ctx.opts)
        return gx, gw, gh, gd, None, None


def rqs_fwd(x, w, h, d, tb, *, inverse,
            min_bin_width=DEFAULT_MIN_BIN_WIDTH,
            min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
            min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel A: ``x`` (rows, cols) or (n,); ``w``/``h`` (K, *x.shape) and
    ``d`` (K+1, *x.shape), any strides (``.expand`` views included);
    ``tb`` a float or a tensor broadcastable to ``x``. Returns
    ``(y, log_det)`` shaped like ``x``. CUDA -> kernel A, differentiable
    through kernel C; CPU -> :func:`rqs_plain`."""
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
    y, ld = _RQSFunction.apply(
        x2, w3, h3, d3, tb, (bool(inverse), float(min_bin_width),
                             float(min_bin_height), float(min_derivative)))
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
rqs_bwd.launches = 0


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


def rqs_bwd_ops_per_element(num_bins, inverse):
    """Arithmetic operations per element of the backward, for the bound in
    ``chip_smoke.py``: the recompute (the forward's count less its log-det,
    plus two sigmoids), ~70 for the partials and cotangents of the map
    (~80 inverse), the derivative planes (3 per plane) and the two
    softmax transposes (~6K each)."""
    K = num_bins
    return (rqs_ops_per_element(K, inverse) + 8 + (80 if inverse else 70)
            + 3 * (K + 1) + 2 * 6 * K)


def rqs_ops_per_element(num_bins, inverse):
    """Arithmetic operations per element of the spline, for the roofline
    bound in ``chip_smoke.py``: two floored softmaxes (max, subtract, exp,
    add, scale: 5K each) and knot sums (3K each), K bin-search compares,
    six K-way masked selects (2K each), two softplus (4 each) and the RQ
    map with its log-det (~30 forward, ~40 inverse with the root)."""
    K = num_bins
    return 2 * 5 * K + 2 * 3 * K + K + 6 * 2 * K + 8 + (40 if inverse else 30)
