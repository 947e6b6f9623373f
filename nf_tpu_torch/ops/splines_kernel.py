"""Kernels A, C and D: the standalone unconstrained RQ spline, its value
and log-det (A), their analytic backward (C) and their autodiff backward
(D), in both spline directions.

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
  ``(K, ...)`` planes (and :func:`rqs_bwd_shared_plain`, kernel C's
  shared-parameter path). CPU tensors use :func:`rqs_plain` (with ordinary
  autograd), and the tests and ``chip_smoke.py`` hold the kernels against
  both;
* :func:`rqs_fwd`, the wrapper: a CUDA tensor goes through the op
  ``torch.ops.nf_tpu_torch.rqs_fwd``, whose CUDA implementation launches
  kernel A and whose registered backward calls the op of kernel C (or the
  call raises); a CPU tensor runs :func:`rqs_plain` with ordinary
  autograd;
* the five ops (``rqs_fwd``, ``rqs_bwd``, ``rqs_bwd_shared``,
  ``rqs_bwd_autodiff`` here, the head's two in ``spline_head_fused``),
  registered with ``torch.library`` under ``nf_tpu_torch::``: a CUDA
  implementation (the launch), a CPU one (the plain version) and a fake
  one (the shapes), so that ``torch.export`` traces through them and an
  exported program carries one node per kernel launch;
* kernel D (``csrc/rqs_bwd_autodiff.cu``, replaces ``_rqs_bwd_kernel``,
  :220), the mechanical adjoint of ``_rqs_math`` that the JAX package
  traces with ``jax.vjp`` under ``set_pallas_bwd_kernel("autodiff")``;
  :func:`set_pallas_bwd_kernel` picks it here too, and
  :func:`rqs_vjp_plain` is its plain version;
* ``rqs_fwd.launches``, ``rqs_bwd.launches`` and
  ``rqs_bwd_autodiff.launches``, the counts of launches, kept on the host
  (a CUDA graph adds to them once, at its capture; ``ops.launch_counts``
  reads all five kernels' counts), and ``bf16_launches`` of each, those of
  them through the bfloat16 instantiation (``ops.bf16_launch_counts``;
  ``rqs_bwd.shared_bf16_launches``, those of C's shared-parameter path).

Kernels A, C (both its paths) and D take float32 or bfloat16 operands, all
of one dtype, and give outputs in it. The JAX package's
Pallas kernels are dtype-generic and run per operation in bfloat16; here a
bfloat16 kernel reads and writes 2-byte elements and computes in float32
between (``csrc/rqs_math.cuh``), and each plain version takes a bfloat16
input the same way (:func:`_in_float32`: widen, float32 math, round once).
That is the one design whose kernel-against-plain and port-against-JAX
float32 checks hold element by element: two per-operation bfloat16
implementations differ by more than a bfloat16 bar in places. Kernel C's
shared-parameter path keeps its per-block partials and their total in
float32 in bfloat16 too, and rounds the parameter sums once.

Both layouts of the JAX package enter here: :func:`fused_unconstrained_rqs`
(bin-minor ``(..., K)``, ``splines_pallas.py:605``) and
:func:`fused_unconstrained_rqs_kmajor` (bin-major ``(K, ...)``, :644). They
hand the kernels strided views, so broadcast parameters (stride 0) and
transposed inputs are never copied. An image ``(B, C, H, W)`` reaches the
kernels as ``(B*C, H*W)`` views (:func:`image_split`): the image
coupling's bin-major planes are a permuted view of its conditioner's
``(B, C*P, H, W)`` output, strides ``(H*W, C*P*H*W, P*H*W, W, 1)``, whose
(B, C) and (H, W) each merge into one axis; what cannot be viewed so
raises, and nothing is copied. The parameters enter the ``rqs_fwd`` op
in their broadcastable shape, and its backward
returns their gradients in that shape, summed over what was broadcast, as
XLA sums the transpose of the JAX package's broadcast: where every row
shares them (the unconditional CDF), kernel C's shared-parameter path
sums inside the kernel (:func:`rqs_bwd_shared`, plain version
:func:`rqs_bwd_shared_plain`); elsewhere kernel C or D writes one gradient
per element into fresh ``(K, rows, cols)`` planes, reduced with
``sum_to_size`` where a parameter was broadcast.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from ..utils.nn import softplus
from .splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    _in_float32,
)

SUPPORTED_BINS = (4, 8, 10)  # the K values the CUDA sources instantiate
# kernel A takes its shared-parameter path (csrc/rqs_fwd.cu kMaxSharedCols)
# for at most this many columns
SHARED_PARAM_MAX_COLS = 64
# kernel C's shared-parameter path: the rows each block of its first launch
# takes (csrc/rqs_bwd.cu kRowsPerBlock), and the cotangents it sums per
# (column, bin): g_cw, g_wd, g_ch, g_hh, g_d0, g_d1 (kSlots)
SHARED_BWD_ROWS_PER_BLOCK = 512
SHARED_BWD_SLOTS = 6
# the operand dtypes kernels A-E are instantiated for, and the C entry
# point's suffix of each
KERNEL_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
# the per-element path of kernels A, C and D (csrc/rqs_per_element.cuh): a
# warp takes RING_TILE consecutive elements, one a lane (kTile), in blocks
# of RING_WARPS warps (kWarps). Kernel D's ring (csrc/rqs_ring.cuh),
# launched where its one-tile form keeps at most RING_MAX_WARPS_PER_SM
# warps an SM and needs more than one wave (kRingWarps), holds RING_STAGES
# tiles of a warp in shared memory (kStages), and an operand whose every
# full tile is one run starting on RING_VECTOR_BYTES bytes (kVectorBytes)
# comes into it in copies of that size
RING_TILE = 32
RING_STAGES = 2
RING_WARPS = 4
RING_MAX_WARPS_PER_SM = 16
RING_VECTOR_BYTES = 16
# the operands in the order of the ring routes' bits (rqs_per_element.cuh's
# enum)
RING_OPERANDS = ("x", "w", "h", "d", "tb", "cty", "ctl")
# the largest element offset a call takes in 32-bit arithmetic: int32's
# limit less a margin for the tile indices a warp of D's ring steps past
# the end (at most two steps of every resident thread)
OFFSETS32_LIMIT = 2 ** 31 - 2 ** 22


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


@_in_float32
def rqs_plain(x, w, h, d, tb, *, inverse, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
              min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
              min_derivative=DEFAULT_MIN_DERIVATIVE, split_ties=False):
    """Plain PyTorch ``_rqs_math``: ``x`` and ``tb`` (...), ``w``/``h``
    (K, ...) and ``d`` (K+1, ...) planes (sequences or stacked tensors),
    each plane broadcastable to ``x`` -> ``(y, log_det)`` shaped like x.

    The values do not depend on ``split_ties``; its autograd does. With
    ``split_ties=True`` the clip into ``[-tb, tb]``, the floor of the
    root's discriminant and the softplus take ``torch.minimum`` and
    ``torch.maximum``, whose gradient at a tie is half on each side, as
    JAX's (``jnp.clip``, ``jnp.maximum``, the JVP of ``jnp.logaddexp``);
    ``torch.clamp`` passes all of it. That is kernel D's plain version
    (:func:`rqs_vjp_plain`). A bfloat16 ``x`` is computed in float32 and
    rounded (:func:`_in_float32`), differentiably."""
    K = len(w)
    if not isinstance(tb, torch.Tensor):
        tb = float(tb)  # a Python number: no host-to-device copy
    if split_ties:
        def scalar(v):  # filled on the device: no host-to-device copy
            return torch.full((), v, dtype=x.dtype, device=x.device)

        def clip(v):
            lo = -tb if isinstance(tb, torch.Tensor) else scalar(-tb)
            hi = tb if isinstance(tb, torch.Tensor) else scalar(tb)
            return torch.minimum(torch.maximum(v, lo), hi)

        def floor0(v):
            return torch.maximum(v, scalar(0.0))

        def soft(v):
            return floor0(v) + torch.log1p(torch.exp(-torch.abs(v)))
    else:
        def clip(v):
            return torch.clamp(v, -tb, tb)

        def floor0(v):
            return torch.clamp_min(v, 0.0)

        soft = softplus
    widths, cumw = _knots(_softmax_terms([w[k] for k in range(K)],
                                         min_bin_width)[0], tb)
    heights, cumh = _knots(_softmax_terms([h[k] for k in range(K)],
                                          min_bin_height)[0], tb)
    xin = clip(x)
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
    in_d = min_derivative + soft(select([d[k] for k in range(K)]))
    in_dp1 = min_derivative + soft(select([d[k + 1] for k in range(K)]))
    in_delta = in_h / in_w
    d_sum = in_d + in_dp1 - 2.0 * in_delta

    if inverse:
        dy = xin - in_ch
        a = dy * d_sum + in_h * (in_delta - in_d)
        b = in_h * in_d - dy * d_sum
        c = -in_delta * dy
        disc = floor0(b * b - 4.0 * a * c)
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


def _map_cotangents(xin, cw, wd, ch, hh, d0, d1, cty, ctl, inverse):
    """The middle of ``_rqs_bwd_math``: an element's clipped input, its
    bin's left knots, width, height and end derivatives, and the
    cotangents of ``(y, log_det)`` -> ``(g_x_in, g_cw, g_wd, g_ch, g_hh,
    g_d0, g_d1)``, the cotangents of the clipped input and of the six
    selected values (``csrc/rqs_bwd_math.cuh`` ``rqs_bwd_map``).
    ``du/dtheta = wd * J``; the inverse differentiates the root implicitly
    through the forward equation."""
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

    return g_x_in, g_cw, g_wd, g_ch, g_hh, g_d0, g_d1


@_in_float32
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
    through the pinned knots from the bin-search step planes. A bfloat16
    ``x`` is computed in float32 and rounded (:func:`_in_float32`)."""
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
    g_x_in, g_cw, g_wd, g_ch, g_hh, g_d0, g_d1 = _map_cotangents(
        xin, cw, wd, ch, hh, d0, d1, cty, ctl, inverse)

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


def _row_shared(t, shape):
    """``t`` broadcast to ``shape`` and cut to its first row (``shape[-2]``):
    a ValueError unless every row of it is the same (row stride 0, or one
    row). With no rows, ``t`` broadcast to one."""
    if shape[-2] == 0:
        return t.expand(*shape[:-2], 1, shape[-1])
    full = t.expand(shape)
    if shape[-2] != 1 and full.stride(-2) != 0:
        raise ValueError(f"{tuple(t.shape)} is not shared by the rows of "
                         f"{tuple(shape)}")
    return full.narrow(-2, 0, 1)


def _logits_grad_sums(g_cum, g_size, sm, c, span):
    """``logits_grad`` of :func:`rqs_bwd_plain` summed over a column's
    elements (``csrc/rqs_bwd.cu`` ``logits_grad_sums``): ``g_cum[b]`` and
    ``g_size[b]`` sum the cotangents of the selected knot and size over the
    elements in bin ``b``. Element by element, bin ``b`` gives ``gsm[j] =
    span*c * ([j < b] g_cum + [j == b] g_size - [b == K-1] g_size)``; summed,
    ``gsm[j] = span*c * (sum_{b > j} g_cum[b] + g_size[j] - g_size[K-1])``
    for ``j < K-1``, and 0 for the pinned last size."""
    K = len(sm)
    sc = span * c
    gsm = [None] * (K - 1) + [torch.zeros_like(g_cum[0])]
    suffix = torch.zeros_like(g_cum[0])
    for j in range(K - 2, -1, -1):
        suffix = suffix + g_cum[j + 1]
        gsm[j] = sc * ((suffix + g_size[j]) - g_size[K - 1])
    S = sm[0] * gsm[0]
    for j in range(1, K - 1):
        S = S + sm[j] * gsm[j]
    return torch.stack([sm[j] * (gsm[j] - S) for j in range(K)])


@_in_float32
def rqs_bwd_shared_plain(x, w, h, d, tb, cty, ctl, *, inverse,
                         min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                         min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                         min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel C's shared-parameter path in plain PyTorch, in the kernel's
    order. ``x`` (rows, cols); ``w``, ``h`` (K, ...) and ``d`` (K+1, ...)
    broadcastable to ``(planes, rows, cols)`` and the same for every row
    (the unconditional CDF's parameters, (K, 1, cols) or expanded with row
    stride 0); ``tb`` a float or a tensor shared by the rows; cotangents
    broadcastable to ``x``. Returns ``gx`` (rows, cols) and the parameter
    cotangents summed over the rows: ``gw``, ``gh`` (K, 1, cols), ``gd``
    (K+1, 1, cols).

    Per column the knots, sizes and derivatives once; per element the bin
    and the cotangents of its six selected values (:func:`_map_cotangents`,
    nothing outside ``[-tb, tb]``); their sum per (column, bin); then per
    column the softmax/knot transposes (:func:`_logits_grad_sums`) and the
    derivatives' sigmoids. The sums equal those of :func:`rqs_bwd_plain`'s
    planes over the rows up to rounding. A bfloat16 ``x``: float32 math on
    the widened operands (the sums too), each result rounded once
    (:func:`_in_float32`), as the bfloat16 kernel computes it."""
    if x.ndim != 2:
        raise ValueError(f"x must be (rows, cols), got {tuple(x.shape)}")
    rows, cols = x.shape
    K = w.shape[0]
    wc, hc = (_row_shared(t, (K, rows, cols)) for t in (w, h))
    dc = _row_shared(d, (K + 1, rows, cols))
    if isinstance(tb, torch.Tensor):
        tb = _row_shared(tb, (rows, cols))
    else:
        tb = float(tb)
    sz_w, exps_w, inv_tw, c_w = _softmax_terms(list(wc), min_bin_width)
    sz_h, exps_h, inv_th, c_h = _softmax_terms(list(hc), min_bin_height)
    widths, cumw = _knots(sz_w, tb)
    heights, cumh = _knots(sz_h, tb)
    derivs = [min_derivative + softplus(dc[k]) for k in range(K + 1)]

    xin = torch.clamp(x, -tb, tb)
    cref = cumh if inverse else cumw
    bins = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    for k in range(1, K):
        bins = bins + (xin >= cref[k]).long()

    def take(table):  # the element's bin's entry of a column table
        t = torch.stack([v if isinstance(v, torch.Tensor) else torch.full(
            (1, cols), v, dtype=x.dtype, device=x.device) for v in table])
        return torch.gather(t.expand(len(table), rows, cols), 0,
                            bins[None])[0]

    g_x_in, *g = _map_cotangents(
        xin, take(cumw[:K]), take(widths), take(cumh[:K]), take(heights),
        take(derivs[:K]), take(derivs[1:]), cty, ctl, inverse)
    inside = (x >= -tb) & (x <= tb)
    # (6, K, 1, cols): the six cotangents summed per (column, bin)
    sums = torch.stack([
        torch.zeros((K, rows, cols), dtype=x.dtype, device=x.device)
        .scatter_(0, bins[None], torch.where(inside, v, 0.0)[None])
        .sum(1, keepdim=True) for v in g])
    span = 2.0 * tb
    gw = _logits_grad_sums(sums[0], sums[1], [e * inv_tw for e in exps_w],
                           c_w, span)
    gh = _logits_grad_sums(sums[2], sums[3], [e * inv_th for e in exps_h],
                           c_h, span)
    g_d0, g_d1 = sums[4], sums[5]
    gd = ([g_d0[0]] + [g_d0[k] + g_d1[k - 1] for k in range(1, K)]
          + [g_d1[K - 1]])
    gd = torch.stack([torch.sigmoid(dc[k]) * gd[k] for k in range(K + 1)])
    gx = torch.where(inside, g_x_in, cty)
    return gx, gw, gh, gd


@_in_float32
def rqs_vjp_plain(x, w, h, d, tb, cty, ctl, *, inverse,
                  min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                  min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                  min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel D's plain version, the counterpart of ``jax.vjp`` of
    ``_rqs_math`` (``splines_pallas.py:220-238``): PyTorch's autograd
    through :func:`rqs_plain` with ``split_ties=True``, so the inverse is
    differentiated through the root formula and ties split as in JAX.
    Operands and outputs as :func:`rqs_bwd_plain`: one gradient per element
    (broadcast parameters are not summed here); the tail bound gets none.
    A bfloat16 ``x`` is differentiated in float32 and the gradients rounded
    (:func:`_in_float32`)."""
    K = len(w)
    leaves = [x.detach().requires_grad_()] + [
        t.detach().expand(t.shape[0], *x.shape).requires_grad_()
        for t in (w, h, d)]
    if isinstance(tb, torch.Tensor):
        tb = tb.detach()
    with torch.enable_grad():
        y, ld = rqs_plain(*leaves, tb, inverse=inverse,
                          min_bin_width=min_bin_width,
                          min_bin_height=min_bin_height,
                          min_derivative=min_derivative, split_ties=True)
        gx, gw, gh, gd = torch.autograd.grad(
            (y, ld), leaves, (cty.expand(x.shape), ctl.expand(x.shape)),
            allow_unused=True)
    zeros = [torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                         device=x.device) for n in (K, K, K + 1)]
    return (gx, *(g if g is not None else z
                  for g, z in zip((gw, gh, gd), zeros)))


# --- kernel wrappers ---------------------------------------------------------

def _as_2d(x, split=None):
    """``x`` as the (rows, cols) view the kernels take: a 1D ``x`` is one
    row, a 4D image ``x`` merges its first ``split`` dims into the rows and
    the rest into the columns (:func:`image_split`). Raises ValueError
    where that needs a copy."""
    if x.ndim == 2:
        return x
    if x.ndim == 1:
        return x[None]
    if x.ndim != 4 or split is None:
        raise NotImplementedError(
            f"the CUDA spline kernel takes 1D, 2D or 4D inputs, got "
            f"{x.ndim}D")
    return _merged(x, (), x.shape, split)


def _merged(t, lead, shape, split):
    """``t`` (``lead`` dims, then four dims broadcastable to ``shape``) as a
    (``*lead``, r, c) view: its first ``split`` of the four dims merged
    into r and the rest into c, each side either ``shape``'s dims (r the
    rows) or all of size 1 (a broadcast). Raises ValueError where that is
    not a view of ``t``."""
    n = len(lead)
    dims = tuple(t.shape[n:])
    if len(dims) > 4:
        raise ValueError(f"{len(dims)} dims where a 4D input takes at most "
                         f"4")
    dims = (1,) * (4 - len(dims)) + dims
    sides = []
    for part, full in ((dims[:split], shape[:split]),
                       (dims[split:], shape[split:])):
        if tuple(part) == tuple(full):
            sides.append(math.prod(full))
        elif all(v == 1 for v in part):
            sides.append(1)
        else:
            raise ValueError(f"dims {dims} do not broadcast to {tuple(shape)}"
                             f" as ({split}, {4 - split}) halves")
    try:
        return t.reshape(tuple(lead) + dims).view(tuple(lead) + tuple(sides))
    except RuntimeError as e:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} and strides "
                         f"{t.stride()} cannot be viewed as {sides} without "
                         f"a copy") from e


def image_split(x, w, h, d, tb=None):
    """How a 4D ``x`` (B, C, H, W) is collapsed for the kernels, the same
    way for every operand and never by a copy: 2, rows B*C and columns
    H*W (the image coupling's bin-major planes, the permuted ``(P, B, C,
    H, W)`` view of its conditioner's output, whose (B, C) merge into one
    axis of stride P*H*W), else 1, rows B and columns C*H*W (parameters
    shared over the batch, as a ``PiecewiseRationalQuadraticCDF``'s).
    Raises ValueError when neither gives views."""
    errors = []
    for split in (2, 1):
        try:
            _as_2d(x, split)
            for t in (w, h, d):
                _merged(t, t.shape[:1], x.shape, split)
            if isinstance(tb, torch.Tensor):
                _merged(tb.expand(x.shape), (), x.shape, split)
            return split
        except ValueError as e:
            errors.append(str(e))
    raise ValueError("the 4D spline operands cannot be collapsed to the "
                     "kernel's (rows, cols) views without a copy: "
                     + "; ".join(errors))


def kernel_strides(x, w, h, d, tb):
    """The 13 element strides ``csrc/rqs_fwd.cu`` reads: x (rows, cols);
    w, h (K, rows, cols); d (K+1, rows, cols); tb (rows, cols) or None."""
    out = list(x.stride())
    for t in (w, h, d):
        out += list(t.stride())
    out += list(tb.stride()) if tb is not None else [0, 0]
    return out


def largest_offset(shape, stride):
    """The largest element offset of a view, 0 for an empty one."""
    if 0 in tuple(shape):
        return 0
    return sum((n - 1) * abs(st) for n, st in zip(shape, stride))


def vector_copies(shape, stride, address, itemsize, rows, cols):
    """Whether kernel D's ring copies an operand view of ``shape`` and
    ``stride`` ((rows, cols), or (planes, rows, cols)) starting at byte
    ``address`` in RING_VECTOR_BYTES pieces: each plane holds every full
    tile of RING_TILE consecutive elements (row-major over (rows, cols)) as
    one unit-stride run starting on RING_VECTOR_BYTES bytes. That is so
    when the plane is contiguous over (rows, cols), or when its columns are
    and every tile lies in one row (cols a multiple of RING_TILE) whose
    start is aligned. Else each lane copies its element (the 4-byte
    route)."""
    return (address % RING_VECTOR_BYTES == 0
            and _layout(tuple(shape), tuple(stride), itemsize, rows,
                        cols)[1])


@functools.lru_cache(maxsize=4096)
def _layout(shape, stride, itemsize, rows, cols):
    """``(largest_offset, vector_copies at an aligned address)`` of a view:
    what does not depend on where the view starts, kept per layout (a
    launch asks for it once per operand)."""
    *lead, rs, cs = stride
    v = RING_VECTOR_BYTES
    unit = cols == 1 or cs == 1
    linear = unit and (rows == 1 or rs == cols)
    in_row = (cs == 1 and cols % RING_TILE == 0
              and (rows == 1 or rs * itemsize % v == 0))
    vec = ((linear or in_row)
           and not (lead and shape[0] > 1 and lead[0] * itemsize % v))
    return largest_offset(shape, stride), vec


def _operands(x2, planes, tb, cotangents):
    """The per-element operands in :data:`RING_OPERANDS` order, None for a
    float tail bound."""
    return (x2, *planes, tb if isinstance(tb, torch.Tensor) else None,
            *cotangents)


def per_element_offsets32(x2, planes, tb, cotangents=(), out_planes=1):
    """Whether a per-element launch of kernel A (no ``cotangents``) or C /
    D (``cotangents`` ``(cty, ctl)``, (rows, cols) views) on the kernel
    views of :func:`kernel_views` (the planes expanded to (P, rows, cols),
    ``tb`` a (rows, cols) view or a float) takes 32-bit element offsets:
    every element offset of the call fits :data:`OFFSETS32_LIMIT`, the
    outputs' too (``out_planes`` planes of rows * cols, K + 1 for the
    backward's derivative gradients). The CUDA source takes it as given."""
    rows, cols = x2.shape
    largest = out_planes * rows * cols - 1
    for t in _operands(x2, planes, tb, cotangents):
        if t is not None:
            largest = max(largest, _layout(tuple(t.shape), t.stride(),
                                           t.element_size(), rows, cols)[0])
    return largest < OFFSETS32_LIMIT


def ring_routes(x2, planes, tb, cotangents):
    """Kernel D's ring routes on the same views: bit o
    (:data:`RING_OPERANDS` order) set where operand o comes in 16-byte
    copies (:func:`vector_copies`); a float tail bound leaves its bit
    clear. The CUDA source takes them as given: it inspects no pointer or
    stride to choose."""
    rows, cols = x2.shape
    routes = 0
    for bit, t in enumerate(_operands(x2, planes, tb, cotangents)):
        if t is not None and vector_copies(t.shape, t.stride(), t.data_ptr(),
                                           t.element_size(), rows, cols):
            routes |= 1 << bit
    return routes


def _check(x, planes, tb, num_bins):
    if num_bins not in SUPPORTED_BINS:
        raise ValueError(f"the CUDA spline kernel is built for K in "
                         f"{SUPPORTED_BINS}, got K={num_bins}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"kernel A (rqs_fwd, the CUDA spline kernel) takes "
                        f"float32 or bfloat16, got {x.dtype}")
    for t in (x, *planes) + ((tb,) if tb is not None else ()):
        if t.dtype != x.dtype:
            raise TypeError(f"kernel A (rqs_fwd) takes operands of one "
                            f"dtype: x is {x.dtype}, an operand {t.dtype}")
        if t.device != x.device:
            raise ValueError("all operands must be on the same CUDA device")


def _launch(x2, w, h, d, tb, inverse, mbw, mbh, md):
    """Launch kernel A on a 2D ``x2`` with (K, rows, cols) parameter views
    and an optional (rows, cols) ``tb`` view (None: a Python float)."""
    from . import _build

    lib = _build.load("rqs_fwd")
    fn = getattr(lib, "rqs_fwd_launch" + KERNEL_DTYPES[x2.dtype])
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rows, cols = x2.shape
    tb_t = tb if isinstance(tb, torch.Tensor) else None
    tb_scalar = 0.0 if tb_t is not None else float(tb)
    strides = (ctypes.c_longlong * 13)(*kernel_strides(x2, w, h, d, tb_t))
    offsets32 = per_element_offsets32(x2, (w, h, d), tb)
    y = torch.empty((rows, cols), dtype=x2.dtype, device=x2.device)
    ld = torch.empty_like(y)
    err = fn(x2.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
             tb_t.data_ptr() if tb_t is not None else None, tb_scalar,
             strides, rows, cols, w.shape[0], int(bool(inverse)), mbw, mbh,
             md, y.data_ptr(), ld.data_ptr(), int(offsets32),
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rqs_fwd kernel launch failed: CUDA error {err}")
    rqs_fwd.launches += 1
    rqs_fwd.bf16_launches += x2.dtype == torch.bfloat16
    return y, ld


# the C entry points' arguments up to min_derivative: x, w, h, d, tb, cty,
# ctl, tb_scalar, the strides, rows, cols, K, inverse and the three minima
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7
                 + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                 + [ctypes.c_float] * 3)


def _bwd_operands(name, x2, w, h, d, tb, cty, ctl):
    """Checks the cotangents; returns ``(tb tensor or None, tb scalar, the
    17 strides)`` of a backward launch."""
    for t in (cty, ctl):
        if t.dtype != x2.dtype or t.device != x2.device:
            raise TypeError(f"{name} takes {x2.dtype} cotangents on "
                            f"{x2.device}, got {t.dtype} on {t.device}")
    tb_t = tb if isinstance(tb, torch.Tensor) else None
    tb_scalar = 0.0 if tb_t is not None else float(tb)
    strides = (ctypes.c_longlong * 17)(
        *kernel_strides(x2, w, h, d, tb_t), *cty.stride(), *ctl.stride())
    return tb_t, tb_scalar, strides


def _launch_bwd(x2, w, h, d, tb, cty, ctl, inverse, mbw, mbh, md,
                mode="analytic"):
    """Launch kernel C (``mode="analytic"``) or kernel D (``"autodiff"``)
    on the operands of :func:`_launch` plus the (rows, cols) cotangents
    (any strides) -> fresh contiguous ``gx`` (rows, cols), ``gw``/``gh``
    (K, rows, cols), ``gd`` (K+1, rows, cols)."""
    from . import _build

    name = _BWD_KERNELS[mode]
    fn = getattr(_build.load(name),
                 name + "_launch" + KERNEL_DTYPES[x2.dtype])
    # kernel D's entries take its ring routes after offsets32
    ring = (ctypes.c_uint,) if mode == "autodiff" else ()
    fn.argtypes = (_BWD_ARGTYPES + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, *ring, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rows, cols = x2.shape
    K = w.shape[0]
    tb_t, tb_scalar, strides = _bwd_operands(name, x2, w, h, d, tb, cty, ctl)
    offsets32 = per_element_offsets32(x2, (w, h, d), tb, (cty, ctl),
                                      out_planes=K + 1)
    routes = ((ring_routes(x2, (w, h, d), tb, (cty, ctl)),) if ring
              else ())
    gx = torch.empty((rows, cols), dtype=x2.dtype, device=x2.device)
    gw = torch.empty((K, rows, cols), dtype=x2.dtype, device=x2.device)
    gh = torch.empty_like(gw)
    gd = torch.empty((K + 1, rows, cols), dtype=x2.dtype, device=x2.device)
    err = fn(x2.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
             tb_t.data_ptr() if tb_t is not None else None, cty.data_ptr(),
             ctl.data_ptr(), tb_scalar, strides, rows, cols, K,
             int(bool(inverse)), mbw, mbh, md, gx.data_ptr(), gw.data_ptr(),
             gh.data_ptr(), gd.data_ptr(), int(offsets32), *routes,
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _WRAPPERS[name].launches += 1
    _WRAPPERS[name].bf16_launches += x2.dtype == torch.bfloat16
    return gx, gw, gh, gd


def _launch_bwd_shared(x2, w, h, d, tb, cty, ctl, inverse, mbw, mbh, md):
    """Launch kernel C's shared-parameter path on the operands of
    :func:`_launch_bwd` (parameters and tail bound with row stride 0, at
    most ``SHARED_PARAM_MAX_COLS`` columns) -> fresh ``gx`` (rows, cols) and
    the parameter cotangents summed over the rows, ``gw``/``gh`` (K, 1,
    cols) and ``gd`` (K+1, 1, cols). Two launches (the blocks, then the
    fixed-order sum of their partials), counted as one call of kernel C.
    With no rows it launches nothing: the sums are zeros."""
    from . import _build

    _shared_dtype(x2)
    fn = getattr(_build.load("rqs_bwd"),
                 "rqs_bwd_shared_launch" + KERNEL_DTYPES[x2.dtype])
    fn.argtypes = _BWD_ARGTYPES + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    rows, cols = x2.shape
    K = w.shape[0]
    tb_t, tb_scalar, strides = _bwd_operands("rqs_bwd", x2, w, h, d, tb, cty,
                                             ctl)
    chunks = -(-rows // SHARED_BWD_ROWS_PER_BLOCK)
    opts = dict(dtype=x2.dtype, device=x2.device)
    gx = torch.empty((rows, cols), **opts)
    sums = torch.empty if rows else torch.zeros
    gw = sums((K, 1, cols), **opts)
    gh = sums((K, 1, cols), **opts)
    gd = sums((K + 1, 1, cols), **opts)
    if not rows:
        return gx, gw, gh, gd
    # the per-block partial sums: float32 whatever the operands
    work = torch.empty(cols * chunks * SHARED_BWD_SLOTS * K,
                       dtype=torch.float32, device=x2.device)
    err = fn(x2.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
             tb_t.data_ptr() if tb_t is not None else None, cty.data_ptr(),
             ctl.data_ptr(), tb_scalar, strides, rows, cols, K,
             int(bool(inverse)), mbw, mbh, md, gx.data_ptr(), gw.data_ptr(),
             gh.data_ptr(), gd.data_ptr(), work.data_ptr(),
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rqs_bwd shared-parameter launch failed: "
                           f"error {err}")
    rqs_bwd.launches += 1
    rqs_bwd.bf16_launches += x2.dtype == torch.bfloat16
    rqs_bwd.shared_bf16_launches += x2.dtype == torch.bfloat16
    return gx, gw, gh, gd


def _shared_dtype(x):
    """Kernel C's shared-parameter path is instantiated for float32 and
    bfloat16: a TypeError for anything else."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"kernel C's shared path (rqs_bwd_shared, the "
                        f"unconditional CDF's backward) takes float32 or "
                        f"bfloat16, got {x.dtype}")


def _shares_rows(x2, planes, tb):
    """Whether kernel C's shared-parameter path takes these kernel views
    (any of them expanded): every parameter plane and the tail bound the
    same for all rows, at most ``SHARED_PARAM_MAX_COLS`` columns."""
    rows, cols = x2.shape
    tbs = (tb,) if isinstance(tb, torch.Tensor) else ()
    return cols <= SHARED_PARAM_MAX_COLS and (rows == 1 or all(
        t.shape[-2] == 1 or t.stride(-2) == 0 for t in planes + tbs))


def _sums_in_kernel(x2, planes, tb):
    """Whether the ``rqs_fwd`` op's backward takes kernel C's
    shared-parameter path for its unexpanded parameter views: only where
    its own expand broadcast every parameter down the rows. A view the
    caller expanded to full size (row stride 0) needs one gradient per
    row, which autograd's expand backward then sums."""
    return (all(t.shape[-2] == 1 for t in planes)
            and _shares_rows(x2, planes, tb))


def _bwd(mode, x, w, h, d, tb, cty, ctl, inverse, min_bin_width,
         min_bin_height, min_derivative):
    if x.device.type != "cuda":
        raise ValueError(f"{_BWD_KERNELS[mode]} runs on CUDA tensors, got "
                         f"{x.device}")
    K = w.shape[0]
    _check(x, (w, h, d), tb if isinstance(tb, torch.Tensor) else None, K)
    x2, w3, h3, d3, tb = kernel_views(x, w, h, d, tb)
    op = getattr(torch.ops.nf_tpu_torch, _BWD_KERNELS[mode])
    gx, gw, gh, gd = op(
        x2, w3, h3, d3, *_tb_args(tb), cty.reshape(x2.shape),
        ctl.reshape(x2.shape), bool(inverse), float(min_bin_width),
        float(min_bin_height), float(min_derivative))
    return (gx.view(x.shape), gw.view(K, *x.shape), gh.view(K, *x.shape),
            gd.view(K + 1, *x.shape))


def rqs_bwd(x, w, h, d, tb, cty, ctl, *, inverse,
            min_bin_width=DEFAULT_MIN_BIN_WIDTH,
            min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
            min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel C on the operands of :func:`rqs_fwd` and the cotangents of
    its ``(y, log_det)`` -> ``(gx, gw, gh, gd)``, one gradient per element
    as :func:`rqs_bwd_plain` returns them. CUDA tensors only: this is the
    backward :func:`rqs_fwd` runs by default, exposed for the parity
    checks."""
    return _bwd("analytic", x, w, h, d, tb, cty, ctl, inverse, min_bin_width,
                min_bin_height, min_derivative)


def rqs_bwd_autodiff(x, w, h, d, tb, cty, ctl, *, inverse,
                     min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                     min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                     min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel D, as :func:`rqs_bwd`, held against :func:`rqs_vjp_plain`:
    the backward :func:`rqs_fwd` runs under
    ``set_pallas_bwd_kernel("autodiff")``."""
    return _bwd("autodiff", x, w, h, d, tb, cty, ctl, inverse, min_bin_width,
                min_bin_height, min_derivative)


def rqs_bwd_shared(x, w, h, d, tb, cty, ctl, *, inverse,
                   min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                   min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                   min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel C's shared-parameter path, the backward :func:`rqs_fwd` runs
    for the unconditional CDF: the operands of :func:`rqs_bwd` with
    parameters (and a tensor tail bound) that every row shares, (K, 1,
    cols) or expanded with row stride 0, and at most
    ``SHARED_PARAM_MAX_COLS`` columns -> ``gx`` shaped like ``x`` and the
    parameter cotangents summed over the rows, ``gw``/``gh`` (K, 1, cols)
    and ``gd`` (K+1, 1, cols), as :func:`rqs_bwd_shared_plain` returns
    them. CUDA tensors only; other operands raise."""
    if x.device.type != "cuda":
        raise ValueError(f"rqs_bwd runs on CUDA tensors, got {x.device}")
    K = w.shape[0]
    _check(x, (w, h, d), tb if isinstance(tb, torch.Tensor) else None, K)
    x2, w3, h3, d3, tb = kernel_views(x, w, h, d, tb)
    if not _shares_rows(x2, (w3, h3, d3), tb):
        raise ValueError(
            f"the shared-parameter path takes at most "
            f"{SHARED_PARAM_MAX_COLS} columns and parameters the same for "
            f"every row; got x {tuple(x.shape)}, w {tuple(w.shape)}")
    gx, gw, gh, gd = torch.ops.nf_tpu_torch.rqs_bwd_shared(
        x2, w3, h3, d3, *_tb_args(tb), cty.reshape(x2.shape),
        ctl.reshape(x2.shape), bool(inverse), float(min_bin_width),
        float(min_bin_height), float(min_derivative))
    return gx.view(x.shape), gw, gh, gd


# --- the kernels as torch.library ops ------------------------------------------
#
# Each kernel is one op of the ``nf_tpu_torch`` namespace: its CUDA
# implementation launches the kernel on the current stream, its CPU
# implementation is the kernel's plain version (so an op means the same on
# both devices, and an exported program moved to the CPU runs there), and
# its fake implementation gives the output shapes, so ``torch.export``
# traces through it. The spline operands are the kernel views: ``x``
# (rows, cols), the parameters (planes, r, c) with r in {1, rows} and c in
# {1, cols} (broadcast inside, never copied), ``tb`` a (rows, cols) view or
# None with the float ``tb_scalar``. Outputs are fresh and contiguous.

_SPLINE = ("Tensor x, Tensor w, Tensor h, Tensor d, Tensor? tb, "
           "float tb_scalar")
_MINIMA = "float min_bin_width, float min_bin_height, float min_derivative"


def _tail(tb, tb_scalar):
    return tb if tb is not None else tb_scalar


def _fresh(*ts):
    """The plain versions' outputs in the kernels' layout: contiguous."""
    return tuple(t.contiguous() for t in ts)


@torch.library.custom_op(
    "nf_tpu_torch::rqs_fwd", mutates_args=(),
    schema=f"({_SPLINE}, bool inverse, {_MINIMA}) -> (Tensor, Tensor)")
def _rqs_fwd_op(x, w, h, d, tb, tb_scalar, inverse, min_bin_width,
                min_bin_height, min_derivative):
    return _fresh(*rqs_plain(x, w, h, d, _tail(tb, tb_scalar),
                             inverse=inverse, min_bin_width=min_bin_width,
                             min_bin_height=min_bin_height,
                             min_derivative=min_derivative))


@_rqs_fwd_op.register_kernel("cuda")
def _(x, w, h, d, tb, tb_scalar, inverse, mbw, mbh, md):
    return _launch(x, *_expand(x, (w, h, d)), _tail(tb, tb_scalar), inverse,
                   mbw, mbh, md)


@_rqs_fwd_op.register_fake
def _(x, w, h, d, tb, tb_scalar, inverse, mbw, mbh, md):
    return x.new_empty(x.shape), x.new_empty(x.shape)


_BWD_SCHEMA = (f"({_SPLINE}, Tensor cty, Tensor ctl, bool inverse, "
               f"{_MINIMA}) -> (Tensor, Tensor, Tensor, Tensor)")


def _bwd_kw(inverse, mbw, mbh, md):
    return dict(inverse=inverse, min_bin_width=mbw, min_bin_height=mbh,
                min_derivative=md)


@torch.library.custom_op("nf_tpu_torch::rqs_bwd", mutates_args=(),
                         schema=_BWD_SCHEMA)
def _rqs_bwd_op(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, mbw, mbh, md):
    return _fresh(*rqs_bwd_plain(x, w, h, d, _tail(tb, tb_scalar), cty, ctl,
                                 **_bwd_kw(inverse, mbw, mbh, md)))


@torch.library.custom_op("nf_tpu_torch::rqs_bwd_autodiff", mutates_args=(),
                         schema=_BWD_SCHEMA)
def _rqs_bwd_autodiff_op(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, mbw,
                         mbh, md):
    # kernel D's plain version is autograd through rqs_plain; an op's
    # implementation may run with autograd's dispatch keys excluded
    keys = torch._C._dispatch_tls_local_exclude_set()
    for key in _AUTOGRAD_KEYS:
        keys = keys.remove(key)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), keys):
        return _fresh(*rqs_vjp_plain(x, w, h, d, _tail(tb, tb_scalar), cty,
                                     ctl, **_bwd_kw(inverse, mbw, mbh, md)))


_AUTOGRAD_KEYS = (torch._C.DispatchKey.AutogradCPU,
                  torch._C.DispatchKey.AutogradCUDA,
                  torch._C.DispatchKey.ADInplaceOrView)


@torch.library.custom_op("nf_tpu_torch::rqs_bwd_shared", mutates_args=(),
                         schema=_BWD_SCHEMA)
def _rqs_bwd_shared_op(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, mbw,
                       mbh, md):
    _shared_dtype(x)
    return _fresh(*rqs_bwd_shared_plain(x, w, h, d, _tail(tb, tb_scalar),
                                        cty, ctl,
                                        **_bwd_kw(inverse, mbw, mbh, md)))


def _bwd_cuda(mode):
    def impl(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, mbw, mbh, md):
        return _launch_bwd(x, *_expand(x, (w, h, d)), _tail(tb, tb_scalar),
                           cty, ctl, inverse, mbw, mbh, md, mode)
    return impl


_rqs_bwd_op.register_kernel("cuda")(_bwd_cuda("analytic"))
_rqs_bwd_autodiff_op.register_kernel("cuda")(_bwd_cuda("autodiff"))


@_rqs_bwd_shared_op.register_kernel("cuda")
def _(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, mbw, mbh, md):
    return _launch_bwd_shared(x, *_expand(x, (w, h, d)),
                              _tail(tb, tb_scalar), cty, ctl, inverse, mbw,
                              mbh, md)


def _per_element_fake(x, w, h, d, *rest):
    K = w.shape[0]
    return (x.new_empty(x.shape), x.new_empty((K, *x.shape)),
            x.new_empty((K, *x.shape)), x.new_empty((K + 1, *x.shape)))


_rqs_bwd_op.register_fake(_per_element_fake)
_rqs_bwd_autodiff_op.register_fake(_per_element_fake)


@_rqs_bwd_shared_op.register_fake
def _(x, w, h, d, *rest):
    K, cols = w.shape[0], x.shape[-1]
    return (x.new_empty(x.shape), x.new_empty((K, 1, cols)),
            x.new_empty((K, 1, cols)), x.new_empty((K + 1, 1, cols)))


def _rqs_setup(ctx, inputs, output):
    """Kernel A's residuals are its inputs, as in the JAX custom VJP
    (``splines_pallas.py:556-563``), and the backward mode as it stands at
    the forward call (the JAX package reads the switch when it traces)."""
    x, w, h, d, tb, tb_scalar, *opts = inputs
    ctx.save_for_backward(x, w, h, d, tb)
    ctx.tb_scalar = tb_scalar
    ctx.opts = opts
    ctx.mode = _BWD_MODE[0]


@once_differentiable
def _rqs_backward(ctx, gy, gld):
    """Kernel C (its shared-parameter path where every row shares the
    parameters), or kernel D under ``set_pallas_bwd_kernel("autodiff")``.
    The parameters came in their broadcastable shape (:func:`param_views`),
    so their gradients go back in it: the shared path's row sums, else the
    per-element planes reduced with ``sum_to_size`` where a parameter was
    broadcast. The tail bound gets no gradient."""
    x, w, h, d, tb = ctx.saved_tensors
    planes = (w, h, d)
    ops = torch.ops.nf_tpu_torch
    if ctx.mode == "analytic" and _sums_in_kernel(
            x, planes, _tail(tb, ctx.tb_scalar)):
        op = ops.rqs_bwd_shared
    else:
        op = ops.rqs_bwd if ctx.mode == "analytic" else ops.rqs_bwd_autodiff
    gx, *grads = op(x, *planes, tb, ctx.tb_scalar, gy, gld, *ctx.opts)
    return (gx, *param_grads(grads, planes)) + (None,) * 6


_rqs_fwd_op.register_autograd(_rqs_backward, setup_context=_rqs_setup)


def param_grads(grads, planes):
    """The backward's parameter gradients: each of ``grads`` (per-element
    (P, rows, cols) planes, or row sums (P, 1, cols)) summed to the shape
    of its broadcastable parameter view in ``planes`` (no copy where the
    shapes agree)."""
    return tuple(g.sum_to_size(t.shape) for g, t in zip(grads, planes))


def _expand(x2, planes):
    return tuple(t.expand(t.shape[0], *x2.shape) for t in planes)


def rqs_fwd(x, w, h, d, tb, *, inverse,
            min_bin_width=DEFAULT_MIN_BIN_WIDTH,
            min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
            min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Kernel A: ``x`` (rows, cols), (n,) or an image (B, C, H, W);
    ``w``/``h`` (K, *x.shape) and ``d`` (K+1, *x.shape), any strides
    (``.expand`` views included; for an image, strides that collapse to
    the kernel's 2D views, :func:`image_split`); ``tb`` a float or a
    tensor broadcastable to ``x``. Returns ``(y, log_det)`` shaped like
    ``x``. CUDA -> kernel A, differentiable through kernel C; CPU ->
    :func:`rqs_plain`."""
    kw = dict(inverse=inverse, min_bin_width=min_bin_width,
              min_bin_height=min_bin_height, min_derivative=min_derivative)
    if x.device.type == "cpu" and not _cpu_takes_op(x, w.shape[0]):
        return rqs_plain(x, w, h, d, tb, **kw)
    if x.device.type not in ("cpu", "cuda"):
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
    y, ld = torch.ops.nf_tpu_torch.rqs_fwd(
        *op_operands(x, w, h, d, tb), bool(inverse), float(min_bin_width),
        float(min_bin_height), float(min_derivative))
    return y.view(x.shape), ld.view(x.shape)


def op_operands(x, w, h, d, tb):
    """The spline operands of the ops for :func:`rqs_fwd`'s arguments:
    ``(x2, w3, h3, d3, tb tensor or None, tb float)``, the kernel views
    before their expand (:func:`kernel_views`)."""
    x2, planes, tb2 = _views(x, w, h, d, tb)
    return (x2, *planes, *_tb_args(tb2))


# while set (ops.cpu_through_ops), the wrappers take the ops on CPU tensors
# too, where the kernels would take the operands: the ops' CPU
# implementations are the plain versions, so the values do not change
_CPU_THROUGH_OPS = [False]


def _cpu_takes_op(x, num_bins):
    return (_CPU_THROUGH_OPS[0] and num_bins in SUPPORTED_BINS
            and x.dtype in KERNEL_DTYPES)


def _tb_args(tb):
    """A tail bound as the ops take it: ``(tensor, 0.0)`` or ``(None,
    float)``."""
    if isinstance(tb, torch.Tensor):
        return tb, 0.0
    return None, float(tb)


def param_views(x, w, h, d, split=None):
    """``w``, ``h`` and ``d`` as (planes, r, c) views, none of them copied
    or expanded: r is 1 or rows and c is 1 or cols, the dims of ``x`` as
    (rows, cols) (a 1D ``x`` is one row; a 4D ``x`` collapses as
    :func:`image_split` says, or at ``split``), with leading 1s added
    where a parameter has fewer dims than ``x``. Raises ValueError unless
    each broadcasts to (planes, rows, cols) as a view."""
    if x.ndim == 4:
        if split is None:
            split = image_split(x, w, h, d)
        return tuple(_merged(t, t.shape[:1], x.shape, split)
                     for t in (w, h, d))
    rows_cols = _as_2d(x).shape
    out = []
    for t in (w, h, d):
        lead = x.ndim + 1 - t.ndim
        if lead >= 0:
            t = t.reshape(t.shape[:1] + (1,) * lead + t.shape[1:])
            if x.ndim == 1:
                t = t[:, None]
        if lead < 0 or torch.broadcast_shapes(
                t.shape[1:], rows_cols) != rows_cols:
            raise ValueError(f"spline parameters {tuple(w.shape)} do not "
                             f"broadcast to (K, {tuple(x.shape)})")
        out.append(t)
    return tuple(out)


def _tb_view(x, tb, split=None):
    """A tensor ``tb`` broadcast to ``x`` as (rows, cols); a float stays a
    float."""
    if not isinstance(tb, torch.Tensor):
        return tb
    try:
        tb = tb.expand(x.shape)
    except RuntimeError as e:
        raise ValueError(f"tail bound {tuple(tb.shape)} does not broadcast "
                         f"to {tuple(x.shape)}") from e
    if x.ndim == 4:
        return _merged(tb, (), x.shape, split)
    return tb[None] if x.ndim == 1 else tb


def kernel_views(x, w, h, d, tb):
    """The views kernel A is launched on, none of them copied: ``x`` as
    (rows, cols); ``w``/``h``/``d`` as (planes, rows, cols), broadcast with
    ``expand`` (stride 0 where a parameter is shared); a tensor ``tb`` as
    (rows, cols) (a float stays a float). A 4D ``x`` collapses as
    :func:`image_split` says."""
    x2, planes, tb2 = _views(x, w, h, d, tb)
    return (x2, *_expand(x2, planes), tb2)


def _views(x, w, h, d, tb):
    """``(x2, (w3, h3, d3) unexpanded, tb2)``: the operands as the kernels
    take them (:func:`kernel_views` before its expand)."""
    split = image_split(x, w, h, d, tb) if x.ndim == 4 else None
    return (_as_2d(x, split), param_views(x, w, h, d, split),
            _tb_view(x, tb, split))


rqs_fwd.launches = 0
rqs_bwd.launches = 0
rqs_bwd_autodiff.launches = 0
rqs_fwd.bf16_launches = 0
rqs_bwd.bf16_launches = 0
rqs_bwd_autodiff.bf16_launches = 0
# of rqs_bwd's bfloat16 launches, those of its shared-parameter path
rqs_bwd.shared_bf16_launches = 0
# backward mode -> the csrc/<name>.cu that implements it, and its counter
_BWD_KERNELS = {"analytic": "rqs_bwd", "autodiff": "rqs_bwd_autodiff"}
_WRAPPERS = {"rqs_bwd": rqs_bwd, "rqs_bwd_autodiff": rqs_bwd_autodiff}
_BWD_MODE = ["analytic"]


def set_pallas_bwd_kernel(mode: str) -> None:
    """Select the backward of :func:`rqs_fwd` on CUDA tensors, as the JAX
    package's ``set_pallas_bwd_kernel`` (``splines_pallas.py:73``) does:
    ``"analytic"`` (kernel C, the default) or ``"autodiff"`` (kernel D).
    Read by each forward call; the CPU path's autograd does not change."""
    if mode not in _BWD_KERNELS:
        raise ValueError(f"unknown backward kernel mode: {mode!r}")
    _BWD_MODE[0] = mode


def get_pallas_bwd_kernel() -> str:
    """The backward mode :func:`set_pallas_bwd_kernel` set."""
    return _BWD_MODE[0]


# --- the JAX package's two entry points --------------------------------------

def fused_unconstrained_rqs(
    inputs, unnormalized_widths, unnormalized_heights, padded_derivatives,
    tail_bound, inverse=False, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Bin-MINOR entry (``splines_pallas.py:605``): widths/heights
    ``(..., K)`` and padded derivatives ``(..., K+1)``, broadcastable to
    ``inputs.shape + (K,)``. They reach :func:`rqs_fwd` unexpanded, so the
    unconditional CDF's (1, D, K) parameters take kernel C's
    shared-parameter path in the backward."""
    def bin_major(t):  # (..., P) -> (P, ...), broadcastable to inputs
        t = t.reshape((1,) * max(inputs.ndim + 1 - t.ndim, 0) + t.shape)
        return t.movedim(-1, 0)

    w, h, d = (bin_major(t) for t in (unnormalized_widths,
                                      unnormalized_heights,
                                      padded_derivatives))
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


def rqs_vjp_ops_per_element(num_bins, inverse):
    """Arithmetic operations per element of kernel D, for the bound in
    ``chip_smoke.py``: the forward sweep (the forward's count less its
    log-det, which the adjoint only needs through dnum and denom), the
    adjoint of the map (~75 forward, ~110 inverse, with the root's
    quadratic), the softplus adjoints (4), the derivative scatter (2K),
    and per softmax the knot and size adjoints (3K), the exp and max-chain
    adjoints (4K) and the select adjoints (3K)."""
    K = num_bins
    return (rqs_ops_per_element(K, inverse) + (110 if inverse else 75) + 4
            + 2 * K + 2 * 10 * K)


def rqs_ops_per_element(num_bins, inverse):
    """Arithmetic operations per element of the spline, for the roofline
    bound in ``chip_smoke.py``: two floored softmaxes (max, subtract, exp,
    add, scale: 5K each) and knot sums (3K each), K bin-search compares,
    six K-way masked selects (2K each), two softplus (4 each) and the RQ
    map with its log-det (~30 forward, ~40 inverse with the root)."""
    K = num_bins
    return 2 * 5 * K + 2 * 3 * K + K + 6 * 2 * K + 8 + (40 if inverse else 30)


def rqs_shared_ops(num_bins, inverse, cols, elements):
    """Arithmetic operations of the spline when every element of a column
    shares its parameters (kernel A's shared-parameter path), for the bound
    in ``chip_smoke.py``: per column the two floored softmaxes and knot sums
    (8K each) and K + 1 softplus (4 each); per element the clip (2), K - 1
    bin-search compares and the RQ map with its log-det. The six selects
    are indexed reads there, not operations."""
    K = num_bins
    per_col = 2 * 8 * K + 4 * (K + 1)
    per_elem = 2 + (K - 1) + (40 if inverse else 30)
    return per_col * cols + per_elem * elements


def rqs_bwd_shared_ops(num_bins, inverse, cols, elements):
    """Arithmetic operations of kernel C's shared-parameter path, for the
    bound in ``chip_smoke.py``: per column the two floored softmaxes and
    knot sums (8K each), K + 1 softplus and sigmoids (4 each), and the two
    transposes of the summed cotangents (~6K each); per element the clip
    (2), K - 1 bin-search compares, the recompute of the map (~30 forward,
    ~40 inverse), its partials and cotangents (~70 forward, ~80 inverse)
    and the six additions into the (column, bin) sums."""
    K = num_bins
    per_col = 2 * 8 * K + 8 * (K + 1) + 2 * 6 * K
    per_elem = 2 + (K - 1) + (120 if inverse else 100) + 6
    return per_col * cols + per_elem * elements
