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
  :func:`head_rqs_plain_in_kernel_order` and
  :func:`head_rqs_bwd_plain_in_kernel_order` sum the head product in the
  float32 kernels' order, and :func:`head_rqs_plain_on_sums` and
  :func:`head_rqs_bwd_plain_on_sums` take it given: the bfloat16 kernels'
  own sums, from :func:`head_params_bf16` (the shared tensor-core product
  alone, ``csrc/head_params_bf16.cu``), the yardstick of their card
  checks;
* :func:`fused_head_rqs`, the wrapper: CUDA -> the op
  ``torch.ops.nf_tpu_torch.head_rqs_fwd`` (kernel B; its registered
  backward calls ``head_rqs_bwd``, kernel E) or raise, CPU -> the plain
  version with ordinary autograd; each op's CPU implementation is the
  plain version (``splines_kernel``'s notes on the ops);
* ``fused_head_rqs.launches`` and ``fused_head_rqs_bwd.launches``, the
  counts of launches, kept on the host (a CUDA graph adds to them once,
  at its capture), and ``circular_launches`` and ``bf16_launches`` of
  each, those of them at circular tails and through the bfloat16
  instantiation;
* :func:`effective_head` and :func:`_build_d_list`, ported from the JAX
  module (:329, :93).

Kernels B and E take float32 or bfloat16 operands, every one of a call in
the same dtype (the JAX package's kernels take any dtype; its coupled
layers built with ``dtype=bfloat16`` run them in bfloat16, W_eff formed in
bfloat16 by :func:`effective_head` as there). A bfloat16 call runs kernels
of their own (``csrc/head_mma_bf16.cuh``): they read and write 2-byte
batch planes (x_t, h_t, y, ld, the cotangents, gx, gh) and keep W_eff and
h_t in bfloat16 in shared memory, and their head products run on the
tensor cores, bfloat16 x bfloat16 with float32 sums, as the JAX kernels
run theirs on the MXU. The spline and its backward compute in float32,
and each result is rounded once. Kernel E's parameter cotangents gp are
float32 (JAX holds them in bfloat16, ``spline_head_fused.py:258``); its
products ``gh = W_eff^T gp`` and ``gW = gp h_t^T`` take them as two
bfloat16 planes, ``hi + lo`` (:func:`split_bf16_pair`), ~16 bits of each,
and the gW/gb partials stay float32, gW and gb rounded once from their
float32 totals. The plain versions compute a bfloat16 call in float32 on
the widened operands (``splines._in_float32``), and the float32 plain
versions are unchanged; on the kernels' own head sums they meet the
kernels within one bfloat16 ulp (y, ld and gx bit for bit). On
``torch.matmul``'s sums they need not: the tensor cores round each k16
step their own way, and where a log-det sits near 0 or a column near a
knot the last bits of a parameter move y and ld by a few bfloat16 ulps
and gx by hundreds. ``head_rqs_bwd_plain(..., split_gp=True)`` routes gp
through the split as kernel E does (the CPU tests hold it against the
unsplit version and JAX's float32 VJP).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    _in_float32,
    linear_tail_constant,
)
from .splines_kernel import (
    KERNEL_DTYPES,
    SUPPORTED_BINS,
    _cpu_takes_op,
    rqs_bwd_plain,
    rqs_plain,
)


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


@_in_float32
def head_rqs_plain(x_t, h_t, head_weight, head_bias, tb, *, num_bins, tails,
                   inverse, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                   min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                   min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Plain version of kernel B: ``x_t`` (D, B), ``h_t`` (H, B), effective
    head ``(2K+nd)*D x H`` and bias, ``tb`` (D,) -> ``(y, ld)`` (D, B). A
    bfloat16 ``x_t`` is computed as kernel B computes it: every operand
    widened, float32 math, ``(y, ld)`` rounded once (differentiably)."""
    K, D = num_bins, x_t.shape[0]
    params = torch.matmul(head_weight, h_t) + head_bias[:, None]
    planes = [params[p * D:(p + 1) * D] for p in range(2 * K
                                                        + _dplanes(K, tails))]
    d = _build_d_list(planes[2 * K:], x_t, tails, min_derivative)
    return rqs_plain(x_t, planes[:K], planes[K:2 * K], d, tb.reshape(-1, 1),
                     inverse=inverse, min_bin_width=min_bin_width,
                     min_bin_height=min_bin_height,
                     min_derivative=min_derivative)


def split_bf16_pair(gp):
    """float32 ``gp`` -> bfloat16 ``(hi, lo)``: ``hi`` is ``gp`` rounded
    to nearest even (toward zero where that would overflow a finite
    value), ``lo`` is ``gp - hi`` (exact in float32) rounded. ``hi + lo``
    lies within ``max(2^-16 |gp|, 2^-134)`` of ``gp`` (2^-134: half of
    bfloat16's smallest subnormal, where ``lo`` underflows). The twin of kernel E's device split
    (``csrc/head_mma_bf16.cuh`` ``split_bf16_pair``)."""
    hi = gp.to(torch.bfloat16)
    top = torch.full_like(hi, torch.finfo(torch.bfloat16).max)
    top = torch.where(gp.signbit(), -top, top)
    hi = torch.where(hi.isinf() & ~gp.isinf(), top, hi)
    return hi, (gp - hi.float()).to(torch.bfloat16)


@_in_float32
def head_rqs_bwd_plain(x_t, h_t, head_weight, head_bias, tb, cty, ctl, *,
                       num_bins, tails, inverse,
                       min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                       min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                       min_derivative=DEFAULT_MIN_DERIVATIVE,
                       split_gp=False):
    """Plain version of kernel E: the operands of :func:`head_rqs_plain`
    plus the cotangents ``cty``, ``ctl`` (D, B) of ``(y, ld)`` -> ``(gx (D,
    B), gh (H, B), gW (M, H), gb (M,))`` (``spline_head_fused.py:129``).
    The derivative cotangents fold into head rows: linear tails drop the
    two synthesised edge planes, circular tails add ``gd[K]`` into row 0.
    The tail bound gets no gradient. A bfloat16 ``x_t``: float32 math on
    the widened operands, each gradient rounded once. ``split_gp``: gh
    and gW take the parameter cotangents as :func:`split_bf16_pair`'s two
    planes, each product summed in float32 over both, as the bfloat16
    kernel E does (gb sums them unsplit)."""
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
    if split_gp:
        planes = [t.float() for t in split_bf16_pair(gparams)]
        return (gx, sum(torch.matmul(head_weight.T, t) for t in planes),
                sum(torch.matmul(t, h_t.T) for t in planes),
                torch.sum(gparams, dim=1))
    return (gx, torch.matmul(head_weight.T, gparams),
            torch.matmul(gparams, h_t.T), torch.sum(gparams, dim=1))


def fmaf(a, b, c):
    """float32 ``fmaf(a, b, c)`` elementwise: ``a * b + c`` rounded once.
    The product of two float32 is exact in float64; the sum is rounded to
    float64 first, and where that lands exactly halfway between two
    float32 its error term (TwoSum) says which way the exact sum lies, so
    the float32 result is the single rounding ``fmaf`` gives."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    e = (c - (s - (s - c))) + (p - (s - c))  # s + e == p + c exactly
    r = s.float()
    rd = r.double()
    toward = torch.where(s > rd, torch.inf, -torch.inf).float()
    r2 = torch.nextafter(r, toward)
    tie = (s != rd) & (s - rd == r2.double() - s)
    fixed = torch.where(e > 0, torch.maximum(r, r2),
                        torch.where(e < 0, torch.minimum(r, r2), r))
    return torch.where(tie, fixed, r)


def _identity_head(params):
    """``params`` (the head rows' values, bias included) as the ``h_t`` of
    an identity head with zero bias, whose product is exact: the plain
    versions then run on exactly these parameters."""
    m = params.shape[0]
    eye = torch.eye(m, dtype=params.dtype, device=params.device)
    return params, eye, torch.zeros(m, dtype=params.dtype,
                                    device=params.device)


def _params_in_kernel_order(h_t, head_weight, head_bias):
    """``head_weight @ h_t + head_bias[:, None]`` summed as the float32
    kernels B and E sum it: j ascending from 0 with :func:`fmaf`, then the
    bias; as an identity head (:func:`_identity_head`)."""
    acc = torch.zeros((head_weight.shape[0], h_t.shape[1]), dtype=h_t.dtype,
                      device=h_t.device)
    for j in range(h_t.shape[0]):
        acc = fmaf(head_weight[:, j, None], h_t[j], acc)
    return _identity_head(acc + head_bias[:, None])


@_in_float32
def head_rqs_plain_in_kernel_order(x_t, h_t, head_weight, head_bias, tb,
                                   **kw):
    """:func:`head_rqs_plain` with the head product summed in the float32
    kernel B's order (:func:`_params_in_kernel_order`): the yardstick that
    holds B's bits, which kernel E's recompute repeats, apart from the
    order in which ``torch.matmul`` sums."""
    return head_rqs_plain(
        x_t, *_params_in_kernel_order(h_t, head_weight, head_bias), tb, **kw)


@_in_float32
def head_rqs_bwd_plain_in_kernel_order(x_t, h_t, head_weight, head_bias, tb,
                                       cty, ctl, **kw):
    """:func:`head_rqs_bwd_plain` with the head product summed as the
    float32 kernels B and E sum it (:func:`_params_in_kernel_order`). The
    spline's derivatives carry a rounding of the parameters into gx, so
    where ``torch.matmul``'s order moves gx past the 1e-4 bar this is the
    yardstick that tells the kernel's arithmetic from its order."""
    return _bwd_on_params(
        x_t, h_t, head_weight, head_bias, tb, cty, ctl,
        _params_in_kernel_order(h_t, head_weight, head_bias), kw)


def _bwd_on_params(x_t, h_t, head_weight, head_bias, tb, cty, ctl, ident,
                   kw):
    """The plain backward through the identity head ``ident`` (the
    parameters given), then gh, gW and gb from its parameter cotangents."""
    gx, gparams, _, gb = head_rqs_bwd_plain(x_t, *ident, tb, cty, ctl, **kw)
    return (gx, torch.matmul(head_weight.T, gparams),
            torch.matmul(gparams, h_t.T), gb)


@_in_float32
def head_rqs_plain_on_sums(x_t, sums, head_bias, tb, **kw):
    """:func:`head_rqs_plain` on the head product ``sums`` (float32 (M, B),
    the bias not yet added) given: the yardstick of the bfloat16 kernel B
    on its own sums (:func:`head_params_bf16`). The tensor cores round
    each k16 step their own way, and where a log-det sits near 0 or a
    column near a knot the last bits of a parameter move y, ld (or E's gx)
    by several bfloat16 ulps; on the same sums the plain version gives the
    kernel's bits."""
    return head_rqs_plain(
        x_t, *_identity_head(sums + head_bias[:, None]), tb, **kw)


@_in_float32
def head_rqs_bwd_plain_on_sums(x_t, h_t, head_weight, head_bias, tb, cty,
                               ctl, sums, **kw):
    """:func:`head_rqs_bwd_plain` on the head product ``sums`` given (see
    :func:`head_rqs_plain_on_sums`): gx from the spline at those
    parameters, gh, gW and gb from its float32 parameter cotangents by
    ``torch.matmul``; the yardstick of the bfloat16 kernel E."""
    return _bwd_on_params(x_t, h_t, head_weight, head_bias, tb, cty, ctl,
                          _identity_head(sums + head_bias[:, None]), kw)


def head_params_bf16(h_t, head_weight, *, feats):
    """The head product of the bfloat16 kernels B and E alone, on the card:
    ``head_weight @ h_t`` (bfloat16 ``(M, H)`` and ``(H, B)``, M = P *
    ``feats``) -> float32 ``(M, B)``, bit for bit the sums those kernels
    add the bias to (``csrc/head_params_bf16.cu``). For the parity checks
    only: no float32 sum in another order gives them, and the plain
    versions' ``torch.matmul`` is one. Raises unless both are bfloat16 on
    CUDA."""
    from . import _build

    if (h_t.device.type != "cuda" or h_t.dtype != torch.bfloat16
            or head_weight.dtype != torch.bfloat16
            or head_weight.device != h_t.device):
        raise ValueError("head_params_bf16 takes bfloat16 CUDA tensors")
    h_t, head_weight = h_t.contiguous(), head_weight.contiguous()
    (H, B), m = h_t.shape, head_weight.shape[0]
    lib = _build.load("head_params_bf16")
    fn = lib.head_params_bf16_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    out = torch.empty((m, B), dtype=torch.float32, device=h_t.device)
    err = fn(h_t.data_ptr(), head_weight.data_ptr(), feats, B, H,
             m // feats, out.data_ptr(),
             torch.cuda.current_stream(h_t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"head_params_bf16 launch failed: error {err}")
    return out


def _launch(x_t, h_t, w, b, tb, *, num_bins, tails, inverse, mbw, mbh, md):
    from . import _build

    lib = _build.load("head_rqs_fwd")
    fn = getattr(lib, "head_rqs_fwd_launch" + KERNEL_DTYPES[x_t.dtype])
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
    fused_head_rqs.circular_launches += tails == "circular"
    fused_head_rqs.bf16_launches += x_t.dtype == torch.bfloat16
    return y, ld


# kernel B's bfloat16 layout (csrc/head_rqs_fwd.cu kThreadsBf16,
# kStagesBf16, kMaxTileCols)
_B16_THREADS, _B16_STAGES, _B16_TILE_COLS = 128, 3, 256


def kernel_b_bf16_shared_bytes(p, hidden):
    """Dynamic shared memory of one block of the bfloat16 kernel B at
    ``p`` parameters per feature (rounded up to 16) and hidden width
    ``hidden`` (``shared_bytes_bf16`` of ``csrc/head_rqs_fwd.cu``): the
    warps' rings of h_t chunks, the W_eff tile (all of H padded to 32, at
    most 256 columns; rows padded by 8) and the bias in float32."""
    pm = -(-p // 16) * 16
    wj = min(-(-max(hidden, 1) // _MMA_RK) * _MMA_RK, _B16_TILE_COLS)
    rings = _B16_THREADS // 32 * _B16_STAGES * _MMA_RK * (32 + _MMA_PAD)
    return 2 * (rings + pm * (wj + _MMA_PAD)) + 4 * pm


# kernel E's float32 layout (csrc/head_rqs_bwd.cu kThreads, kColPad, kJ,
# kG, kChunk, kRowPad, kTileM, kTileJ) and the shared memory a block may
# use on the H100
_E_THREADS, _E_COL_PAD, _E_WTILE, _E_GH_ROWS = 256, 4, 128, 16
_E_CHUNK, _E_ROW_PAD = 32, 4
_E_TILE_M, _E_TILE_J = 24, 32
_MAX_SHARED_BYTES = 232448
# the bfloat16 kernel's (csrc/head_rqs_bwd.cu kStagesBf16, col_row_bf16,
# j_rows_bf16; csrc/head_mma_bf16.cuh kRK, kPad)
_E16_STAGES = 3
_MMA_RK, _MMA_PAD = 32, 8


def kernel_e_shared_bytes(m, feats, hidden):
    """Dynamic shared memory of one block of the float32 kernel E at ``m``
    head rows over ``feats`` features: the block's parameter cotangents
    (m rounded up to 24, 256 + 4), the staged W_eff tile (rows, feats, P
    rounded up to 4; rows = hidden rounded up to 16, at most 128) and the
    chunks of h_t (hidden rounded up to 32, 32 + 4), two where they fit
    and else one. At one feature and hidden <= 128 the tile and the chunks
    sit side by side (gW and gh run at once on separate warps); otherwise
    they share one region."""
    pp = (m // feats + 3) // 4 * 4
    rows = min(_E_WTILE, -(-hidden // _E_GH_ROWS) * _E_GH_ROWS)
    split = feats == 1 and hidden <= _E_WTILE

    def total(buffers):
        w = 4 * rows * feats * pp
        h = (4 * buffers * -(-hidden // _E_TILE_J) * _E_TILE_J
             * (_E_CHUNK + _E_ROW_PAD))
        return (4 * -(-m // _E_TILE_M) * _E_TILE_M
                * (_E_THREADS + _E_COL_PAD)
                + (w + h if split else max(w, h)))

    return total(2) if total(2) <= _MAX_SHARED_BYTES else total(1)


def kernel_e_bf16_plan(m, feats, hidden):
    """The bfloat16 kernel E's block layout at ``m`` head rows over
    ``feats`` features and hidden width ``hidden`` (``plan_bf16`` of
    ``csrc/head_rqs_bwd.cu``): ``(warps, wj, bytes)``, the block's warps (8
    where the layout fits, else 4; 32 batch columns each), the columns of
    H per staged W_eff tile (all of H padded to 32 where they fit) and its
    dynamic shared memory: W_eff's tile and gp's two planes (P rounded up
    to 16 per feature, rows padded by 8 bfloat16), the region of h_t (the
    warps' rings of chunks, then two chunks of 8 rows of H per warp staged
    again for gW) and the warps' gb shares. Raises ValueError where no
    layout fits."""
    rows = feats * -(-(m // feats) // 16) * 16
    hp = -(-max(hidden, 1) // _MMA_RK) * _MMA_RK
    for warps in (8, 4):
        col_row = 32 * warps + _MMA_PAD
        h = max(2 * warps * _E16_STAGES * _MMA_RK * (32 + _MMA_PAD),
                2 * 2 * 8 * warps * col_row)
        used = 2 * 2 * rows * col_row + h + 4 * warps * rows
        cols = (_MAX_SHARED_BYTES - used) // (2 * rows) - _MMA_PAD
        wj = min(hp, max(cols, 0) // _MMA_RK * _MMA_RK)
        if used < _MAX_SHARED_BYTES and wj >= _MMA_RK:
            return warps, wj, used + 2 * rows * (wj + _MMA_PAD)
    raise ValueError(f"kernel E (bfloat16) has no layout for {m} head rows "
                     f"over {feats} features at hidden {hidden} within the "
                     f"H100's {_MAX_SHARED_BYTES} bytes of shared memory "
                     f"per block")


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
    for t in (x_t, h_t, w, b, tb, cty, ctl):
        if (x_t.dtype not in KERNEL_DTYPES or t.dtype != x_t.dtype
                or t.device != x_t.device):
            raise TypeError(f"kernel E takes float32 or bfloat16 operands, "
                            f"all of one dtype, on {x_t.device}; x_t is "
                            f"{x_t.dtype}, an operand {t.dtype} on "
                            f"{t.device}")
    if x_t.dtype == torch.bfloat16:  # raises where no layout fits
        threads = 32 * kernel_e_bf16_plan(m, D, H)[0]
    else:
        smem = kernel_e_shared_bytes(m, D, H)
        if smem > _MAX_SHARED_BYTES:
            raise ValueError(f"kernel E needs {smem} bytes of shared memory "
                             f"per block at {m} head rows over {D} features "
                             f"and hidden {H}; the H100 gives "
                             f"{_MAX_SHARED_BYTES}")
        threads = _E_THREADS
    lib = _build.load(f"head_rqs_bwd@{num_bins}")
    fn = getattr(lib, "head_rqs_bwd_launch" + KERNEL_DTYPES[x_t.dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   * 2
                   + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    blocks = (B + threads - 1) // threads
    gx = torch.empty((D, B), dtype=x_t.dtype, device=x_t.device)
    gh = torch.empty((H, B), dtype=x_t.dtype, device=x_t.device)
    gw = torch.empty((m, H), dtype=x_t.dtype, device=x_t.device)
    gb = torch.empty((m,), dtype=x_t.dtype, device=x_t.device)
    # float32 whatever the operands: gW sums B columns
    partials = torch.empty((max(blocks, 1), m * (H + 1)),
                           dtype=torch.float32, device=x_t.device)
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
    fused_head_rqs_bwd.circular_launches += tails == "circular"
    fused_head_rqs_bwd.bf16_launches += x_t.dtype == torch.bfloat16
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
    return torch.ops.nf_tpu_torch.head_rqs_bwd(
        x_t, h_t.contiguous(), head_weight.contiguous(),
        head_bias.contiguous(), tb.contiguous(), int(num_bins),
        tails == "circular", cty, ctl, bool(inverse), float(min_bin_width),
        float(min_bin_height), float(min_derivative))


# --- kernels B and E as torch.library ops (``splines_kernel``'s notes) ------

_HEAD = ("Tensor x_t, Tensor h_t, Tensor w, Tensor b, Tensor tb, "
         "int num_bins, bool circular")
_MINIMA = ("bool inverse, float min_bin_width, float min_bin_height, "
           "float min_derivative")


def _head_kw(num_bins, circular, inverse, mbw, mbh, md):
    return dict(num_bins=num_bins, tails="circular" if circular else "linear",
                inverse=inverse, min_bin_width=mbw, min_bin_height=mbh,
                min_derivative=md)


def _launch_kw(num_bins, circular, inverse, mbw, mbh, md):
    return dict(num_bins=num_bins, tails="circular" if circular else "linear",
                inverse=inverse, mbw=mbw, mbh=mbh, md=md)


@torch.library.custom_op(
    "nf_tpu_torch::head_rqs_fwd", mutates_args=(),
    schema=f"({_HEAD}, {_MINIMA}) -> (Tensor, Tensor)")
def _head_fwd_op(x_t, h_t, w, b, tb, *opts):
    return tuple(t.contiguous() for t in head_rqs_plain(
        x_t, h_t, w, b, tb, **_head_kw(*opts)))


@_head_fwd_op.register_kernel("cuda")
def _(x_t, h_t, w, b, tb, *opts):
    return _launch(x_t, h_t, w, b, tb, **_launch_kw(*opts))


@_head_fwd_op.register_fake
def _(x_t, h_t, w, b, tb, *opts):
    return x_t.new_empty(x_t.shape), x_t.new_empty(x_t.shape)


@torch.library.custom_op(
    "nf_tpu_torch::head_rqs_bwd", mutates_args=(),
    schema=(f"({_HEAD}, Tensor cty, Tensor ctl, {_MINIMA}) -> "
            f"(Tensor, Tensor, Tensor, Tensor)"))
def _head_bwd_op(x_t, h_t, w, b, tb, num_bins, circular, cty, ctl, *opts):
    return tuple(t.contiguous() for t in head_rqs_bwd_plain(
        x_t, h_t, w, b, tb, cty, ctl, **_head_kw(num_bins, circular, *opts)))


@_head_bwd_op.register_kernel("cuda")
def _(x_t, h_t, w, b, tb, num_bins, circular, cty, ctl, *opts):
    return _launch_bwd(x_t, h_t, w, b, tb, cty, ctl,
                       **_launch_kw(num_bins, circular, *opts))


@_head_bwd_op.register_fake
def _(x_t, h_t, w, b, *rest):
    return (x_t.new_empty(x_t.shape), h_t.new_empty(h_t.shape),
            w.new_empty(w.shape), b.new_empty(b.shape))


def _head_setup(ctx, inputs, output):
    """Kernel B's residuals are its inputs, as in the JAX custom VJP
    (``spline_head_fused.py:263-276``)."""
    x_t, h_t, w, b, tb, *opts = inputs
    ctx.save_for_backward(x_t, h_t, w, b, tb)
    ctx.opts = opts


@once_differentiable
def _head_backward(ctx, gy, gld):
    """Kernel E; the tail bound gets no gradient."""
    x_t, h_t, w, b, tb = ctx.saved_tensors
    num_bins, circular, *minima = ctx.opts
    gx, gh, gw, gb = torch.ops.nf_tpu_torch.head_rqs_bwd(
        x_t, h_t, w, b, tb, num_bins, circular, gy, gld, *minima)
    return (gx, gh, gw, gb) + (None,) * 7


_head_fwd_op.register_autograd(_head_backward, setup_context=_head_setup)


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
    ``tails``: 'linear' or 'circular'. ``tail_bound``: scalar or (D,),
    taken in ``x_t``'s dtype (as the JAX package takes it). Every operand
    float32, or every one bfloat16; anything else raises TypeError.
    Returns ``(y (D, B), log_det (D, B))`` in ``x_t``'s dtype.
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
        tb = torch.broadcast_to(tail_bound.reshape(-1), (D,)).to(x_t.dtype)
    else:  # a fill, not a host-to-device copy (which would sync the host)
        tb = torch.full((D,), float(tail_bound), dtype=x_t.dtype,
                        device=x_t.device)
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    if x_t.device.type == "cpu" and not _cpu_takes_op(x_t, K):
        return head_rqs_plain(x_t, h_t, head_weight, head_bias, tb,
                              min_bin_width=min_bin_width,
                              min_bin_height=min_bin_height,
                              min_derivative=min_derivative, **kw)
    if x_t.device.type not in ("cpu", "cuda"):
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
        if x_t.dtype not in KERNEL_DTYPES or t.dtype != x_t.dtype:
            raise TypeError(f"the fused head kernel takes float32 or "
                            f"bfloat16 operands, all of one dtype: x_t is "
                            f"{x_t.dtype}, an operand {t.dtype}")
        if t.device != x_t.device:
            raise ValueError("all operands must be on the same CUDA device")
    return torch.ops.nf_tpu_torch.head_rqs_fwd(
        x_t, h_t.contiguous(), head_weight.contiguous(),
        head_bias.contiguous(), tb.contiguous(), K, tails == "circular",
        bool(inverse), float(min_bin_width), float(min_bin_height),
        float(min_derivative))


fused_head_rqs.launches = 0
fused_head_rqs_bwd.launches = 0
# of those, the launches at circular tails, and those of the bfloat16
# instantiation
fused_head_rqs.circular_launches = 0
fused_head_rqs_bwd.circular_launches = 0
fused_head_rqs.bf16_launches = 0
fused_head_rqs_bwd.bf16_launches = 0
