"""The route of the per-element path of kernels A, C and D on the CPU.

``splines_kernel.per_element_offsets32`` decides, from shapes and strides,
whether a launch of A, C or D takes 32-bit element offsets, and
``splines_kernel.ring_routes``, from strides and addresses, which operands
come into kernel D's ring in 16-byte copies (``csrc/rqs_ring.cuh``); the
CUDA source takes both as given. Here each caller builds its operands on
the CPU as on the card (under ``ops.cpu_through_ops``, whose ops run the
plain versions) and the route its launches would take is read from the
ops' calls; and the offset width is held on synthetic views past int32
(meta tensors: no memory).
"""

import os
import re

import numpy as np
import pytest
import torch

from nf_tpu_torch import ops as tops
from nf_tpu_torch.flows.neural_spline.feed import (kmajor_spline_feed,
                                                   slice_ud_planes)
from nf_tpu_torch.ops import splines
from nf_tpu_torch.ops import splines_kernel as tk

BF16 = torch.bfloat16
X, W, H, D_, TB, CTY, CTL = (1 << i for i in range(7))
PLANES = W | H | D_
MINIMA = dict(min_bin_width=1e-3, min_bin_height=1e-3, min_derivative=1e-3)
MODES = ["analytic", "autodiff"]


def _source(name):
    return open(os.path.join(os.path.dirname(tk.__file__), os.pardir,
                             "csrc", name)).read()


@pytest.fixture
def routes(monkeypatch):
    """``[(kernel, offsets32[, ring routes])]`` of every per-element launch
    the ops would make on the card, read from their CPU implementations
    (the plain versions): the op's operands expanded as its CUDA
    implementation expands them, then ``per_element_offsets32`` (and, for
    kernel D, ``ring_routes``)."""
    seen, inside_d = [], [False]
    plain, bwd_plain, vjp_plain = (tk.rqs_plain, tk.rqs_bwd_plain,
                                   tk.rqs_vjp_plain)

    def fwd(x, w, h, d, tb, **kw):
        if not inside_d[0]:  # D's plain version runs autograd through A's
            seen.append(("A", tk.per_element_offsets32(
                x, tk._expand(x, (w, h, d)), tb)))
        return plain(x, w, h, d, tb, **kw)

    def offsets32(x, w, h, d, tb, cty, ctl):
        return tk.per_element_offsets32(x, tk._expand(x, (w, h, d)), tb,
                                        (cty, ctl), out_planes=w.shape[0] + 1)

    def bwd(x, w, h, d, tb, cty, ctl, **kw):
        seen.append(("C", offsets32(x, w, h, d, tb, cty, ctl)))
        return bwd_plain(x, w, h, d, tb, cty, ctl, **kw)

    def vjp(x, w, h, d, tb, cty, ctl, **kw):
        seen.append(("D", offsets32(x, w, h, d, tb, cty, ctl),
                     tk.ring_routes(x, tk._expand(x, (w, h, d)), tb,
                                    (cty, ctl))))
        inside_d[0] = True
        try:
            return vjp_plain(x, w, h, d, tb, cty, ctl, **kw)
        finally:
            inside_d[0] = False

    monkeypatch.setattr(tk, "rqs_plain", fwd)
    monkeypatch.setattr(tk, "rqs_bwd_plain", bwd)
    monkeypatch.setattr(tk, "rqs_vjp_plain", vjp)
    with tops.cpu_through_ops():
        yield seen


@pytest.fixture
def bwd_mode(request):
    """The backward mode of a test's ``mode`` parameter, reset after."""
    before = tk.get_pallas_bwd_kernel()
    tk.set_pallas_bwd_kernel(request.getfixturevalue("mode"))
    yield request.getfixturevalue("mode")
    tk.set_pallas_bwd_kernel(before)


def _expected(mode, d_routes):
    """The launches of one forward and backward: A, then C, or D with its
    ring routes; every shape here takes 32-bit offsets."""
    return [("A", True), ("C", True) if mode == "analytic"
            else ("D", True, d_routes)]


def _backward(y, ld, seed):
    """A loss whose cotangents are not broadcasts: (y * g).sum() + (ld *
    g').sum() with seeded g, g'."""
    gen = torch.Generator().manual_seed(seed)
    gy = torch.randn(y.shape, generator=gen).to(y.dtype)
    gl = torch.randn(ld.shape, generator=gen).to(ld.dtype)
    ((y * gy).float().sum() + (ld * gl).float().sum()).backward()


def test_ring_constants_match_the_cuda_source():
    """The tile and the block's warps (the per-element schedule's), D's
    stages, its ring's occupancy rule and copy width, and the operand order
    of the ring routes' bits are the CUDA source's."""
    tile = _source("rqs_per_element.cuh")
    ring = _source("rqs_ring.cuh")
    assert f"constexpr int kTile = {tk.RING_TILE};" in tile
    assert f"constexpr int kWarps = {tk.RING_WARPS};" in tile
    assert f"constexpr int kStages = {tk.RING_STAGES};" in ring
    assert f"constexpr int kRingWarps = {tk.RING_MAX_WARPS_PER_SM};" in ring
    assert f"constexpr int kVectorBytes = {tk.RING_VECTOR_BYTES};" in ring
    enum = "enum : int { kX = 0, kW, kH, kD, kTb, kCty, kCtl, kOperands };"
    assert enum in tile
    names = re.findall(r"k([A-Z][a-z]*)", enum)
    assert tuple(n.lower() for n in names[:-1]) == tk.RING_OPERANDS


@pytest.mark.parametrize("name, ring", [("rqs_fwd.cu", False),
                                        ("rqs_bwd.cu", False),
                                        ("rqs_bwd_autodiff.cu", True)])
def test_every_per_element_entry_takes_the_route(name, ring):
    """The C entry points of A, C and D end in the offset width the
    wrappers pass before the stream, D's in its ring routes too, in both
    dtypes; only D's library builds the ring."""
    src = _source(name)
    entries = [e for e in src.split('extern "C" int ')[1:]
               if not e.startswith("rqs_bwd_shared")]
    assert len(entries) == 2
    tail = ("int offsets32, unsigned routes, void* stream)" if ring
            else "int offsets32, void* stream)")
    for e in entries:
        head = " ".join(e[:e.index("{")].split())
        assert head.endswith(tail)
    assert ('#include "rqs_ring.cuh"' in src) is ring


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tail_bound_arr", [None, (2.0, 3.0)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("B, aligned", [(1024, True), (257, False)])
def test_kmajor_feed_route(routes, bwd_mode, B, aligned, dtype,
                           tail_bound_arr, mode):
    """``kmajor_spline_feed``'s planes ((K, D, B), fresh) come into D's
    ring in 16-byte copies while each plane starts on 16 bytes
    (D*B*itemsize); its x, the transposed inputs, and a per-feature tail
    bound (column stride 0) by lanes. The cotangent of y is the transposed
    view of the caller's; that of log|det|, broadcast over the features,
    comes in 16-byte copies when its rows hold whole tiles. A and C take
    only the offset width."""
    K, Dm = 8, 2
    aligned = aligned or dtype == BF16 and B * Dm * 2 % 16 == 0
    rng = np.random.default_rng(B)
    inputs = torch.from_numpy(rng.standard_normal((B, Dm))).to(dtype)
    planes = torch.from_numpy(rng.standard_normal((3 * K - 1, Dm, B)) * 0.5)
    inputs.requires_grad_()
    planes = planes.to(dtype).requires_grad_()
    tba = (torch.tensor(tail_bound_arr, dtype=dtype)
           if tail_bound_arr else None)
    y, ld = kmajor_spline_feed(
        inputs, planes, num_bins=K, tails="linear", tail_bound=3.0,
        tail_bound_arr=tba, softmax_scale=1.0, inverse=False, **MINIMA)
    _backward(y, ld, B)
    planes_bits = PLANES if aligned else 0
    ctl = CTL if B % tk.RING_TILE == 0 else 0
    assert routes == _expected(mode, planes_bits | ctl)


def _image_operands(batch, ct, side, K, dtype, offset):
    """x (B, C, H, W) (at ``offset`` elements into a larger buffer) and the
    planes as the image coupling's ``_image_feed`` builds them from its
    conditioner's (B, C*P, H, W) output."""
    rng = np.random.default_rng(batch + ct)
    n = batch * ct * side * side
    buf = torch.from_numpy(rng.standard_normal(n + offset)).to(dtype)
    x = buf[offset:].view(batch, ct, side, side).requires_grad_()
    out = torch.from_numpy(rng.standard_normal(
        (batch, ct * (3 * K - 1), side, side)) * 0.5).to(dtype)
    out.requires_grad_()
    p = out.reshape(batch, ct, -1, side, side).permute(2, 0, 1, 3, 4)
    return x, p[:K] * 1.0, p[K:2 * K] * 1.0, slice_ud_planes(
        p[2 * K:], K, "linear")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("ct, side", [(6, 16), (12, 8)])
def test_image_views_route(routes, bwd_mode, ct, side, dtype, offset, mode):
    """The image NSF's two levels, (B*C, H*W) views: x and the fresh planes
    in 16-byte copies into D's ring, and x by lanes when it starts off 16
    bytes (one element into its buffer); its cotangents as autograd hands
    them."""
    K, batch = 8, 3
    x, uw, uh, ud = _image_operands(batch, ct, side, K, dtype, offset)
    y, ld = splines.unconstrained_rational_quadratic_spline_kmajor(
        x, uw, uh, ud, tails="linear", tail_bound=3.0, **MINIMA)
    _backward(y, ld, ct)
    xbit = X if offset == 0 else 0
    assert routes == _expected(mode, xbit | PLANES | CTY | CTL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cols", [1, 4])
def test_bin_minor_and_broadcast_parameters_route(routes, bwd_mode, cols,
                                                  mode):
    """``fused_unconstrained_rqs`` with (B, D, K) parameters, as a coupling
    without a bin-major head hands them (bin stride 1, column stride K;
    with D 1 the kernel's cols is 1), and with (B, 1, K) parameters over x
    (B, 4) (column stride 0), and a per-row tail bound: in D's ring the
    parameters by lanes, x in 16-byte copies, the tail bound too where it
    is one column (else by lanes: column stride 0)."""
    K, B = 8, 300
    rng = np.random.default_rng(cols)
    x = torch.from_numpy(rng.standard_normal((B, cols)).astype(np.float32))
    lead = (B, cols) if cols == 1 else (B, 1)
    uw, uh = (torch.from_numpy(rng.standard_normal(lead + (K,))
                               .astype(np.float32)) for _ in range(2))
    ud = torch.from_numpy(rng.standard_normal(lead + (K + 1,))
                          .astype(np.float32))
    tb = torch.linspace(1.5, 3.0, B)[:, None]
    for t in (x, uw, uh, ud):
        t.requires_grad_()
    y, ld = tk.fused_unconstrained_rqs(x, uw, uh, ud, tb)
    _backward(y, ld, cols)
    tbit = TB if cols == 1 else 0
    assert routes == _expected(mode, X | tbit | CTY | CTL)


@pytest.mark.parametrize("mode", MODES)
def test_unaligned_bf16_planes_route(routes, bwd_mode, mode):
    """bfloat16 planes one element into their buffer (2 bytes off 4) come
    into D's ring by lanes, each copying the aligned word that holds its
    element; x and the fresh cotangents in 16-byte copies."""
    K, Dm, B = 4, 3, 640
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal(
        (3 * K + 1) * Dm * B + 1) * 0.5).to(BF16).requires_grad_()
    planes = buf[1:].view(3 * K + 1, Dm, B)
    x = torch.from_numpy(rng.standard_normal((Dm, B))).to(BF16)
    y, ld = tk.fused_unconstrained_rqs_kmajor(
        x, planes[:K], planes[K:2 * K], planes[2 * K:], 3.0)
    _backward(y, ld, 3)
    assert routes == _expected(mode, X | CTY | CTL)


def _meta(shape, stride):
    return torch.empty_strided(shape, stride, device="meta")


@pytest.mark.parametrize("rows, cols, stride0, want32", [
    (3, 2 ** 28 // 3, 1, True),
    (16, 2 ** 27, 1, False),
    (2, 2 ** 30, 1, False),
    (2 ** 15, 2 ** 15, 0, True),
])
def test_offset_width_past_int32(rows, cols, stride0, want32):
    """Synthetic (meta) views: 32-bit offsets while every element offset of
    the call, the K + 1 gradient planes included, stays below
    OFFSETS32_LIMIT; else the 64-bit instantiation. Broadcast planes
    (stride 0) reach no further than x."""
    K = 8
    n = rows * cols
    x2 = _meta((rows, cols), (cols, 1))
    planes = tuple(_meta((p, rows, cols), (n * stride0, cols * stride0,
                                           stride0)) for p in (K, K, K + 1))
    a32 = tk.per_element_offsets32(x2, planes, 3.0)
    c32 = tk.per_element_offsets32(x2, planes, 3.0, (x2, x2),
                                   out_planes=K + 1)
    assert a32 == (want32 and (K + 1) * n * stride0 < tk.OFFSETS32_LIMIT
                   and n < tk.OFFSETS32_LIMIT)
    assert c32 == (want32 and (K + 1) * n < tk.OFFSETS32_LIMIT)


def test_offset_limit_edges():
    """The limit is int32's less the margin of a ring warp's steps past the
    end, and the largest offset of a view sums (size - 1) * stride."""
    assert tk.OFFSETS32_LIMIT == 2 ** 31 - 2 ** 22
    assert tk.largest_offset((3, 5, 7), (35, 7, 1)) == 104
    assert tk.largest_offset((4, 0, 7), (0, 7, 1)) == 0
    assert tk.largest_offset((2, 3), (0, 0)) == 0
    for cols, fits in ((tk.OFFSETS32_LIMIT, True),
                       (tk.OFFSETS32_LIMIT + 1, False)):
        x2 = _meta((1, cols), (cols, 1))
        planes = tuple(_meta((p, 1, cols), (0, 0, 0)) for p in (4, 4, 5))
        assert tk.per_element_offsets32(x2, planes, 1.0) is fits


@pytest.mark.parametrize("shape, stride, address, itemsize, want", [
    # contiguous over (rows, cols): every tile one run, whatever cols
    ((8, 3, 100), (300, 100, 1), 0, 4, True),
    ((3, 100), (100, 1), 64, 4, True),
    # the plane's start off 16 bytes: bin stride 300 * 2 bytes
    ((8, 3, 100), (300, 100, 1), 0, 2, False),
    ((8, 3, 100), (304, 100, 1), 0, 2, True),
    # the buffer off 16 bytes
    ((3, 100), (100, 1), 4, 4, False),
    # rows of whole tiles, their starts on 16 bytes (an image plane's view)
    ((8, 1536, 256), (256, 8 * 256, 1), 0, 4, True),
    ((8, 1536, 256), (256, 8 * 256 + 1, 1), 0, 4, False),
    ((8, 1536, 256), (256, 8 * 256 + 8, 1), 0, 2, True),
    # rows that do not hold whole tiles and are not contiguous
    ((3, 100), (101, 1), 0, 4, False),
    # a transposed x (column stride D), a broadcast (column stride 0)
    ((2, 65536), (1, 2), 0, 4, False),
    ((2, 65536), (1, 0), 0, 4, False),
    # a per-feature broadcast over whole-tile rows: each tile one run
    ((2, 65536), (0, 1), 0, 4, True),
    # one column: tiles run down the rows
    ((300, 1), (1, 1), 0, 4, True),
    ((8, 300, 1), (1, 8, 8), 0, 4, False),
    # one row
    ((1, 1000), (5000, 1), 32, 2, True),
])
def test_vector_copies(shape, stride, address, itemsize, want):
    rows, cols = shape[-2:]
    assert tk.vector_copies(shape, stride, address, itemsize, rows,
                            cols) is want


def test_routes_do_not_depend_on_the_cpu_path(routes):
    """Outside the ops (the CPU's own autograd path) nothing is routed;
    inside, kernel A's offset width is recorded once per launch."""
    x = torch.zeros(4, 64)
    w = torch.zeros(4, 4, 64)
    d = torch.zeros(5, 4, 64)
    tk.rqs_fwd(x, w, w, d, 1.0, inverse=True)
    assert routes == [("A", True)]
