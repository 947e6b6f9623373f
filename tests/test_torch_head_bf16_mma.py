"""The numerics and the layout of the tensor-core bfloat16 kernels B and E,
on the CPU.

Kernel E's head products (gh = W_eff^T gp, gW = gp h_t^T) take the
float32 parameter cotangents gp as two bfloat16 planes, ``hi + lo``
(``spline_head_fused.split_bf16_pair``, the twin of the device split in
``csrc/head_mma_bf16.cuh``), each product summed in float32 over both. So
the plain backward routed through the split (``head_rqs_bwd_plain(...,
split_gp=True)``) is the CPU model of the kernel's arithmetic. Here:

* the split holds gp to ``max(2^-16 |gp|, 2^-134)`` (2^-134: half of
  bfloat16's smallest subnormal, where ``lo`` underflows), at 0,
  subnormals and the largest float32 values too;
* the split backward meets the unsplit one within one bfloat16 ulp
  (``2^-7 |ref| + 1e-6 + 1e-4 max |ref|``, the card tests' gradient bar)
  at K in {4, 8, 10}, linear and circular tails, D in {1, 2}, hidden 64
  and 100, both directions; and JAX's float32 ``fused_head_rqs`` VJP in
  interpret mode at the bfloat16 bar (0.05 abs + 0.05 relative) on a
  subset covering every value of each of those (each JAX trace takes a
  second or two);
* the yardsticks of the card tests, the plain versions on given head
  sums (``head_rqs_plain_on_sums``), are the plain versions bitwise when
  given ``torch.matmul``'s own sums;
* kernel E's planner (``kernel_e_bf16_plan``) admits every shape the
  previous bfloat16 kernel's shared memory admitted and raises
  ValueError where it has no layout; its constants and kernel B's are
  the CUDA sources'.

Inputs from a numpy seed, rounded to bfloat16: x_t ~ N(0, 2²), h_t ~ N(0,
1), the head ~ N(0, (0.3/sqrt(H))²), the bias ~ N(0, 0.1²), cotangents ~
N(0, 1), tail bound 3, B = 96.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu_torch.ops import spline_head_fused as tshf
from test_torch_fused_head_bf16 import _bf16_values, _jax_head

BF16 = torch.bfloat16
TB = 3.0
B = 96
MP_TOL = 0.05  # abs, plus as much relative: the JAX package's bf16 bar
CSRC = Path(tshf.__file__).parent.parent / "csrc"


def _ulps(got, want):
    """max |got - want| over one bfloat16 ulp of ``want`` with the
    gradient slack: ``2^-7 |want| + 1e-6 + 1e-4 max |want|``."""
    g, w = got.double(), want.double()
    bar = 2.0 ** -7 * w.abs() + 1e-6 + 1e-4 * float(w.abs().max())
    return float(((g - w).abs() / bar).max())


def _operands(K, D, tails, H, seed):
    rng = np.random.default_rng(seed)
    m = (3 * K - (1 if tails == "linear" else 0)) * D
    arrs = (rng.standard_normal((D, B)) * 2.0, rng.standard_normal((H, B)),
            rng.standard_normal((m, H)) * (0.3 / np.sqrt(H)),
            rng.standard_normal(m) * 0.1, rng.standard_normal((D, B)),
            rng.standard_normal((D, B)))
    return tuple(_bf16_values(a) for a in arrs)


def _torch(ops, D):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(BF16) for a in ops]
    return t[:4] + [torch.full((D,), TB, dtype=BF16)] + t[4:]


# --- the split -----------------------------------------------------------

def test_split_holds_sixteen_bits_of_gp():
    """hi + lo (in float64) within max(2^-16 |gp|, 2^-134) of gp: random
    values over float32's exponent range, zeros, subnormals (deep and just
    below the normal range) and the largest finite values, where hi
    rounds toward zero instead of overflowing; both planes finite."""
    rng = np.random.default_rng(0)
    rand = rng.standard_normal(20000) * np.exp2(rng.uniform(-140, 127,
                                                            20000))
    f32 = np.finfo(np.float32)
    edge = [0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 5.877e-39,
            float(f32.tiny), -float(f32.tiny), 1.0, -1.2345678, 3.3e38,
            -3.39e38, 3.4e38, float(f32.max), -float(f32.max)]
    gp = torch.from_numpy(np.concatenate([rand, edge]).astype(np.float32))
    hi, lo = tshf.split_bf16_pair(gp)
    assert hi.dtype == lo.dtype == BF16
    assert bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())
    err = (hi.double() + lo.double() - gp.double()).abs()
    bound = torch.maximum(2.0 ** -16 * gp.double().abs(),
                          torch.full_like(err, 2.0 ** -134))
    assert bool((err <= bound).all()), float((err / bound).max())
    # hi is gp rounded to nearest even wherever that is finite, and lo the
    # rounded remainder
    finite = torch.isfinite(gp.to(BF16))
    assert torch.equal(hi[finite], gp[finite].to(BF16))
    assert torch.equal(lo, (gp - hi.float()).to(BF16))


def test_split_keeps_more_of_gp_than_one_bfloat16():
    """On gradient-like values the pair's error is at least 2^7 times
    smaller than bfloat16's alone (which keeps 8 bits)."""
    gp = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                          .astype(np.float32))
    hi, lo = tshf.split_bf16_pair(gp)
    pair = (hi.double() + lo.double() - gp.double()).abs().max()
    one = (gp.to(BF16).double() - gp.double()).abs().max()
    assert float(pair) * 2 ** 7 <= float(one)


# --- the split backward against the unsplit one and against JAX ----------

SPLIT_CASES = [(K, tails, D, H) for K in (4, 8, 10)
               for tails in ("linear", "circular") for D in (1, 2)
               for H in (64, 100)]


@pytest.mark.parametrize("K,tails,D,H", SPLIT_CASES)
def test_split_backward_meets_the_unsplit_one(K, tails, D, H):
    """gx (the same: the split only reaches the head products), gh, gW and
    gb of the split plain backward within one bfloat16 ulp of the unsplit
    one, both directions; bfloat16 out."""
    ops = _torch(_operands(K, D, tails, H, seed=K * 10 + D + H), D)
    for inverse in (False, True):
        kw = dict(num_bins=K, tails=tails, inverse=inverse)
        split = tshf.head_rqs_bwd_plain(*ops, split_gp=True, **kw)
        plain = tshf.head_rqs_bwd_plain(*ops, **kw)
        assert torch.equal(split[0], plain[0])
        for s, p in zip(split, plain):
            assert s.dtype == BF16 and _ulps(s, p) <= 1.0


# each value of K, tails, D, hidden and direction at least once
JAX_CASES = [(4, "linear", 1, 64, False), (8, "circular", 2, 100, True),
             (10, "circular", 1, 100, False), (10, "linear", 2, 64, True)]


@pytest.mark.parametrize("K,tails,D,H,inverse", JAX_CASES)
def test_split_backward_meets_jax(K, tails, D, H, inverse):
    """The split backward's gx, gh, gW and gb against jax.vjp of JAX's
    float32 fused_head_rqs (interpret mode) on the same bfloat16 values,
    at the bfloat16 bar, 0.05 abs + 0.05 relative."""
    arrs = _operands(K, D, tails, H, seed=500 + K + D + H)
    ops = _torch(arrs, D)
    got = tshf.head_rqs_bwd_plain(*ops, num_bins=K, tails=tails,
                                  inverse=inverse, split_gp=True)
    _, want = _jax_head(K, D, tails, inverse, jnp.float32, arrs)
    for g, w in zip(got, want):
        g, w = g.double().numpy(), np.asarray(w, np.float64).reshape(g.shape)
        assert np.all(np.abs(g - w) <= MP_TOL * (1 + np.abs(w)))


# --- the card tests' yardsticks -----------------------------------------

@pytest.mark.parametrize("tails,K,D", [("linear", 8, 2), ("circular", 10, 1)])
def test_plain_on_sums_is_the_plain_version_on_its_own_sums(tails, K, D):
    """Given torch.matmul's own float32 head sums, the on-sums plain
    versions (the card tests' yardsticks for the bfloat16 B and E, which
    take the kernels' sums from head_params_bf16) give the plain versions'
    bits: they differ only in where the sums come from."""
    x_t, h_t, w, b, tb, cty, ctl = _torch(_operands(K, D, tails, 64, 7), D)
    sums = torch.matmul(w.float(), h_t.float())
    for inverse in (False, True):
        kw = dict(num_bins=K, tails=tails, inverse=inverse)
        for got, want in (
                (tshf.head_rqs_plain_on_sums(x_t, sums, b, tb, **kw),
                 tshf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)),
                (tshf.head_rqs_bwd_plain_on_sums(x_t, h_t, w, b, tb, cty,
                                                 ctl, sums, **kw),
                 tshf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty, ctl,
                                         **kw))):
            for g, v in zip(got, want):
                assert g.dtype == BF16 and torch.equal(g, v)


# --- kernel E's planner and the constants -------------------------------

def _parent_bf16_bytes(m, feats, hidden):
    """The shared memory the previous bfloat16 kernel E asked for (its
    float32 gp, W_eff tile and the bfloat16 chunks of h_t at rows of 40),
    as its wrapper computed it; above 232448 bytes it raised."""
    pp = (m // feats + 3) // 4 * 4
    rows = min(128, -(-hidden // 16) * 16)
    split = feats == 1 and hidden <= 128

    def total(buffers):
        w = 4 * rows * feats * pp
        h = 2 * buffers * -(-hidden // 32) * 32 * 40
        return 4 * -(-m // 24) * 24 * 260 + (w + h if split else max(w, h))

    return total(2) if total(2) <= 232448 else total(1)


@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("K", [4, 8, 10])
def test_planner_admits_every_shape_the_previous_kernel_took(K, tails):
    """Over D = 1..20 and hidden 1..2900: every shape the previous
    bfloat16 kernel E admitted has a layout within the H100's 232448 bytes
    per block; where there is none the planner raises ValueError, and the
    wrapper with it, before it builds anything."""
    P = 3 * K - (1 if tails == "linear" else 0)
    hiddens = sorted(set(range(1, 2900, 23)) | {16, 32, 64, 100, 128, 129,
                                                256, 512, 1024, 2048})
    admitted = raised = 0
    for feats in range(1, 21):
        for hidden in hiddens:
            m = P * feats
            before = _parent_bf16_bytes(m, feats, hidden) <= 232448
            try:
                warps, wj, nbytes = tshf.kernel_e_bf16_plan(m, feats,
                                                            hidden)
            except ValueError:
                assert not before, (feats, hidden)
                raised += 1
                continue
            assert nbytes <= 232448 and wj % 32 == 0 and wj >= 32
            assert warps in (4, 8)
            admitted += 1
    assert admitted and raised
    m, feats, hidden = 40 * P, 40, 4096
    with pytest.raises(ValueError, match="kernel E"):
        tshf._launch_bwd(*(torch.zeros(s, dtype=BF16) for s in (
            (feats, 8), (hidden, 8), (m, hidden), (m,), (feats,),
            (feats, 8), (feats, 8))), num_bins=K, tails=tails,
            inverse=False, mbw=1e-3, mbh=1e-3, md=1e-3)


def test_constants_are_the_cuda_sources():
    """The Python twins of the layouts read the CUDA sources' constants:
    kernel E's ring, rows and gW chunks; kernel B's block, ring and tile
    width; the shared product's chunk of H, row pad and warp columns."""
    def consts(name):
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", (CSRC / name).read_text())}

    e, b, mma = (consts(n) for n in ("head_rqs_bwd.cu", "head_rqs_fwd.cu",
                                     "head_mma_bf16.cuh"))
    assert (e["kStagesBf16"], e["kMaxSharedBytes"]) == (
        tshf._E16_STAGES, tshf._MAX_SHARED_BYTES)
    src = (CSRC / "head_rqs_bwd.cu").read_text()
    # a block of W warps: rows of 32 W + 8, gW chunks of 8 W rows of H
    assert "return 32 * warps + nf::mma::kPad;" in src
    assert "{ return 8 * warps; }" in src
    assert (b["kThreadsBf16"], b["kStagesBf16"], b["kMaxTileCols"]) == (
        tshf._B16_THREADS, tshf._B16_STAGES, tshf._B16_TILE_COLS)
    assert (mma["kRK"], mma["kPad"], mma["kWarpCols"]) == (
        tshf._MMA_RK, tshf._MMA_PAD, 32)
    # build_nsf's kernel B (P 23, H 128): the warps' rings (4 x 3 x 32 x
    # 40), W_eff's 32 rows of 136 and the bias; at H 512 a 256-column tile
    assert tshf.kernel_b_bf16_shared_bytes(23, 128) == (
        2 * (4 * 3 * 32 * 40 + 32 * 136) + 4 * 32)
    assert tshf.kernel_b_bf16_shared_bytes(30, 512) == (
        2 * (4 * 3 * 32 * 40 + 32 * 264) + 4 * 32)
