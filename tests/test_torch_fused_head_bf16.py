"""Kernels B, E and C's shared path in bfloat16 on the CPU, and a bfloat16
coupled NSF, against the JAX package's float32 kernels and model.

A bfloat16 kernel of the port reads and writes bfloat16 and computes in
float32 between, each result rounded once; its plain version
(``head_rqs_plain``, ``head_rqs_bwd_plain``, ``rqs_bwd_shared_plain``)
widens a bfloat16 call's operands, runs its float32 math and rounds each
result once. So the reference is the JAX package's float32 Pallas kernel
(``fused_head_rqs(..., interpret=True)`` and ``jax.vjp`` of it; the
analytic backward of ``fused_unconstrained_rqs_kmajor(..., interpret=True)``
with (1, D, K) parameters broadcast over the batch, whose parameter
cotangents are the batch sums C's shared path forms) on the same
bfloat16-representable inputs, its results rounded to bfloat16: every
element within one bfloat16 ulp, ``2^-7 |ref| + 1e-6`` (gradients
``+ 1e-4 max |ref|``, for those that cancel to near 0), gW, gb and the
shared path's parameter gradients, sums over the batch, at the same bar.
The JAX package's own bfloat16 kernels compute each operation in
bfloat16; their mean error against the float32 kernels bounds the twins'
from above.

Inputs from a numpy seed, rounded to bfloat16: x_t ~ N(0, 2²) (some in
the identity tails), h_t ~ N(0, 1), the head ~ N(0, (0.3/sqrt(H))²), the
bias ~ N(0, 0.1²), cotangents ~ N(0, 1), tail bound 3.

The model is ``build_nsf(permutation=False)``'s stack in bfloat16, built
from the public layers: 2 ``CoupledRationalQuadraticSpline`` (hidden 8, 8
bins, linear tails, bound 3) on a bfloat16 ``DiagGaussian``, B 4096. Its
weights are JAX's float32 ones perturbed by N(0, 0.2²) and loaded with
``load_reference_state_dict``, which rounds each once to bfloat16; the
JAX float32 model then holds those rounded values and runs its fused
head (``set_fused_head_mode("on")``, interpret mode). The port runs on
the CPU's plain path (the unfused bfloat16 head) and through the kernels'
ops (``ops.cpu_through_ops``: kernels B and E's twins, which keep the
head's parameters in float32, as the card does). The bar is the JAX
package's mixed-precision one, 0.05 abs + 0.05 relative, on log-densities,
the forward-KLD loss and the sampler's round trip; the step's gradients
are held as a whole, relative L2 <= 0.3 (as the bfloat16 image NSF's,
``tests/test_torch_image_bf16.py``).
"""

import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu as jnf
import nf_tpu_torch as nt
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu.ops import splines_pallas as jpl
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import ops as tops
from nf_tpu_torch.compat import _reference_names
from nf_tpu_torch.ops import spline_head_fused as tshf
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk
from test_torch_autoregressive import perturb_jax

BF16 = torch.bfloat16
TB = 3.0
B, H = 300, 16
MP_TOL = 0.05  # abs, plus as much relative: the JAX package's bf16 bar
GRAD_TOL = 0.3  # relative L2 distance of the whole gradient vector
MODEL_BATCH, MODEL_HIDDEN, MODEL_BINS = 4096, 8, 8
MINIMA = (1e-3, 1e-3, 1e-3)


def _bf16_values(a):
    """``a`` rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF16).float() \
        .numpy()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_ulp(got, want, grad, what):
    """``got`` (bfloat16) within one bfloat16 ulp of ``want`` (float32)
    rounded to bfloat16, element by element."""
    ref = _bf16_values(_f32(want))
    bar = 2.0 ** -7 * np.abs(ref) + 1e-6
    if grad:
        bar = bar + 1e-4 * float(np.max(np.abs(ref)))
    err = np.abs(_f32(got).reshape(ref.shape) - ref)
    over = err > bar
    assert not over.any(), (f"{what}: {int(over.sum())} of {over.size} "
                            f"elements past one bfloat16 ulp, the worst "
                            f"{float(err.max()):.3g}")


def _mean_err(got, want):
    """Mean |got - want|; a non-finite element of ``got`` counts as an
    infinite error."""
    got = _f32(got).astype(np.float64)
    want = _f32(want).astype(np.float64).reshape(got.shape)
    return float(np.mean(np.where(np.isfinite(got), np.abs(got - want),
                                  np.inf)))


def _head_operands(K, D, tails, seed):
    rng = np.random.default_rng(seed)
    nd = K - 1 if tails == "linear" else K
    m = (2 * K + nd) * D
    arrs = (rng.standard_normal((D, B)) * 2.0,
            rng.standard_normal((H, B)),
            rng.standard_normal((m, H)) * (0.3 / np.sqrt(H)),
            rng.standard_normal(m) * 0.1,
            rng.standard_normal((D, B)), rng.standard_normal((D, B)))
    return tuple(_bf16_values(a) for a in arrs)


def _jax_head(K, D, tails, inverse, dtype, ops):
    """JAX's fused head forward and the cotangents of its VJP (x_t, h_t,
    W, b) on ``ops``, in ``dtype``, interpret mode."""
    x_t, h_t, w, b, cty, ctl = (jnp.asarray(a, dtype) for a in ops)

    def fn(*a):
        return jshf.fused_head_rqs(*a, num_bins=K, tails=tails,
                                   tail_bound=TB, inverse=inverse,
                                   interpret=True)

    def both(p, c):
        out, vjp = jax.vjp(fn, *p)
        return out, vjp(c)

    return jax.jit(both)((x_t, h_t, w, b), (cty, ctl))


# linear and circular tails, 8 and 10 bins, one and two features, both
# directions; whether to hold the mean errors against JAX's bfloat16
# kernels too (their interpret-mode traces take seconds each)
HEAD_CASES = [("linear", 8, 1, True, True), ("linear", 10, 2, False, False),
              ("circular", 8, 2, True, True),
              ("circular", 10, 1, False, False)]


@pytest.mark.parametrize("tails,K,D,inverse,mean", HEAD_CASES)
def test_head_twins_are_the_float32_kernels_rounded(tails, K, D, inverse,
                                                     mean):
    """Kernel B's twin against JAX's ``_head_kernel`` and kernel E's
    against its ``_head_bwd_kernel`` (through ``jax.vjp``), both in
    float32: y, ld, gx and gh element by element, gW and gb (sums over the
    batch) too, each within one bfloat16 ulp; and bfloat16 out. In the
    inverse direction, where per-operation rounding costs most, the twins'
    mean errors lie at or below the JAX bfloat16 kernels' (at both
    tails)."""
    ops = _head_operands(K, D, tails, seed=40 + 4 * K + D + inverse)
    x_t, h_t, w, b, cty, ctl = (torch.from_numpy(
        np.ascontiguousarray(a)).to(BF16) for a in ops)
    tb = torch.full((D,), TB, dtype=BF16)
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    fwd = tshf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
    bwd = tshf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty, ctl, **kw)
    (y_j, ld_j), grads_j = _jax_head(K, D, tails, inverse, jnp.float32, ops)
    got = list(fwd) + list(bwd)
    want = [y_j, ld_j] + list(grads_j)
    names = ("y", "ld", "gx", "gh", "gW", "gb")
    for name, g, wnt in zip(names, got, want):
        assert g.dtype == BF16 and tuple(g.shape) == tuple(wnt.shape), name
        _within_ulp(g, wnt, name not in ("y", "ld"), name)
    if mean:
        (y16, ld16), grads16 = _jax_head(K, D, tails, inverse, jnp.bfloat16,
                                         ops)
        for name, g, wnt, j in zip(names, got, want,
                                   [y16, ld16] + list(grads16)):
            assert _mean_err(g, wnt) <= _mean_err(j, wnt), name


def test_head_twins_in_kernel_order_round_their_float32_math_once():
    """The in-kernel-order twins (the card tests' yardsticks for B and E)
    take bfloat16 as the others do: the float32 call on the widened
    operands, each result rounded once, bitwise."""
    ops = _head_operands(8, 1, "linear", seed=60)
    t16 = [torch.from_numpy(np.ascontiguousarray(a)).to(BF16) for a in ops]
    t32 = [t.float() for t in t16]
    kw = dict(num_bins=8, tails="linear", inverse=True)
    for fn, n in ((tshf.head_rqs_plain_in_kernel_order, 4),
                  (tshf.head_rqs_bwd_plain_in_kernel_order, 6)):
        got = fn(*t16[:4], torch.full((1,), TB, dtype=BF16), *t16[4:n],
                 **kw)
        want = fn(*t32[:4], torch.full((1,), TB), *t32[4:n], **kw)
        for g, wnt in zip(got, want):
            assert g.dtype == BF16 and torch.equal(g, wnt.to(BF16))


def _shared_operands(K, D, seed):
    """x (B, D) away from the ties at +-tb, (1, D, K) widths and heights,
    (1, D, K+1) padded derivatives (linear tails), cotangents (B, D)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)) * 2.0
    x = np.where(np.abs(np.abs(x) - TB) < 1e-2, 0.5, x)
    uw, uh = (rng.normal(0, 0.5, (1, D, K)) for _ in range(2))
    ud = tsp.pad_derivatives(torch.from_numpy(
        rng.normal(0, 0.5, (1, D, K - 1)).astype(np.float32)), "linear",
        1e-3, axis=-1).numpy()
    cty, ctl = (rng.standard_normal((B, D)) for _ in range(2))
    return tuple(_bf16_values(a) for a in (x, uw, uh, ud, cty, ctl))


def _jax_shared_vjp(inverse, dtype, x, uw, uh, ud, cty, ctl):
    """The cotangents of x and of the (1, D, K) parameters (summed over
    the batch by the VJP of their broadcast) through JAX's analytic Pallas
    backward in ``dtype``."""
    def fn(x, w, h, d):
        planes = [jnp.broadcast_to(jnp.moveaxis(t, -1, 0),
                                   (t.shape[-1],) + x.shape)
                  for t in (w, h, d)]
        return jpl.fused_unconstrained_rqs_kmajor(
            x, *planes, jnp.asarray(TB, dtype), inverse=inverse,
            interpret=True)

    jpl.set_pallas_bwd_kernel("analytic")
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(
        tuple(jnp.asarray(a, dtype) for a in (x, uw, uh, ud)),
        (jnp.asarray(cty, dtype), jnp.asarray(ctl, dtype)))


@pytest.mark.parametrize("inverse,K", [(False, 8), (True, 10)])
def test_shared_twin_is_the_float32_kernel_rounded(inverse, K):
    """Kernel C's shared path in bfloat16 (the unconditional CDF's
    backward): gx element by element and the parameter gradients, summed
    over the batch, within one bfloat16 ulp of JAX's float32 Pallas
    backward; the mean errors at or below JAX's bfloat16 kernel's in the
    inverse direction."""
    D = 2
    x, uw, uh, ud, cty, ctl = _shared_operands(K, D, seed=70 + K + inverse)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
         for a in (x, uw, uh, ud, cty, ctl)]
    planes = [p[0].T[:, None] for p in t[1:4]]  # (P, 1, D)
    got = tk.rqs_bwd_shared_plain(t[0], *planes, TB, t[4], t[5],
                                  inverse=inverse)
    want = _jax_shared_vjp(inverse, jnp.float32, x, uw, uh, ud, cty, ctl)
    # JAX's parameter cotangents are (1, D, P); the port's (P, 1, D)
    want = [want[0]] + [np.moveaxis(np.asarray(g), -1, 0) for g in want[1:]]
    for name, g, wnt in zip(("gx", "gw", "gh", "gd"), got, want):
        assert g.dtype == BF16, name
        _within_ulp(g, wnt, True, name)
    if inverse:
        j16 = _jax_shared_vjp(inverse, jnp.bfloat16, x, uw, uh, ud, cty, ctl)
        j16 = [j16[0]] + [np.moveaxis(_f32(g), -1, 0) for g in j16[1:]]
        for name, g, wnt, j in zip(("gx", "gw", "gh", "gd"), got, want,
                                   j16):
            assert _mean_err(g, wnt) <= _mean_err(j, wnt), name


def test_twins_round_their_float32_math_once():
    """A bfloat16 call of B's, E's and C's shared twins is the float32
    call on the widened operands, each result rounded once, bitwise; a
    float32 call is the undecorated function's, bitwise (the float32
    twins are unchanged)."""
    ops = _head_operands(8, 2, "linear", seed=61)
    h16 = [torch.from_numpy(np.ascontiguousarray(a)).to(BF16) for a in ops]
    h32 = [v.float() for v in h16]
    kw = dict(num_bins=8, tails="linear", inverse=False)
    tb16, tb32 = torch.full((2,), TB, dtype=BF16), torch.full((2,), TB)
    calls = [(tshf.head_rqs_plain, h16[:4] + [tb16], h32[:4] + [tb32], kw),
             (tshf.head_rqs_bwd_plain, h16[:4] + [tb16] + h16[4:],
              h32[:4] + [tb32] + h32[4:], kw)]
    s = [torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
         for a in _shared_operands(8, 2, seed=62)]
    s16 = [s[0]] + [p[0].T[:, None] for p in s[1:4]] + [TB] + s[4:]
    s32 = [v.float() if isinstance(v, torch.Tensor) else v for v in s16]
    calls.append((tk.rqs_bwd_shared_plain, s16, s32,
                  dict(inverse=True)))
    for fn, a16, a32, kwargs in calls:
        got, want = fn(*a16, **kwargs), fn(*a32, **kwargs)
        for g, w in zip(got, want):
            assert g.dtype == BF16 and torch.equal(g, w.to(BF16))
        for g, w in zip(want, fn.__wrapped__(*a32, **kwargs)):
            assert g.dtype == torch.float32 and torch.equal(g, w)


def test_ops_take_bfloat16_and_one_dtype():
    """The ops of B, E and C's shared path: their CPU implementations (the
    twins) and fake implementations give bfloat16 on bfloat16 operands; the
    wrappers raise on mixed dtypes and on float16; kernel E's shared
    memory in float32 and in bfloat16 (its own layout) follows the
    constants of the CUDA source. (On the CPU a float16
    call takes the plain path, as kernel A's wrapper does.)"""
    ops = _head_operands(8, 1, "linear", seed=63)
    x_t, h_t, w, b, cty, ctl = (torch.from_numpy(
        np.ascontiguousarray(a)).to(BF16) for a in ops)
    tb = torch.full((1,), TB, dtype=BF16)
    lib = torch.ops.nf_tpu_torch
    outs = list(lib.head_rqs_fwd(x_t, h_t, w, b, tb, 8, False, False,
                                 *MINIMA))
    outs += list(lib.head_rqs_bwd(x_t, h_t, w, b, tb, 8, False, cty, ctl,
                                  False, *MINIMA))
    assert all(o.dtype == BF16 for o in outs)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fakes = [mode.from_tensor(v) for v in (x_t, h_t, w, b, tb)]
        assert all(o.dtype == BF16 for o in lib.head_rqs_fwd(
            *fakes, 8, False, False, *MINIMA))
    s = [torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
         for a in _shared_operands(4, 2, seed=64)]
    planes = [p[0].T[:, None] for p in s[1:4]]
    grads = lib.rqs_bwd_shared(s[0], *planes, None, TB, s[4], s[5], False,
                               *MINIMA)
    assert [g.dtype for g in grads] == [BF16] * 4
    with pytest.raises(TypeError, match="kernel C's shared path"):
        lib.rqs_bwd_shared(s[0].half(), *(p.half() for p in planes), None,
                           TB, s[4].half(), s[5].half(), False, *MINIMA)
    with tops.cpu_through_ops():
        with pytest.raises(TypeError, match="all of one dtype"):
            tshf.fused_head_rqs(x_t, h_t, w.float(), b, num_bins=8,
                                tail_bound=TB)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tshf._launch_bwd(x_t.half(), h_t.half(), w.half(), b.half(),
                         tb.half(), cty.half(), ctl.half(), num_bins=8,
                         tails="linear", inverse=False, mbw=1e-3, mbh=1e-3,
                         md=1e-3)
    src = (Path(tshf.__file__).parent.parent / "csrc"
           / "head_rqs_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kStagesBf16"]) == tshf._E16_STAGES
    # build_nsf's kernel E (M 23, H 128): float32, 4 * 24 * 260 bytes of
    # gp, the 128 x 24 float32 W_eff tile, two chunks of h_t at 128 x 36
    # floats; bfloat16, a block of 8 warps: gp's two planes at 32 rows of
    # 264, the region of h_t (two gW chunks of 64 rows of 264, over the
    # warps' rings of 3 x 32 x 40), the warps' gb shares and the W_eff tile
    # at 32 rows of 136: two blocks to an SM
    gp, wt = 4 * 24 * 260, 4 * 128 * 24
    assert tshf.kernel_e_shared_bytes(23, 1, 128) == gp + wt + 2 * 4 * 128 * 36
    assert tshf.kernel_e_bf16_plan(23, 1, 128) == (
        8, 128, 2 * 2 * 32 * 264 + 2 * 2 * 64 * 264 + 4 * 8 * 32
        + 2 * 32 * 136)


def test_costs_halve_the_batch_planes():
    """``ops.cost`` (``chip_smoke.py``'s bounds) counts B's and E's batch
    planes and head, and C's shared path's operands, at 2 bytes in
    bfloat16, and the same operations."""
    from nf_tpu_torch.ops import cost

    ops = _head_operands(8, 1, "linear", seed=65)
    f32 = [torch.from_numpy(np.ascontiguousarray(a)) for a in ops]
    b16 = [v.to(BF16) for v in f32]

    def head_args(t, bwd):
        tb = torch.full((1,), TB, dtype=t[0].dtype)
        return ((*t[:4], tb, 8, False) + ((t[4], t[5]) if bwd else ())
                + (False,) + MINIMA)

    for name, bwd in (("head_rqs_fwd", False), ("head_rqs_bwd", True)):
        o32, n32 = cost.COSTS[name](*head_args(f32, bwd))
        o16, n16 = cost.COSTS[name](*head_args(b16, bwd))
        assert o16 == o32 and 2 * n16 == n32
    s32 = [torch.from_numpy(np.ascontiguousarray(a))
           for a in _shared_operands(8, 2, seed=66)]
    s16 = [v.to(BF16) for v in s32]

    def shared_args(t):
        return ((t[0], *(p[0].T[:, None] for p in t[1:4]), None, TB,
                 t[4], t[5], False) + MINIMA)

    o32, n32 = cost.COSTS["rqs_bwd_shared"](*shared_args(s32))
    o16, n16 = cost.COSTS["rqs_bwd_shared"](*shared_args(s16))
    assert o16 == o32 and 2 * n16 == n32


def _chip_smoke():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bf16_bounds_take_the_tensor_core_peak():
    """``chip_smoke.bound`` takes a bfloat16 kernel's operations at the
    card's bfloat16 tensor-core peak, a float32 one's at the CUDA cores'
    float32 peak: at build_nsf's kernel B (H 128, M 23, B 65536) the
    bfloat16 bound is its bytes', the float32 one too."""
    cs = _chip_smoke()
    peaks = cs.SXM_PEAKS
    ops = 2 * 23 * 128 * 65536
    b16 = cs.bound(17176368, ops, peaks, torch.bfloat16)
    b32 = cs.bound(34352736, ops, peaks)
    assert b16 == (17176368 / peaks[0] * 1e3, "bytes")
    assert b32 == (34352736 / peaks[0] * 1e3, "bytes")
    assert cs.bound(0, ops, peaks, torch.bfloat16) == (
        ops / 989e12 * 1e3, "operations")
    assert cs.bound(0, ops, peaks) == (ops / 67e12 * 1e3, "operations")


def test_ptxas_kernels_reads_every_template_bool():
    """``chip_smoke.ptxas_kernels`` names B's, E's and the spline kernels'
    instantiations by kernel and dtype, with K and every template bool,
    so that the build phase can hold each bfloat16 instantiation's spills
    against its float32 twin's."""
    lines = []
    for t, spill in (("f", 0), ("13__nv_bfloat16", 4)):
        lines += [
            f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
            f"head_rqs_bwd_kernelI{t}Li8ELb1ELb0ELb1EEEvPKT_' for 'sm_90a'",
            f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes "
            f"spill loads",
            "ptxas info    : Used 128 registers, 380 bytes cmem[0]",
            f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115"
            f"reduce_partialsI{t}EEvPKfiiiPT_S4_' for 'sm_90a'",
            "ptxas info    : Used 20 registers",
            f"ptxas info    : Compiling entry function '_ZN2nf14rqs_bwd_kernel"
            f"INS_12AnalyticMathE{t}Li4ELb1EEEvPKT0_' for 'sm_90a'",
            "ptxas info    : Used 60 registers"]
    got = _chip_smoke().ptxas_kernels("\n".join(lines))
    assert got == {
        "head_rqs_bwd_kernel": [(8, "101", 128, 0)],
        "head_rqs_bwd_kernel bf16": [(8, "101", 128, 4)],
        "reduce_partials": [(0, "", 20, 0)],
        "reduce_partials bf16": [(0, "", 20, 0)],
        "rqs_bwd_kernel": [(4, "1", 60, 0)],
        "rqs_bwd_kernel bf16": [(4, "1", 60, 0)]}


# --- the bfloat16 coupled NSF ------------------------------------------------

_PAIR = {}


def _layers(dtype):
    return [nt.flows.CoupledRationalQuadraticSpline(
        num_input_channels=2, num_blocks=2,
        num_hidden_channels=MODEL_HIDDEN, num_bins=MODEL_BINS,
        tails="linear", tail_bound=TB, reverse_mask=(i % 2 == 1),
        dtype=dtype) for i in range(2)]


def _port_model(dtype):
    return nt.NormalizingFlow(
        nt.distributions.DiagGaussian(2, trainable=False, dtype=dtype),
        _layers(dtype))


def _pair():
    """(JAX float32 model holding the port model's bfloat16 weights, the
    port's bfloat16 model, the exported JAX weights before the
    rounding)."""
    if not _PAIR:
        keys = jax.random.split(jax.random.PRNGKey(17), 2)
        flows = [jnf.flows.CoupledRationalQuadraticSpline.create(
            keys[i], num_input_channels=2, num_blocks=2,
            num_hidden_channels=MODEL_HIDDEN, num_bins=MODEL_BINS,
            tails="linear", tail_bound=TB, reverse_mask=(i % 2 == 1))
            for i in range(2)]
        j32 = perturb_jax(jnf.NormalizingFlow.create(
            jnf.distributions.DiagGaussian.create(2, trainable=False),
            flows), 17, scale=0.2)
        sd = {k: np.asarray(v) for k, v in export_state_dict(j32).items()}
        t16 = nt.load_reference_state_dict(_port_model(BF16), sd)
        names = _reference_names(t16, t16.state_dict())
        rounded = {names[k]: v.float().numpy()
                   for k, v in t16.state_dict().items()
                   if v.is_floating_point()}
        _PAIR.update(j=import_state_dict(j32, {**sd, **rounded}), t=t16,
                     sd=sd)
    return _PAIR["j"], _PAIR["t"], _PAIR["sd"]


def _batch(seed):
    """Two-moons-like points from a numpy seed, as bfloat16 and as the
    float32 values of those bfloat16 numbers."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((MODEL_BATCH, 2)) * 1.2)
                         .astype(np.float32)).to(BF16)
    return x, jnp.asarray(x.float().numpy())


def mp_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=MP_TOL,
                               rtol=MP_TOL)


def _jax_fused(fn, *args):
    jshf.set_fused_head_mode("on")
    try:
        return jax.jit(fn)(*args)
    finally:
        jshf.set_fused_head_mode("auto")


def test_load_rounds_each_float32_weight_once():
    """JAX's float32 ``export_state_dict`` loads into the bfloat16 layers
    (``load_reference_state_dict``), each weight rounded to nearest even
    once; every parameter and the base stay bfloat16."""
    _, t16, sd = _pair()
    names = _reference_names(t16, t16.state_dict())
    for k, v in t16.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == BF16, k
            assert torch.equal(v, torch.from_numpy(
                np.array(sd[names[k]], np.float32)).to(BF16)), k


@pytest.mark.parametrize("feed", ["plain", "through_ops"])
def test_model_is_jax_float32_at_the_bf16_bar(feed):
    """``log_prob`` and the forward-KLD loss of the bfloat16 model against
    JAX's float32 model (its fused head) at the bf16 bar, and one step's
    gradients as a whole (relative L2 <= 0.3), bfloat16 and finite; on the
    CPU's plain path and through the kernels' ops, where kernels B and E
    (and A and C's shared path on the CDF) run their twins."""
    jmodel, t16, _ = _pair()
    tmodel = copy.deepcopy(t16)
    x16, xj = _batch(18)
    params, static = partition(jmodel)
    lp_j, (loss_j, grads) = _jax_fused(
        lambda m, p, v: (m.log_prob(v), jax.value_and_grad(
            lambda q: combine(q, static).forward_kld(v))(p)),
        jmodel, params, xj)
    with (tops.cpu_through_ops() if feed == "through_ops"
          else torch.enable_grad()):
        lp = tmodel.log_prob(x16)
        loss = tmodel.forward_kld(x16)
        loss.backward()
    assert lp.dtype == BF16 and lp.shape == (MODEL_BATCH,)
    mp_close(lp.detach().float(), lp_j)
    mp_close(float(loss.detach()), float(loss_j))
    # JAX's gradients in the port's layout: loaded into a float32 twin
    want = nt.load_reference_state_dict(
        _port_model(torch.float32),
        export_state_dict(combine(grads, static))).state_dict()
    diff = total = 0.0
    for n, p in tmodel.named_parameters():
        assert p.grad.dtype == BF16 and bool(torch.isfinite(p.grad).all()), n
        diff += float(((p.grad.double() - want[n].double()) ** 2).sum())
        total += float((want[n].double() ** 2).sum())
    assert (diff / total) ** 0.5 <= GRAD_TOL


def test_sample_round_trip_at_the_bf16_bar():
    """``sample`` of the bfloat16 model: its draws' ``log_prob`` against
    its ``log_q``, and JAX's float32 ``log_prob`` of the same draws, at
    the bf16 bar, through the kernels' ops."""
    jmodel, t16, _ = _pair()
    with torch.no_grad(), tops.cpu_through_ops():
        z, log_q = t16.sample(MODEL_BATCH,
                              generator=torch.Generator().manual_seed(19))
        lp = t16.log_prob(z)
    assert z.dtype == BF16 and z.shape == (MODEL_BATCH, 2)
    assert bool(torch.isfinite(log_q.float()).all())
    mp_close(lp.float(), log_q.float())
    lp_j = _jax_fused(lambda m, v: m.log_prob(v), jmodel,
                      jnp.asarray(z.float().numpy()))
    mp_close(lp_j, log_q.float())
