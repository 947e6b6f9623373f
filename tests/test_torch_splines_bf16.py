"""The bfloat16 spline on the CPU: the plain versions of kernels A, C and D
(``rqs_plain``, ``rqs_bwd_plain``, ``rqs_vjp_plain``) and the dense path on
bfloat16 operands, against the JAX package's float32 Pallas kernels.

A bfloat16 kernel of the port reads and writes bfloat16 and computes in
float32 between; its plain version widens a bfloat16 input, runs its
float32 math and rounds each result once. So the reference is the JAX
package's float32 kernel (``fused_unconstrained_rqs_kmajor`` with
``interpret=True``, and ``jax.vjp`` of it under both
``set_pallas_bwd_kernel`` modes) on the same bfloat16-representable inputs,
its results rounded to bfloat16: every element of the port lies within one
bfloat16 ulp of it, ``2^-7 |ref| + 1e-6`` (gradients ``+ 1e-4 max |ref|``,
for those that cancel to near 0). The JAX package's own bfloat16 kernel
computes each operation in bfloat16; its mean error against the float32
kernel bounds the port's from above (in the inverse direction, where it
costs most).

Inputs from a numpy seed: x uniform on [-3.5, 3.5] (some in the identity
tails, two at exactly +-3), logits ~ N(0, 0.5²), tail bound 3, cotangents
~ N(0, 1), all rounded to bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import splines_pallas as jpl
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk

TB = 3.0
N = 1024  # elements per row; two rows
BF16 = torch.bfloat16


def _bf16_values(a):
    """``a`` rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF16).float() \
        .numpy()


def _operands(K, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.5, 3.5, (2, N))
    x[:, 0], x[:, 1] = TB, -TB
    uw, uh = (rng.normal(0, 0.5, (K, 2, N)) for _ in range(2))
    ud = tsp.pad_derivatives(torch.from_numpy(
        rng.normal(0, 0.5, (K - 1, 2, N)).astype(np.float32)), "linear",
        1e-3, axis=0).numpy()
    cty, ctl = (rng.normal(0, 1, (2, N)) for _ in range(2))
    return tuple(_bf16_values(a) for a in (x, uw, uh, ud, cty, ctl))


def _jax_fwd(inverse, dtype, x, uw, uh, ud):
    return jax.jit(lambda *a: jpl.fused_unconstrained_rqs_kmajor(
        *a, jnp.asarray(TB, dtype), inverse=inverse, interpret=True))(
        *(jnp.asarray(a, dtype) for a in (x, uw, uh, ud)))


def _jax_vjp(inverse, mode, dtype, x, uw, uh, ud, cty, ctl):
    jpl.set_pallas_bwd_kernel(mode)
    try:
        return jax.jit(lambda p, c: jax.vjp(
            lambda *a: jpl.fused_unconstrained_rqs_kmajor(
                *a, jnp.asarray(TB, dtype), inverse=inverse,
                interpret=True), *p)[1](c))(
            tuple(jnp.asarray(a, dtype) for a in (x, uw, uh, ud)),
            (jnp.asarray(cty, dtype), jnp.asarray(ctl, dtype)))
    finally:
        jpl.set_pallas_bwd_kernel("analytic")


def _t16(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
            for a in arrs]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_ulp(got, want, grad):
    """``got`` (bfloat16) within one bfloat16 ulp of ``want`` (float32)
    rounded to bfloat16, element by element."""
    ref = _bf16_values(_f32(want))
    bar = 2.0 ** -7 * np.abs(ref) + 1e-6
    if grad:
        bar = bar + 1e-4 * float(np.max(np.abs(ref)))
    over = np.abs(_f32(got) - ref) > bar
    assert not over.any(), (f"{int(over.sum())} of {over.size} elements "
                            f"past one bfloat16 ulp, the worst "
                            f"{float(np.max(np.abs(_f32(got) - ref))):.3g}")


def _mean_err(got, want):
    """Mean |got - want|; a non-finite element of ``got`` counts as an
    infinite error (the JAX package's bfloat16 inverse can give NaN where
    its per-operation rounding drives the root's discriminant negative)."""
    got = _f32(got).astype(np.float64)
    err = np.where(np.isfinite(got),
                   np.abs(got - _f32(want).astype(np.float64)), np.inf)
    return float(np.mean(err))


_TWINS = {"analytic": tk.rqs_bwd_plain, "autodiff": tk.rqs_vjp_plain}


@pytest.mark.parametrize("mode", ["analytic", "autodiff"])
@pytest.mark.parametrize("inverse", [False, True])
def test_twins_are_the_float32_kernels_rounded(inverse, mode):
    """Kernel A's twin against JAX's forward kernel (once per direction);
    kernel C's twin against its analytic backward kernel, kernel D's
    against its autodiff one (ties at +-3 included: half the cotangent to
    each side there). At the image NSF's 8 bins. The mean errors are set
    beside the JAX bfloat16 kernel's in the inverse direction, where
    per-operation rounding costs most (the bfloat16 kernels take seconds
    each to trace in interpret mode)."""
    ops = _operands(8, seed=10 + 2 * inverse + (mode == "autodiff"))
    ops16 = _t16(*ops)
    cases = []
    if mode == "analytic":
        cases.append((tk.rqs_plain(*ops16[:4], TB, inverse=inverse),
                      lambda dtype: _jax_fwd(inverse, dtype, *ops[:4]),
                      False))
    cases.append((_TWINS[mode](*ops16[:4], TB, *ops16[4:],
                               inverse=inverse),
                  lambda dtype: _jax_vjp(inverse, mode, dtype, *ops), True))
    for got, jax_fn, grad in cases:
        want = jax_fn(jnp.float32)
        jax16 = jax_fn(jnp.bfloat16) if inverse else (None,) * len(want)
        for g, w, j in zip(got, want, jax16):
            assert g.dtype == BF16
            _within_ulp(g, w, grad)
            if j is not None:
                assert _mean_err(g, w) <= _mean_err(j, w)


def test_twins_round_their_float32_math_once():
    """A bfloat16 call is the float32 call on the widened operands, each
    result rounded to bfloat16: bitwise, forward and backward; a float32
    call is the undecorated function's, bitwise."""
    x, uw, uh, ud, cty, ctl = _operands(8, seed=30)
    b16 = _t16(x, uw, uh, ud, cty, ctl)
    f32 = [t.float() for t in b16]
    for inverse in (False, True):
        for fn, n in ((tk.rqs_plain, 4), (tk.rqs_bwd_plain, 6),
                      (tk.rqs_vjp_plain, 6)):
            args16 = b16[:4] + [TB] + b16[4:n]
            args32 = f32[:4] + [TB] + f32[4:n]
            got = fn(*args16, inverse=inverse)
            want = fn(*args32, inverse=inverse)
            for g, w in zip(got, want):
                assert torch.equal(g, w.to(BF16))
            raw = fn.__wrapped__(*args32, inverse=inverse)
            for g, w in zip(want, raw):
                assert torch.equal(g, w)


@pytest.mark.parametrize("kmajor", [False, True])
def test_dense_path_computes_bfloat16_in_float32(kmajor):
    """The CPU's dense spline on bfloat16 operands is the float32 dense
    spline of the widened operands, rounded once (values and gradients,
    bitwise); on float32 it is ``identity_tail_spline`` itself, bitwise."""
    x, uw, uh, ud, cty, ctl = _operands(8, seed=31)
    # circular tails: the entry pads by repeating a logit, no constant
    # that rounds in bfloat16 (linear tails pad with a slope-1 logit in
    # the operands' dtype, on the card as here)
    ud = ud[1:]
    if not kmajor:
        uw, uh, ud = (np.moveaxis(a, 0, -1) for a in (uw, uh, ud))
    entry = (tsp.unconstrained_rational_quadratic_spline_kmajor if kmajor
             else tsp.unconstrained_rational_quadratic_spline)
    for inverse in (False, True):
        leaves16 = [t.requires_grad_() for t in _t16(x, uw, uh, ud)]
        leaves32 = [t.detach().float().requires_grad_() for t in leaves16]
        y16, ld16 = entry(*leaves16, inverse=inverse, tails="circular",
                          tail_bound=TB)
        y32, ld32 = entry(*leaves32, inverse=inverse, tails="circular",
                          tail_bound=TB)
        assert torch.equal(y16, y32.to(BF16))
        assert torch.equal(ld16, ld32.to(BF16))
        c16 = _t16(cty, ctl)
        torch.autograd.backward((y16, ld16), c16)
        torch.autograd.backward((y32, ld32), [c.float() for c in c16])
        for a, b in zip(leaves16, leaves32):
            assert a.grad.dtype == BF16
            assert torch.equal(a.grad, b.grad.to(BF16))
        # float32: the dense function itself, no cast on the way
        pad = tsp.pad_derivatives(leaves32[3].detach(), "circular", 1e-3,
                                  axis=0 if kmajor else -1)
        planes = [leaves32[1].detach(), leaves32[2].detach(), pad]
        if kmajor:
            planes = [torch.movedim(p, 0, -1) for p in planes]
        tb = torch.full_like(leaves32[0], TB)
        want = tsp.identity_tail_spline(leaves32[0].detach(), *planes, tb,
                                        inverse)
        assert torch.equal(y32, want[0]) and torch.equal(ld32, want[1])


def test_kernel_checks_take_bfloat16_and_one_dtype():
    x = torch.zeros(2, 4, dtype=BF16)
    w = torch.zeros(8, 2, 4, dtype=BF16)
    d = torch.zeros(9, 2, 4, dtype=BF16)
    tk._check(x, (w, w, d), None, 8)
    with pytest.raises(TypeError, match="one dtype"):
        tk._check(x, (w.float(), w, d), None, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk._check(x.half(), (w.half(), w.half(), d.half()), None, 8)


def test_ops_give_bfloat16_and_the_shared_path_raises():
    """The ops' CPU implementations (the twins) and fake implementations
    give outputs in x's dtype; kernel C's shared-parameter path gives
    bfloat16 too (it has a bfloat16 instantiation), and raises on a dtype
    that has none."""
    x, uw, uh, ud, cty, ctl = (torch.from_numpy(a) for a in _operands(4, 32))
    ops = torch.ops.nf_tpu_torch
    x16, w16, h16, d16, cy16, cl16 = (t.to(BF16) for t in
                                      (x, uw, uh, ud, cty, ctl))
    minima = (1e-3, 1e-3, 1e-3)
    y, ld = ops.rqs_fwd(x16, w16, h16, d16, None, TB, False, *minima)
    assert y.dtype == ld.dtype == BF16
    for op in (ops.rqs_bwd, ops.rqs_bwd_autodiff):
        grads = op(x16, w16, h16, d16, None, TB, cy16, cl16, False,
                   *minima)
        assert all(g.dtype == BF16 for g in grads)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fakes = [mode.from_tensor(t) for t in (x16, w16, h16, d16)]
        assert all(o.dtype == BF16 for o in ops.rqs_fwd(
            *fakes, None, TB, False, *minima))
    shared = [t[:, :1] for t in (w16, h16, d16)]
    grads = ops.rqs_bwd_shared(x16, *shared, None, TB, cy16, cl16, False,
                               *minima)
    assert all(g.dtype == BF16 for g in grads)
    with pytest.raises(TypeError, match="kernel C's shared path"):
        ops.rqs_bwd_shared(x16.half(), *(t.half() for t in shared), None,
                           TB, cy16.half(), cl16.half(), False, *minima)


def test_costs_count_two_bytes_per_bfloat16_element():
    """The ops' cost counts (``ops.cost``, which ``chip_smoke.py``'s bounds
    and ``cost_analysis`` read) move half the float32 bytes in bfloat16
    and count the same operations."""
    from nf_tpu_torch.ops import cost

    x, uw, uh, ud, cty, ctl = (torch.from_numpy(a)
                               for a in _operands(8, seed=33))
    minima = (1e-3, 1e-3, 1e-3)
    f32 = [x, uw, uh, ud, cty, ctl]
    b16 = [t.to(BF16) for t in f32]
    for name in ("rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff"):
        def args(ts):
            spline = (*ts[:4], None, TB)
            return (spline + (False,) if name == "rqs_fwd"
                    else spline + tuple(ts[4:]) + (False,)) + minima
        ops32, bytes32 = cost.COSTS[name](*args(f32))
        ops16, bytes16 = cost.COSTS[name](*args(b16))
        assert ops16 == ops32 and 2 * bytes16 == bytes32
