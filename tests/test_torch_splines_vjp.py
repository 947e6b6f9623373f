"""Kernel D's plain version (``nf_tpu_torch.ops.splines_kernel.
rqs_vjp_plain``) against the JAX package's autodiff spline backward.

The JAX side is ``jax.vjp`` of ``splines_pallas.fused_unconstrained_rqs_
kmajor`` with ``interpret=True`` under ``set_pallas_bwd_kernel("autodiff")``:
its custom VJP runs the Pallas kernel ``_rqs_bwd_kernel`` (the in-kernel
``jax.vjp`` of ``_rqs_math``) in interpret mode, the body kernel D ports.
Inputs are drawn with numpy from a seed (x ~ N(0, 2²), so some lie in the
identity tails, and some exactly at ±tb; logits ~ N(0, 0.5²); cotangents ~
N(0, 1)), with the tail padding of each tail kind and a per-feature tail
bound. Tolerance: the JAX package's gradient bar, 1e-4 abs on each
gradient divided by ``max(max |gradient|, 1)``.

At x = ±tb the two backward kernels differ: JAX's clip passes half of the
cotangent at its bound, so kernel D's x-gradient there is half of kernel
C's, which passes the full slope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import splines_pallas as jpl
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk

G_TOL = 1e-4
B = 150
TB = np.asarray([[np.pi], [3.0]], np.float32)  # per feature, (D, 1)
_TAILS = {"linear": ("linear", -1), "circular": ("circular", 0),
          "mixed": (["circular", "linear"], 1)}


def _draw(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=G_TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _operands(K, tails, seed):
    """x (2, B) with ties at ±tb in its first columns, k-major planes with
    the tail padding of ``tails`` applied, tb (2, 1), cotangents."""
    tails_arg, extra = _TAILS[tails]
    rng = np.random.default_rng(seed)
    x = _draw(rng, (2, B), 2.0)
    x[:, :2] = np.concatenate([TB, -TB], axis=1)
    uw, uh = _draw(rng, (K, 2, B), 0.5), _draw(rng, (K, 2, B), 0.5)
    ud = tsp.pad_derivatives(torch.from_numpy(_draw(rng, (K + extra, 2, B),
                                                    0.5)),
                             tails_arg, 1e-3, axis=0).numpy()
    cty, ctl = _draw(rng, (2, B)), _draw(rng, (2, B))
    return x, uw, uh, ud, cty, ctl


def _jax_vjp(inverse, mode, x, uw, uh, ud, cty, ctl):
    jpl.set_pallas_bwd_kernel(mode)
    try:
        return jax.jit(lambda p, c: jax.vjp(
            lambda *a: jpl.fused_unconstrained_rqs_kmajor(
                *a, jnp.asarray(TB), inverse=inverse, interpret=True),
            *p)[1](c))(tuple(jnp.asarray(a) for a in (x, uw, uh, ud)),
                       (jnp.asarray(cty), jnp.asarray(ctl)))
    finally:
        jpl.set_pallas_bwd_kernel("analytic")


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K,tails", [(4, "linear"), (8, "circular"),
                                     (10, "mixed")])
def test_vjp_plain_matches_jax_autodiff_kernel(K, tails, inverse):
    x, uw, uh, ud, cty, ctl = _operands(K, tails, seed=K)
    want = _jax_vjp(inverse, "autodiff", x, uw, uh, ud, cty, ctl)
    got = tk.rqs_vjp_plain(*_t(x, uw, uh, ud, TB, cty, ctl),
                           inverse=inverse)
    for g, w in zip(got, want):
        _close(g, w)
    if K != 10:
        return
    # the tie columns: JAX's autodiff kernel gives half of its analytic one
    analytic = _jax_vjp(inverse, "analytic", x[:, :2], uw[..., :2],
                        uh[..., :2], ud[..., :2], cty[:, :2], ctl[:, :2])
    _close(got[0][:, :2], 0.5 * np.asarray(analytic[0]))


@pytest.mark.parametrize("inverse", [False, True])
def test_ties_split_where_the_analytic_backward_passes_all(inverse):
    """At x = ±tb, D's plain x-gradient is half of C's plain one (the
    kernels' plain versions, held to JAX above and in
    ``test_torch_splines_bwd.py``); away from ties they agree to rounding
    in the forward direction and to the root formula's conditioning in
    the inverse."""
    x, uw, uh, ud, cty, ctl = _operands(8, "mixed", seed=20)
    ops = _t(x, uw, uh, ud, TB, cty, ctl)
    d = tk.rqs_vjp_plain(*ops, inverse=inverse)
    c = tk.rqs_bwd_plain(*ops, inverse=inverse)
    torch.testing.assert_close(d[0][:, :2], 0.5 * c[0][:, :2], atol=1e-5,
                               rtol=1e-5)
    for gd, gc in zip(d, c):
        _close(gd[..., 2:], gc[..., 2:], 1e-3 if inverse else G_TOL)


def test_split_ties_changes_gradients_only():
    x, uw, uh, ud, _, _ = _operands(4, "linear", seed=30)
    ops = _t(x, uw, uh, ud, TB)
    for inverse in (False, True):
        a = tk.rqs_plain(*ops, inverse=inverse)
        b = tk.rqs_plain(*ops, inverse=inverse, split_ties=True)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_backward_mode_switch():
    assert tk.get_pallas_bwd_kernel() == "analytic"
    with pytest.raises(ValueError, match="unknown backward kernel mode"):
        tk.set_pallas_bwd_kernel("dense")
    tk.set_pallas_bwd_kernel("autodiff")
    try:
        assert tk.get_pallas_bwd_kernel() == "autodiff"
        # the CPU path keeps its autograd: no kernel, the same gradients
        x = torch.linspace(-4.0, 4.0, 9, requires_grad=True)
        w = torch.zeros(4, 9)
        d = torch.zeros(5, 9)
        y, ld = tk.rqs_fwd(x, w, w, d, 3.0, inverse=False)
        (y.sum() + ld.sum()).backward()
        assert tk.rqs_bwd_autodiff.launches == 0
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    with pytest.raises(ValueError, match="CUDA"):
        tk.rqs_bwd_autodiff(x.detach(), w, w, d, 1.0, x.detach(), x.detach(),
                            inverse=False)
