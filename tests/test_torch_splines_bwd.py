"""Kernel C's plain version (``nf_tpu_torch.ops.splines_kernel.
rqs_bwd_plain``) against the JAX package's spline backward.

The JAX side is ``jax.vjp`` of ``splines_pallas.fused_unconstrained_rqs``
(and its ``_kmajor`` twin) with ``interpret=True``: its custom VJP runs the
Pallas backward kernel ``_rqs_bwd_kernel_analytic`` in interpret mode, the
body kernel C ports. Inputs are drawn with numpy from a seed (x ~ N(0, 2²),
so some lie in the identity tails; logits ~ N(0, 0.5²); cotangents ~
N(0, 1)) at B = 300, K in {4, 8}. Tolerance: the JAX package's own
gradient bar (``tests/test_splines_pallas.py:140-145``), 1e-4 abs on each
gradient divided by ``max(max |gradient|, 1)``: gradients reach ~30 here,
and float32 orders the transpose's arithmetic differently in the two
frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import splines as jsp
from nf_tpu.ops import splines_pallas as jpl
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk

G_TOL = 1e-4
B, D = 300, 3


def _draw(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=G_TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _vjp(fn, primals, cts):
    """``jax.vjp`` of ``fn`` at ``primals`` applied to ``cts``, jitted: one
    compile instead of the interpret-mode kernels' op-by-op dispatch."""
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(
        tuple(jnp.asarray(a) for a in primals),
        tuple(jnp.asarray(a) for a in cts))


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [4, 8])
def test_bwd_plain_matches_pallas_vjp_bin_minor(K, inverse):
    rng = np.random.default_rng(K)
    n = B * D
    x = _draw(rng, (n,), 2.0)
    uw, uh = _draw(rng, (n, K), 0.5), _draw(rng, (n, K), 0.5)
    ud = _draw(rng, (n, K + 1), 0.5)
    tb = rng.uniform(1.0, 3.0, n).astype(np.float32)
    cty, ctl = _draw(rng, (n,)), _draw(rng, (n,))
    want = _vjp(lambda *a: jpl.fused_unconstrained_rqs(
        *a, jnp.asarray(tb), inverse=inverse, interpret=True),
        (x, uw, uh, ud), (cty, ctl))
    xt, wt, ht, dt, tbt, cyt, clt = _t(x, uw.T, uh.T, ud.T, tb, cty, ctl)
    got = tk.rqs_bwd_plain(xt, wt, ht, dt, tbt, cyt, clt, inverse=inverse)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):  # (K, n) planes vs (n, K)
        _close(g.T, w)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [4, 8])
def test_bwd_plain_matches_pallas_vjp_kmajor(K, inverse):
    rng = np.random.default_rng(10 + K)
    x = _draw(rng, (D, B), 2.0)
    uw, uh = _draw(rng, (K, D, B), 0.5), _draw(rng, (K, D, B), 0.5)
    ud = _draw(rng, (K + 1, D, B), 0.5)
    tb = np.asarray([1.5, 2.5, 3.0], np.float32)[:, None]
    cty, ctl = _draw(rng, (D, B)), _draw(rng, (D, B))
    want = _vjp(lambda *a: jpl.fused_unconstrained_rqs_kmajor(
        *a, jnp.asarray(tb), inverse=inverse, interpret=True),
        (x, uw, uh, ud), (cty, ctl))
    got = tk.rqs_bwd_plain(*_t(x, uw, uh, ud, tb, cty, ctl),
                           inverse=inverse)
    for g, w in zip(got, want):
        _close(g, w)


_TAILS = {"linear": ("linear", -1), "circular": ("circular", 0),
          "per_feature": (["linear", "circular", "linear"], 1)}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", sorted(_TAILS))
def test_bwd_plain_through_tail_padding_matches_jax(tails, inverse):
    """The k-major feed's tails: the padded derivatives' cotangents fold
    back through ``pad_derivatives`` (linear drops the edge planes,
    circular adds plane K into plane 0, per-feature tails mix them), with a
    per-feature tail bound. JAX: ``jax.vjp`` of its k-major spline with the
    Pallas kernel."""
    K = 4
    tails_arg, extra = _TAILS[tails]
    rng = np.random.default_rng(20)
    x = _draw(rng, (D, B), 2.0)
    uw, uh = _draw(rng, (K, D, B), 0.5), _draw(rng, (K, D, B), 0.5)
    ud = _draw(rng, (K + extra, D, B), 0.5)
    tb = np.asarray([1.5, 2.5, 3.0], np.float32)[:, None]
    cty, ctl = _draw(rng, (D, B)), _draw(rng, (D, B))
    want = _vjp(lambda *a: jsp.unconstrained_rational_quadratic_spline_kmajor(
        *a, inverse=inverse, tails=tails_arg, tail_bound=jnp.asarray(tb),
        use_pallas=True), (x, uw, uh, ud), (cty, ctl))
    xt, wt, ht, udt, tbt, cyt, clt = _t(x, uw, uh, ud, tb, cty, ctl)
    udt.requires_grad_()
    d_pad = tsp.pad_derivatives(udt, tails_arg, 1e-3, axis=0)
    gx, gw, gh, gd = tk.rqs_bwd_plain(xt, wt, ht, d_pad.detach(), tbt, cyt,
                                      clt, inverse=inverse)
    (g_ud,) = torch.autograd.grad(d_pad, udt, gd)
    for g, w in zip((gx, gw, gh, g_ud), want):
        _close(g, w)


@pytest.mark.parametrize("inverse", [False, True])
def test_bwd_plain_broadcast_parameters_sum_over_the_batch(inverse):
    """The unconditional CDF's layout: (1, D, K) parameters broadcast over
    the batch with stride 0. Kernel C emits per-element planes; their batch
    sums (what autograd's expand backward forms) match JAX, whose XLA sums
    the transpose of the broadcast."""
    K = 8
    rng = np.random.default_rng(30)
    x = _draw(rng, (B, D), 2.0)
    uw, uh = _draw(rng, (1, D, K), 0.5), _draw(rng, (1, D, K), 0.5)
    ud = _draw(rng, (1, D, K + 1), 0.5)
    cty, ctl = _draw(rng, (B, D)), _draw(rng, (B, D))
    full = lambda a: jnp.broadcast_to(a, (B, D, a.shape[-1]))
    want = _vjp(lambda x_, w_, h_, d_: jpl.fused_unconstrained_rqs(
        x_, full(w_), full(h_), full(d_), 3.0, inverse=inverse,
        interpret=True), (x, uw, uh, ud), (cty, ctl))
    xt, wt, ht, dt, cyt, clt = _t(x, uw, uh, ud, cty, ctl)
    views = [t.expand(B, D, t.shape[-1]).movedim(-1, 0) for t in (wt, ht, dt)]
    assert all(v.stride(1) == 0 for v in views)
    gx, gw, gh, gd = tk.rqs_bwd_plain(xt, *views, 3.0, cyt, clt,
                                      inverse=inverse)
    _close(gx, want[0])
    for g, w in zip((gw, gh, gd), want[1:]):
        _close(g.sum(1).T[None], w)


@pytest.mark.parametrize("inverse", [False, True])
def test_bwd_plain_matches_autograd_of_the_forward(inverse):
    """The hand-derived transpose against PyTorch's autograd of
    :func:`rqs_plain` (the CPU path's own backward)."""
    K = 8
    rng = np.random.default_rng(40)
    x, cty, ctl = _t(_draw(rng, (D, B), 2.0), _draw(rng, (D, B)),
                     _draw(rng, (D, B)))
    w, h = _t(_draw(rng, (K, D, B), 0.5), _draw(rng, (K, D, B), 0.5))
    (d,) = _t(_draw(rng, (K + 1, D, B), 0.5))
    tb = torch.tensor([[1.5], [2.5], [3.0]])
    leaves = [t.clone().requires_grad_() for t in (x, w, h, d)]
    y, ld = tk.rqs_plain(*leaves, tb, inverse=inverse)
    want = torch.autograd.grad((y * cty).sum() + (ld * ctl).sum(), leaves)
    got = tk.rqs_bwd_plain(x, w, h, d, tb, cty, ctl, inverse=inverse)
    for g, a in zip(got, want):
        _close(g, a)


def test_bwd_gives_no_parameter_gradient_in_the_tails():
    rng = np.random.default_rng(50)
    K = 4
    x = torch.tensor([-5.0, -3.0, 0.3, 3.0, 7.5])
    w, h = _t(_draw(rng, (K, 5), 0.5), _draw(rng, (K, 5), 0.5))
    (d,) = _t(_draw(rng, (K + 1, 5), 0.5))
    cty, ctl = torch.full((5,), 0.7), torch.full((5,), -1.3)
    gx, gw, gh, gd = tk.rqs_bwd_plain(x, w, h, d, 2.0, cty, ctl,
                                      inverse=False)
    outside = torch.tensor([True, True, False, False, True])
    assert torch.all(gx[outside] == 0.7)
    for g in (gw, gh, gd):
        assert torch.all(g[:, outside] == 0)
        assert torch.any(g[:, 2] != 0)


def test_kernel_c_wrapper_takes_only_cuda_tensors():
    x = torch.zeros(8)
    w = torch.zeros(4, 8)
    d = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tk.rqs_bwd(x, w, w, d, 1.0, x, x, inverse=False)
    tk.rqs_bwd.launches = 0
    xs = x.clone().requires_grad_()
    y, ld = tk.rqs_fwd(xs, w, w, d, 1.0, inverse=False)
    (y.sum() + ld.sum()).backward()  # the CPU path: plain autograd
    assert tk.rqs_bwd.launches == 0 and xs.grad is not None
