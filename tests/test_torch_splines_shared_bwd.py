"""Kernel C's shared-parameter path in plain PyTorch
(``nf_tpu_torch.ops.splines_kernel.rqs_bwd_shared_plain``) against the JAX
package, and the shape contract of the autograd wiring around kernels A,
C and D.

The JAX side is ``jax.vjp`` of ``nf_tpu.ops.splines.
unconstrained_rational_quadratic_spline`` with the unconditional CDF's
(1, D, K) parameters broadcast over the batch, on the CPU (its dense path,
as the JAX package's own tests run it there): its parameter cotangents are
the batch sums that the shared path forms. Inputs are drawn with numpy from
a seed: x ~ N(0, 2²), so some lie in the identity tails, and the first two
rows exactly at ±tb; logits ~ N(0, 0.5²); cotangents ~ N(0, 1); linear
tails, so the derivative cotangents fold back through the padding.

Bars: the JAX package's gradient bar (``tests/test_splines_pallas.py:
140-145``), 1e-4 abs after dividing by max(max |gradient|, 1), on the
sums (they reach ~20 here, and the two frameworks sum in other orders) and
on gx (up to ~30 in the inverse direction, where JAX's autodiff of the
dense spline and the analytic transpose round differently by up to ~3e-4
abs). Against ``rqs_bwd_plain`` gx is equal to the bit, and the sums are
held at the same bar against the float64 sums of its planes. At x = ±tb
JAX's ``jnp.clip`` passes half of the cotangent at its bound, and kernel
C's analytic transpose all of it, so there gx is twice JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import splines as jsp
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk

SUM_TOL, G_TOL = 1e-4, 1e-4
B = 300


def _draw(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel_close(got, want, tol=SUM_TOL):
    got, want = (np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                            np.float64) for t in (got, want))
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _operands(K, D, tb_kind, seed):
    """x (B, D) with rows 0 and 1 at +tb and -tb, (1, D, K) widths and
    heights, (1, D, K-1) derivatives (linear tails), cotangents (B, D), and
    the tail bound: 3 or one per column in [1.5, 3]."""
    rng = np.random.default_rng(seed)
    tb = (np.float32(3.0) if tb_kind == "float"
          else np.linspace(1.5, 3.0, D, dtype=np.float32)[None])
    x = _draw(rng, (B, D), 2.0)
    x[0], x[1] = tb, -tb
    uw, uh = _draw(rng, (1, D, K), 0.5), _draw(rng, (1, D, K), 0.5)
    ud = _draw(rng, (1, D, K - 1), 0.5)
    cty, ctl = _draw(rng, (B, D)), _draw(rng, (B, D))
    return x, uw, uh, ud, tb, cty, ctl


def _shared_plain(x, uw, uh, ud, tb, cty, ctl, inverse):
    """``rqs_bwd_shared_plain`` on the torch side of :func:`_operands`:
    ``(gx, gw, gh, gd)`` as it returns them, the padded derivatives, and
    the cotangent of the unpadded ones (through ``pad_derivatives``)."""
    ud_t = torch.from_numpy(ud).requires_grad_()
    d_pad = tsp.pad_derivatives(ud_t, "linear", 1e-3, axis=-1)
    tb_t = float(tb) if np.ndim(tb) == 0 else torch.from_numpy(tb)
    out = tk.rqs_bwd_shared_plain(
        torch.from_numpy(x), torch.from_numpy(uw).movedim(-1, 0),
        torch.from_numpy(uh).movedim(-1, 0), d_pad.detach().movedim(-1, 0),
        tb_t, torch.from_numpy(cty), torch.from_numpy(ctl), inverse=inverse)
    (g_ud,) = torch.autograd.grad(d_pad, ud_t, out[3].movedim(0, -1))
    return out, d_pad.detach(), g_ud


CASES = [(K, D, inverse, tb_kind) for K in (4, 8, 10) for D in (1, 4)
         for inverse in (False, True) for tb_kind in ("float", "per_column")]


@pytest.mark.parametrize("K,D,inverse,tb_kind", CASES)
def test_shared_plain_matches_jax_batch_sums(K, D, inverse, tb_kind):
    ops = _operands(K, D, tb_kind, seed=K * 10 + D)
    x, uw, uh, ud, tb, cty, ctl = ops

    def spline(x_, w_, h_, d_):
        return jsp.unconstrained_rational_quadratic_spline(
            x_, w_, h_, d_, inverse=inverse, tails="linear",
            tail_bound=jnp.asarray(tb))

    want = jax.jit(lambda p, c: jax.vjp(spline, *p)[1](c))(
        tuple(jnp.asarray(a) for a in (x, uw, uh, ud)),
        (jnp.asarray(cty), jnp.asarray(ctl)))
    (gx, gw, gh, _), _, g_ud = _shared_plain(*ops, inverse)
    want_gx = np.asarray(want[0]).copy()
    want_gx[:2] *= 2.0  # at ±tb JAX's clip passes half of the cotangent
    _rel_close(gx, want_gx, G_TOL)
    for got, w in zip((gw.movedim(0, -1), gh.movedim(0, -1), g_ud),
                      want[1:]):
        assert got.shape == w.shape
        _rel_close(got, w)


@pytest.mark.parametrize("K,D,inverse,tb_kind", CASES)
def test_shared_plain_matches_summed_planes(K, D, inverse, tb_kind):
    """Against ``rqs_bwd_plain``'s per-element planes summed over the batch
    in float64: the same cotangents, summed per (column, bin) before the
    transpose instead of after it; gx is computed the same way."""
    x, uw, uh, ud, tb, cty, ctl = _operands(K, D, tb_kind, seed=K + D)
    (gx, *sums), d_pad, _ = _shared_plain(x, uw, uh, ud, tb, cty, ctl,
                                          inverse)
    planes = [torch.from_numpy(a).expand(B, D, a.shape[-1]).movedim(-1, 0)
              for a in (uw, uh)] + [d_pad.expand(B, D, K + 1).movedim(-1, 0)]
    tb_plain = float(tb) if np.ndim(tb) == 0 else torch.from_numpy(
        tb).expand(B, D)
    px, pw, ph, pd = tk.rqs_bwd_plain(
        torch.from_numpy(x), *planes, tb_plain, torch.from_numpy(cty),
        torch.from_numpy(ctl), inverse=inverse)
    assert torch.equal(gx, px)
    for got, p in zip(sums, (pw, ph, pd)):
        assert got.shape == (p.shape[0], 1, D)
        _rel_close(got, p.double().sum(1, keepdim=True))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tb_kind", ["float", "per_column"])
def test_shared_plain_with_no_rows_gives_zero_sums(inverse, tb_kind):
    """An empty batch, x (0, D): the sums are zeros in the parameters'
    shape, as JAX's batch sums over no rows are."""
    K, D = 8, 4
    x, uw, uh, ud, tb, cty, ctl = _operands(K, D, tb_kind, seed=5)
    x, cty, ctl = x[:0], cty[:0], ctl[:0]

    def spline(x_, w_, h_, d_):
        return jsp.unconstrained_rational_quadratic_spline(
            x_, w_, h_, d_, inverse=inverse, tails="linear",
            tail_bound=jnp.asarray(tb))

    want = jax.vjp(spline, *(jnp.asarray(a) for a in (x, uw, uh, ud)))[1](
        (jnp.asarray(cty), jnp.asarray(ctl)))
    (gx, gw, gh, _), _, g_ud = _shared_plain(x, uw, uh, ud, tb, cty, ctl,
                                             inverse)
    assert gx.shape == (0, D)
    for got, w in zip((gw.movedim(0, -1), gh.movedim(0, -1), g_ud),
                      want[1:]):
        assert got.shape == w.shape
        assert not np.any(np.asarray(w))
        assert not torch.any(got)


def test_shared_plain_refuses_parameters_that_vary_down_the_rows():
    K, rows, cols = 4, 5, 2
    x = torch.zeros(rows, cols)
    w = torch.zeros(K, rows, cols)
    d = torch.zeros(K + 1, 1, cols)
    with pytest.raises(ValueError, match="not shared by the rows"):
        tk.rqs_bwd_shared_plain(x, w, w, d, 1.0, x, x, inverse=False)
    with pytest.raises(ValueError, match="not shared by the rows"):
        tk.rqs_bwd_shared_plain(x, d[:K], d[:K], d, torch.ones(rows, 1), x,
                                x, inverse=False)


# the broadcastable parameter shapes a caller hands kernel A, by x's shape:
# (x shape, parameter shape without its plane dim, the (r, c) of the view
# the Function sees)
BROADCASTS = [
    ((300, 3), (1, 3), (1, 3)),  # the CDF: shared by the rows
    ((300, 3), (3,), (1, 3)),  # the same, with fewer dims
    ((300, 3), (300, 1), (300, 1)),  # shared by the columns
    ((300, 3), (1, 1), (1, 1)),  # shared by every element
    ((300, 3), (), (1, 1)),
    ((300, 3), (300, 3), (300, 3)),  # full planes: nothing broadcast
    ((70,), (70,), (1, 70)),  # 1D x: one row
    ((70,), (1,), (1, 1)),
]


@pytest.mark.parametrize("x_shape,p_shape,view_rc", BROADCASTS)
def test_function_returns_gradients_in_the_broadcast_shape(x_shape, p_shape,
                                                           view_rc):
    """``_RQSFunction`` takes each parameter as the unexpanded view
    ``param_views`` gives and returns its gradient in that shape:
    ``param_grads`` sums the per-element planes over what was broadcast
    (a view that broadcasts nothing gets the planes themselves). Backed
    through the views, that is autograd's gradient of the plain version
    on the expanded parameters."""
    K = 4
    rng = np.random.default_rng(len(p_shape) + x_shape[-1])
    x = torch.from_numpy(_draw(rng, x_shape, 2.0))
    leaves = [torch.from_numpy(_draw(rng, (n,) + p_shape, 0.5))
              .requires_grad_() for n in (K, K, K + 1)]
    views = tk.param_views(x, *leaves)
    assert [tuple(v.shape[1:]) for v in views] == [view_rc] * 3
    x2, w2, h2, d2, _ = tk.kernel_views(x, *leaves, 2.0)
    assert all(v.stride(i + 1) == 0 for v in (w2, h2, d2)
               for i, n in enumerate(view_rc) if n == 1 and x2.shape[i] > 1)
    cty, ctl = (torch.from_numpy(_draw(rng, x2.shape)) for _ in range(2))
    planes = tk.rqs_bwd_plain(x2, w2.detach(), h2.detach(), d2.detach(),
                              2.0, cty, ctl, inverse=False)[1:]
    grads = tk.param_grads(planes, views)
    for g, v, p in zip(grads, views, planes):
        assert g.shape == v.shape
        if v.shape == p.shape:
            assert g.data_ptr() == p.data_ptr()  # no copy
    got = torch.autograd.grad(views, leaves, grads)
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    y, ld = tk.rqs_plain(x2, *tk.kernel_views(x, *ref, 2.0)[1:4], 2.0,
                         inverse=False)
    want = torch.autograd.grad((y * cty).sum() + (ld * ctl).sum(), ref)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _rel_close(a, b)


@pytest.mark.parametrize("x_shape,p_shape,tb,shared", [
    ((65536, 1), (1, 1), 3.0, True),  # the CDF of a dim-2 coupling
    ((65536, 4), (1, 4), 3.0, True),
    ((2048, 4), (1, 4), "per_column", True),
    ((70,), (1,), 3.0, False),  # one row of 70 columns: over the limit
    ((2048, 65), (1, 65), 3.0, False),
    ((2048, 4), (1, 4), "per_row", False),
    ((2048, 4), (2048, 4), 3.0, False),
    ((2048, 4), (2048, 1), 3.0, False),
])
def test_shared_path_is_taken_where_every_row_shares_the_parameters(
        x_shape, p_shape, tb, shared):
    """The backward's choice (``_shares_rows``) on the Function's views and
    on the expanded kernel views: the shared-parameter path where the
    parameters and the tail bound are the same for every row and there
    are at most ``SHARED_PARAM_MAX_COLS`` columns."""
    K = 8
    x = torch.zeros(x_shape)
    leaves = [torch.zeros((n,) + p_shape) for n in (K, K, K + 1)]
    if tb == "per_column":
        tb = torch.ones((1, x_shape[-1]))
    elif tb == "per_row":
        tb = torch.ones((x_shape[0], 1))
    x2, *expanded, tb2 = tk.kernel_views(x, *leaves, tb)
    views = tk.param_views(x, *leaves)
    assert tk._shares_rows(x2, views, tb2) is shared
    assert tk._shares_rows(x2, tuple(expanded), tb2) is shared
    assert tk._sums_in_kernel(x2, views, tb2) is shared


def test_function_gives_a_callers_expanded_view_one_gradient_per_row():
    """A caller may hand ``rqs_fwd`` parameters it expanded itself (full
    size, row stride 0). The kernel could sum over their rows, but the
    Function's backward must return one gradient per row for such a view
    (autograd's expand backward then sums them), so it does not take the
    shared-parameter path there."""
    K, rows, cols = 4, 6, 3
    x = torch.zeros(rows, cols)
    leaves = [torch.zeros(1, cols, n) for n in (K, K, K + 1)]
    views = tk.param_views(x, *(t.expand(rows, cols, t.shape[-1])
                                .movedim(-1, 0) for t in leaves))
    assert all(v.shape[1] == rows and v.stride(1) == 0 for v in views)
    assert tk._shares_rows(x, views, 1.0)
    assert not tk._sums_in_kernel(x, views, 1.0)


def test_shared_path_constants_match_the_cuda_source():
    """The Python side allocates kernel C's workspace from these; the CUDA
    source must sum the same slots under the same column limit."""
    import os

    src = open(os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc",
                            "rqs_bwd.cu")).read()
    assert f"constexpr int kSlots = {tk.SHARED_BWD_SLOTS};" in src
    assert (f"constexpr long long kRowsPerBlock = "
            f"{tk.SHARED_BWD_ROWS_PER_BLOCK};" in src)
    assert (f"constexpr int kMaxSharedCols = {tk.SHARED_PARAM_MAX_COLS};"
            in src)


def test_shared_wrapper_takes_only_cuda_tensors():
    x = torch.zeros(8, 1)
    w = torch.zeros(4, 1, 1)
    d = torch.zeros(5, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tk.rqs_bwd_shared(x, w, w, d, 1.0, x, x, inverse=False)
