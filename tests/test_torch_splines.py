"""The port's RQ splines (``nf_tpu_torch.ops``) against the JAX package.

Inputs are drawn with numpy from a seed and fed to both. The JAX side runs
its Pallas kernel in interpret mode (``splines_pallas.fused_unconstrained_rqs
(..., interpret=True)``) and its dense path; the port runs its plain
PyTorch versions (the CPU path of kernel A's wrapper and the dense
splines). Tolerances are the JAX package's own bar
(``tests/test_fused_head.py``): 1e-5 abs on outputs, 1e-4 abs on log-dets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import splines as jsp
from nf_tpu.ops import splines_pallas as jpl
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk

Y_TOL, LD_TOL = 1e-5, 1e-4
B, D, K = 300, 3, 4
LOGIT_SCALE = 0.5


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=0)


def _params(rng, lead, nd, bin_axis_last=True):
    """x ~ N(0, 2²) (some in the tails), logits ~ N(0, 0.5²). At N(0, 1)
    logits the spline's own float32 error against float64 reaches 1e-5 in
    the JAX package and in the port alike, which would leave no margin
    under the 1e-5 bar."""
    shape_k = lambda n: lead + (n,) if bin_axis_last else (n,) + lead
    x = (rng.standard_normal(lead) * 2.0).astype(np.float32)
    uw, uh, ud = ((rng.standard_normal(shape_k(n)) * LOGIT_SCALE)
                  .astype(np.float32) for n in (K, K, nd))
    return x, uw, uh, ud


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tb_kind", ["scalar", "per_element"])
def test_kernel_plain_matches_pallas_bin_minor(inverse, tb_kind):
    rng = np.random.default_rng(0)
    n = B * D
    x, uw, uh, ud = _params(rng, (n,), K + 1)
    tb = (2.5 if tb_kind == "scalar"
          else rng.uniform(1.0, 3.0, n).astype(np.float32))
    yj, lj = jpl.fused_unconstrained_rqs(
        jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud),
        jnp.asarray(tb), inverse=inverse, interpret=True)
    tb_t = tb if tb_kind == "scalar" else torch.from_numpy(tb)
    yt, lt = tk.fused_unconstrained_rqs(*_t(x, uw, uh, ud), tb_t,
                                        inverse=inverse)
    _close(yt, yj, Y_TOL)
    _close(lt, lj, LD_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_plain_matches_pallas_kmajor(inverse):
    rng = np.random.default_rng(1)
    x, uw, uh, ud = _params(rng, (D, B), K + 1, bin_axis_last=False)
    tb = np.asarray([1.5, 2.5, 3.0], np.float32)[:, None]
    yj, lj = jpl.fused_unconstrained_rqs_kmajor(
        jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud),
        jnp.asarray(tb), inverse=inverse, interpret=True)
    yt, lt = tk.fused_unconstrained_rqs_kmajor(
        *_t(x, uw, uh, ud), torch.from_numpy(tb), inverse=inverse)
    _close(yt, yj, Y_TOL)
    _close(lt, lj, LD_TOL)


_TAILS = {"linear": ("linear", K - 1), "circular": ("circular", K),
          "mixed": (["linear", "circular", "linear"], K + 1)}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", sorted(_TAILS))
@pytest.mark.parametrize("layout", ["bin_minor", "kmajor"])
def test_unconstrained_spline_matches_jax(layout, tails, inverse):
    """Both layouts, three tail kinds, both directions, against the JAX
    dense path and the JAX Pallas kernel (interpret mode)."""
    tails_arg, nd = _TAILS[tails]
    rng = np.random.default_rng(2)
    kmajor = layout == "kmajor"
    lead = (D, B) if kmajor else (B, D)
    x, uw, uh, ud = _params(rng, lead, nd, bin_axis_last=not kmajor)
    tb_np = np.asarray([1.5, 2.5, 3.0], np.float32)
    tb_np = tb_np[:, None] if kmajor else tb_np
    j_fn = (jsp.unconstrained_rational_quadratic_spline_kmajor if kmajor
            else jsp.unconstrained_rational_quadratic_spline)
    t_fn = (tsp.unconstrained_rational_quadratic_spline_kmajor if kmajor
            else tsp.unconstrained_rational_quadratic_spline)
    yt, lt = t_fn(*_t(x, uw, uh, ud), inverse=inverse, tails=tails_arg,
                  tail_bound=torch.from_numpy(tb_np))
    for use_pallas in (False, True):
        yj, lj = j_fn(jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh),
                      jnp.asarray(ud), inverse=inverse, tails=tails_arg,
                      tail_bound=jnp.asarray(tb_np), use_pallas=use_pallas)
        _close(yt, yj, Y_TOL)
        _close(lt, lj, LD_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_broadcast_parameters_match_jax(inverse):
    """The unconditional CDF's layout: (1, D, K) parameters broadcast over
    the batch, scalar tail bound."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, D)) * 2.0).astype(np.float32)
    uw, uh, ud = ((rng.standard_normal((1, D, n)) * LOGIT_SCALE)
                  .astype(np.float32) for n in (K, K, K - 1))
    yt, lt = tsp.unconstrained_rational_quadratic_spline(
        *_t(x, uw, uh, ud), inverse=inverse, tail_bound=3.0)
    full = lambda a: jnp.broadcast_to(jnp.asarray(a), (B,) + a.shape[1:])
    yj, lj = jsp.unconstrained_rational_quadratic_spline(
        jnp.asarray(x), full(uw), full(uh), full(ud), inverse=inverse,
        tail_bound=3.0, use_pallas=True)
    _close(yt, yj, Y_TOL)
    _close(lt, lj, LD_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_rational_quadratic_spline_matches_jax(inverse):
    rng = np.random.default_rng(4)
    x = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    uw, uh, ud = ((rng.standard_normal((B, D, n)) * LOGIT_SCALE)
                  .astype(np.float32) for n in (K, K, K + 1))
    yt, lt = tsp.rational_quadratic_spline(*_t(x, uw, uh, ud),
                                           inverse=inverse)
    yj, lj = jsp.rational_quadratic_spline(
        jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud),
        inverse=inverse)
    _close(yt, yj, Y_TOL)
    _close(lt, lj, LD_TOL)


def test_searchsorted_matches_jax():
    rng = np.random.default_rng(5)
    locs = np.sort(rng.uniform(-3, 3, (B, K + 1)), axis=-1).astype(np.float32)
    x = rng.uniform(-3.5, 3.5, B).astype(np.float32)
    got = tsp.searchsorted(torch.from_numpy(locs), torch.from_numpy(x))
    want = jsp.searchsorted(jnp.asarray(locs), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_spline_keeps_autograd_on_cpu():
    rng = np.random.default_rng(6)
    x, uw, uh, ud = (t.requires_grad_() for t in _t(
        *_params(rng, (B,), K + 1)))
    y, ld = tk.fused_unconstrained_rqs(x, uw, uh, ud, 2.0)
    (y.sin().sum() + ld.sum()).backward()
    for t in (x, uw, uh, ud):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def _gather(base, view, shape, strides):
    """What the kernel reads: element (i, j[, k]) of ``view`` at
    ``data_ptr + sum(index * stride)`` inside ``base``'s storage."""
    flat = base.reshape(-1)
    off = (view.data_ptr() - base.data_ptr()) // base.element_size()
    idx = np.zeros(shape, np.int64) + off
    for ax, st in enumerate(strides):
        ar = np.arange(shape[ax]).reshape(
            [-1 if a == ax else 1 for a in range(len(shape))])
        idx = idx + ar * st
    return flat[torch.from_numpy(idx)]


@pytest.mark.parametrize("layout", ["cdf_broadcast", "kmajor_transposed",
                                    "flat_1d"])
def test_kernel_views_address_every_layout(layout):
    """The strides handed to ``csrc/rqs_fwd.cu`` address the same
    parameters the plain version sees, without copying: stride-0 batch
    broadcast, a transposed input, and 1D inputs."""
    rng = np.random.default_rng(7)
    if layout == "cdf_broadcast":
        x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
        bases = [torch.from_numpy(rng.standard_normal((1, D, n))
                                  .astype(np.float32)) for n in (K, K, K + 1)]
        planes = [b.expand(B, D, b.shape[-1]).movedim(-1, 0) for b in bases]
        tb = torch.from_numpy(rng.uniform(1, 3, D).astype(np.float32))
    elif layout == "kmajor_transposed":
        xb = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
        x = xb.T
        bases = [torch.from_numpy(rng.standard_normal((n, D, B))
                                  .astype(np.float32)) for n in (K, K, K + 1)]
        planes = bases
        tb = torch.from_numpy(rng.uniform(1, 3, (D, 1)).astype(np.float32))
    else:
        x = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
        bases = [torch.from_numpy(rng.standard_normal((n, B))
                                  .astype(np.float32)) for n in (K, K, K + 1)]
        planes = bases
        tb = torch.from_numpy(rng.uniform(1, 3, B).astype(np.float32))
    x2, w3, h3, d3, tb2 = tk.kernel_views(x, *planes, tb)
    strides = tk.kernel_strides(x2, w3, h3, d3, tb2)
    rows, cols = x2.shape
    assert all(t.data_ptr() == b.data_ptr()
               for t, b in zip((w3, h3, d3), bases))  # no copies
    x_base = x if layout != "kmajor_transposed" else xb
    got_x = _gather(x_base, x2, (rows, cols), strides[0:2])
    torch.testing.assert_close(got_x, x.reshape(rows, cols), rtol=0, atol=0)
    for i, (v, b, p) in enumerate(zip((w3, h3, d3), bases, planes)):
        got = _gather(b, v, (p.shape[0], rows, cols),
                      strides[2 + 3 * i:5 + 3 * i])
        want = p.expand(p.shape[0], *x.shape).reshape(p.shape[0], rows, cols)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    got_tb = _gather(tb, tb2, (rows, cols), strides[11:13])
    torch.testing.assert_close(
        got_tb, torch.broadcast_to(tb, x.shape).reshape(rows, cols),
        rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    x = torch.zeros(8, device="meta")
    w = torch.zeros(K, 8, device="meta")
    d = torch.zeros(K + 1, 8, device="meta")
    with pytest.raises(ValueError, match="no spline kernel"):
        tk.rqs_fwd(x, w, w, d, 1.0, inverse=False)

