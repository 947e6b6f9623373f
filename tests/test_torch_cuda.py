"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA inputs, and the model on CUDA against the model
on the CPU.

This file imports neither JAX nor ``nf_tpu``, so it runs on a machine that
has only PyTorch and the CUDA toolkit, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips. Tolerances: 1e-5 abs on spline outputs
and 1e-4 abs on log-dets and per-element gradients (the JAX package's bar
for its kernels); 1e-4 relative to the largest magnitude on gradients
summed over the batch (kernel E's gW and gb), which the kernel sums in
another order than ``torch.matmul``, and on kernel D against kernel C
(the same gradients by other arithmetic); 1e-3 abs on a whole model's
log-density and 1e-3 relative on its gradients, where the card's matrix
products sum in another order than the CPU's.
"""

import copy

import numpy as np
import pytest
import torch

import nf_tpu_torch as nt
from nf_tpu_torch import ops as tops
from nf_tpu_torch.nets.made import MADE
from nf_tpu_torch.ops import spline_head_fused as tshf
from nf_tpu_torch.ops import splines_kernel as tk

pytestmark = pytest.mark.cuda

Y_TOL, LD_TOL, MODEL_TOL = 1e-5, 1e-4, 1e-3
G_TOL, SUM_TOL = 1e-4, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the port's kernels run "
                    "only there)")
    return torch.device("cuda")


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
def test_kernel_a_matches_plain(cuda, K, inverse):
    rng = np.random.default_rng(K)
    D, B = 3, 70001
    x = _normal(rng, (D, B), 2.0).to(cuda)
    w, h = (_normal(rng, (K, D, B), 0.5).to(cuda) for _ in range(2))
    d = _normal(rng, (K + 1, D, B), 0.5).to(cuda)
    tb = torch.tensor([[1.5], [2.5], [3.0]], device=cuda)
    y, ld = tk.rqs_fwd(x, w, h, d, tb, inverse=inverse)
    yp, lp = tk.rqs_plain(x, w, h, d, tb, inverse=inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)


def _tail_bound(kind, B, D, cuda):
    """A tail bound of ``kind`` for x (B, D) as the kernel takes it, and the
    same broadcast to x for the plain version: a float, a one-element
    tensor, one per feature (row stride 0, the shared path's), or one per
    row (the per-element path's)."""
    if kind == "float":
        return 3.0, 3.0
    if kind == "one_element_tensor":
        tb = torch.full((1, 1), 3.0, device=cuda)
    elif kind == "per_feature":
        tb = torch.linspace(1.5, 3.0, D, device=cuda)[None]
    else:
        tb = torch.linspace(1.5, 3.0, B, device=cuda)[:, None]
    return tb, tb.expand(B, D)


@pytest.mark.parametrize("params", ["per_feature", "per_row"])
@pytest.mark.parametrize("tb_kind", ["float", "one_element_tensor",
                                     "per_feature", "per_row"])
@pytest.mark.parametrize("B", [1, 255, 257, 65536 + 77])
@pytest.mark.parametrize("D", [1, 4, tk.SHARED_PARAM_MAX_COLS + 1])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_a_broadcast_parameters(cuda, inverse, D, B, tb_kind, params):
    """The unconditional CDF's call: (1, D, K) parameters, stride 0 over the
    batch (kernel A's shared-parameter path up to SHARED_PARAM_MAX_COLS
    columns when the tail bound is shared by the rows too), a transposed
    input;
    also (B, 1, K) parameters shared by the columns but not the rows, and
    a tail bound per row (both the per-element path)."""
    rng = np.random.default_rng(1)
    K = 8
    x = _normal(rng, (D, B), 2.0).to(cuda).T
    lead = (1, D) if params == "per_feature" else (B, 1)
    uw, uh = (_normal(rng, lead + (K,), 0.5).to(cuda) for _ in range(2))
    ud = _normal(rng, lead + (K + 1,), 0.5).to(cuda)
    tb, tb_plain = _tail_bound(tb_kind, B, D, cuda)
    y, ld = tk.fused_unconstrained_rqs(x, uw, uh, ud, tb, inverse=inverse)
    w, h, d = (t.expand(B, D, t.shape[-1]).movedim(-1, 0)
               for t in (uw, uh, ud))
    yp, lp = tk.rqs_plain(x, w, h, d, tb_plain, inverse=inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_a_shared_parameters_are_bitwise_plain(cuda, inverse, D):
    """At the CDF's shapes (x (65536, D), (1, D, K) parameters, tail bound
    3) the shared-parameter path computes each column's knots and
    derivatives once, with the same functions in the same order, and
    reads the selected bin's values by index where the per-element path
    sums masked values onto 0: the same bits as the plain version."""
    rng = np.random.default_rng(7)
    K, B = 8, 65536
    x = _normal(rng, (B, D), 2.0).to(cuda)
    uw, uh = (_normal(rng, (1, D, K), 0.5).to(cuda) for _ in range(2))
    ud = _normal(rng, (1, D, K + 1), 0.5).to(cuda)
    y, ld = tk.fused_unconstrained_rqs(x, uw, uh, ud, 3.0, inverse=inverse)
    w, h, d = (t.expand(B, D, t.shape[-1]).movedim(-1, 0)
               for t in (uw, uh, ud))
    yp, lp = tk.rqs_plain(x, w, h, d, 3.0, inverse=inverse)
    torch.cuda.synchronize()
    assert torch.equal(y, yp) and torch.equal(ld, lp)


def _on_grid(t, step):
    return torch.round(t / step) * step


def _rel_close(got, want, tol):
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got / scale, want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
def test_kernel_c_matches_plain(cuda, K, inverse):
    rng = np.random.default_rng(20 + K)
    D, B = 3, 70001
    x = _normal(rng, (D, B), 2.0).to(cuda)
    w, h = (_normal(rng, (K, D, B), 0.5).to(cuda) for _ in range(2))
    d = _normal(rng, (K + 1, D, B), 0.5).to(cuda)
    cty, ctl = (_normal(rng, (D, B)).to(cuda) for _ in range(2))
    tb = torch.tensor([[1.5], [2.5], [3.0]], device=cuda)
    got = tk.rqs_bwd(x, w, h, d, tb, cty, ctl, inverse=inverse)
    want = tk.rqs_bwd_plain(x, w, h, d, tb, cty, ctl, inverse=inverse)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, atol=G_TOL, rtol=0)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_a_gradients_run_kernel_c(cuda, inverse):
    """The unconditional CDF's call under autograd: stride-0 parameters,
    a transposed input, a cotangent of ``ld.sum()`` (stride 0). Kernel C
    runs once (its shared-parameter path, which sums over the batch
    itself), and the gradients match the plain version's autograd."""
    rng = np.random.default_rng(2)
    K, D, B = 8, 2, 5000
    x0 = _normal(rng, (D, B), 2.0).to(cuda)
    params = [_normal(rng, (1, D, n), 0.5).to(cuda) for n in (K, K, K + 1)]
    leaves = [t.clone().requires_grad_() for t in [x0] + params]
    tk.rqs_bwd.launches = 0
    y, ld = tk.fused_unconstrained_rqs(leaves[0].T, *leaves[1:], 3.0,
                                       inverse=inverse)
    (y.square().sum() + ld.sum()).backward()
    assert tk.rqs_bwd.launches == 1
    ref = [t.clone().requires_grad_() for t in [x0] + params]
    views = [t.expand(B, D, t.shape[-1]).movedim(-1, 0) for t in ref[1:]]
    yp, lp = tk.rqs_plain(ref[0].T, *views, 3.0, inverse=inverse)
    (yp.square().sum() + lp.sum()).backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(leaves[0].grad, ref[0].grad, atol=G_TOL,
                               rtol=0)
    for a, b in zip(leaves[1:], ref[1:]):
        _rel_close(a.grad, b.grad, SUM_TOL)


def _cdf_operands(rng, K, D, B, cuda, tb_kind="float"):
    """The unconditional CDF's backward operands: x (B, D) with rows 0 and
    1 at ±tb, (K, 1, D) and (K+1, 1, D) parameters, cotangents (B, D), a
    float or per-column tail bound."""
    tb = (3.0 if tb_kind == "float"
          else torch.linspace(1.5, 3.0, D, device=cuda)[None])
    x = _normal(rng, (B, D), 2.0).to(cuda)
    x[:2] = (torch.tensor([[1.0], [-1.0]], device=cuda) * tb)[:B]
    w, h = (_normal(rng, (K, 1, D), 0.5).to(cuda) for _ in range(2))
    d = _normal(rng, (K + 1, 1, D), 0.5).to(cuda)
    cty, ctl = (_normal(rng, (B, D)).to(cuda) for _ in range(2))
    return x, w, h, d, tb, cty, ctl


def _summed_planes(x, w, h, d, tb, cty, ctl, inverse):
    """``rqs_bwd_plain`` on the expanded parameters: gx, and the planes
    summed over the rows in float64."""
    B, D = x.shape
    planes = [t.expand(t.shape[0], B, D) for t in (w, h, d)]
    tb_p = tb.expand(B, D) if isinstance(tb, torch.Tensor) else tb
    px, *p = tk.rqs_bwd_plain(x, *planes, tb_p, cty, ctl, inverse=inverse)
    return px, [t.double().sum(1, keepdim=True) for t in p]


@pytest.mark.parametrize("tb_kind", ["float", "per_column"])
@pytest.mark.parametrize("B", [1, 255, 257, 65536, 65536 + 77])
@pytest.mark.parametrize("D", [1, 4, tk.SHARED_PARAM_MAX_COLS])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
def test_kernel_c_shared_path_matches_plain(cuda, K, inverse, D, B, tb_kind):
    """Kernel C's shared-parameter path: gx within 1e-4 abs of
    ``rqs_bwd_shared_plain``'s and of ``rqs_bwd_plain``'s, the row sums
    within 1e-4 of the largest magnitude of both the shared plain version
    and the float64 sums of ``rqs_bwd_plain``'s planes."""
    ops = _cdf_operands(np.random.default_rng(K + D + B), K, D, B, cuda,
                        tb_kind)
    got = tk.rqs_bwd_shared(*ops, inverse=inverse)
    want = tk.rqs_bwd_shared_plain(*ops, inverse=inverse)
    px, sums = _summed_planes(*ops, inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=G_TOL, rtol=0)
    torch.testing.assert_close(got[0], px, atol=G_TOL, rtol=0)
    for g, p, s in zip(got[1:], want[1:], sums):
        assert g.shape == s.shape
        _rel_close(g, p, SUM_TOL)
        _rel_close(g.double(), s, SUM_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_c_shared_path_is_deterministic(cuda, inverse):
    """The sums are taken in an order the launch fixes (no atomics): two
    runs give the same bits; gx is the per-element path's, bit for bit."""
    ops = _cdf_operands(np.random.default_rng(9), 8, 4, 65536 + 77, cuda)
    first = tk.rqs_bwd_shared(*ops, inverse=inverse)
    second = tk.rqs_bwd_shared(*ops, inverse=inverse)
    x, w, h, d = ops[:4]
    per_element = tk.rqs_bwd(x, *(t.expand(t.shape[0], *x.shape)
                                  for t in (w, h, d)), *ops[4:],
                             inverse=inverse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(first[0], per_element[0])


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_c_shared_path_with_no_rows_gives_zero_sums(cuda, inverse):
    """An empty batch, x (0, D): the shared path launches nothing and its
    sums are zeros, both from ``rqs_bwd_shared`` and as the CDF's
    backward through autograd. The allocator's free blocks of the sums'
    size are filled with NaN first, so sums left unwritten would show."""

    def poison():  # 64 freed 512-byte blocks of NaN
        [torch.full((128,), float("nan"), device=cuda) for _ in range(64)]

    K, D = 8, 4
    ops = _cdf_operands(np.random.default_rng(14), K, D, 0, cuda)
    poison()
    tk.rqs_bwd.launches = 0
    gx, *sums = tk.rqs_bwd_shared(*ops, inverse=inverse)
    assert gx.shape == (0, D)
    for g, n in zip(sums, (K, K, K + 1)):
        assert g.shape == (n, 1, D)
        assert torch.equal(g, torch.zeros_like(g))
    assert tk.rqs_bwd.launches == 0
    x = ops[0].clone().requires_grad_()
    leaves = [_normal(np.random.default_rng(15), (1, D, n), 0.5)
              .to(cuda).requires_grad_() for n in (K, K, K - 1)]
    y, ld = tops.unconstrained_rational_quadratic_spline(
        x, *leaves, inverse=inverse, tails="linear", tail_bound=3.0)
    poison()
    grads = torch.autograd.grad((y, ld), leaves, (ops[5], ops[6]))
    for g, leaf in zip(grads, leaves):
        assert g.shape == leaf.shape
        assert torch.equal(g, torch.zeros_like(g))


def _device_kernels(fn):
    """The kernels (and memsets and copies) ``fn`` runs on the card, by
    name, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if str(e.device_type).endswith("CUDA")]


@pytest.mark.parametrize("inverse", [False, True])
def test_cdf_backward_launches_at_most_two_kernels(cuda, inverse):
    """The unconditional CDF's backward as autograd runs it (x (65536, 1),
    K = 8, linear tails, tail bound 3): kernel C's shared path, its two
    launches and nothing else, where it was kernel C plus a reduction per
    parameter. gx within 1e-4 abs of ``rqs_bwd_plain``'s, the parameter
    gradients within 1e-4 of the largest magnitude of the float64 sums of
    its planes (the derivatives' through the linear padding)."""
    rng = np.random.default_rng(11)
    K, B = 8, 65536
    x = _normal(rng, (B, 1), 1.5).to(cuda).requires_grad_()
    uw, uh = (_normal(rng, (1, 1, K), 0.5).to(cuda).requires_grad_()
              for _ in range(2))
    ud = _normal(rng, (1, 1, K - 1), 0.5).to(cuda).requires_grad_()
    cty, ctl = (_normal(rng, (B, 1)).to(cuda) for _ in range(2))
    leaves = (x, uw, uh, ud)
    y, ld = tops.unconstrained_rational_quadratic_spline(
        x, uw, uh, ud, inverse=inverse, tails="linear", tail_bound=3.0)
    grads = []
    names = _device_kernels(lambda: grads.extend(torch.autograd.grad(
        (y, ld), leaves, (cty, ctl), retain_graph=True)))
    assert 1 <= len(names) <= 2, names
    d_pad = tops.splines.pad_derivatives(ud.detach(), "linear", 1e-3,
                                         axis=-1)
    px, sums = _summed_planes(x.detach(), *(t.detach().movedim(-1, 0)
                                            for t in (uw, uh, d_pad)),
                              3.0, cty, ctl, inverse)
    torch.testing.assert_close(grads[0], px, atol=G_TOL, rtol=0)
    sums[2] = sums[2][1:-1]  # the linear padding's edges are constants
    for g, p in zip(grads[1:], sums):
        assert g.shape == p.movedim(0, -1).shape
        _rel_close(g.double(), p.movedim(0, -1), SUM_TOL)


@pytest.mark.parametrize("case", ["65_columns", "per_row_tail_bound",
                                  "per_row_parameters"])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_c_per_element_path_sums_what_was_broadcast(cuda, inverse,
                                                           case):
    """Where the shared path does not apply (more than
    ``SHARED_PARAM_MAX_COLS`` columns, a tail bound or parameters that vary
    down the rows), the backward runs kernel C's per-element path once and
    sums its planes to each parameter's shape: gx within 1e-4 abs of
    ``rqs_bwd_plain``'s, the parameter gradients within 1e-4 of the largest
    magnitude of the float64 sums of its planes."""
    rng = np.random.default_rng(12)
    K, B = 8, 4099
    D = tk.SHARED_PARAM_MAX_COLS + 1 if case == "65_columns" else 4
    lead = (B, 1) if case == "per_row_parameters" else (1, D)
    x = _normal(rng, (B, D), 2.0).to(cuda).requires_grad_()
    params = [_normal(rng, lead + (n,), 0.5).to(cuda).requires_grad_()
              for n in (K, K, K + 1)]
    tb = (torch.linspace(1.5, 3.0, B, device=cuda)[:, None]
          if case == "per_row_tail_bound" else 3.0)
    cty, ctl = (_normal(rng, (B, D)).to(cuda) for _ in range(2))
    y, ld = tk.fused_unconstrained_rqs(x, *params, tb, inverse=inverse)
    tk.rqs_bwd.launches = 0
    grads = torch.autograd.grad((y, ld), [x] + params, (cty, ctl))
    assert tk.rqs_bwd.launches == 1
    small = [p.detach().movedim(-1, 0) for p in params]
    with pytest.raises(ValueError, match="shared-parameter path"):
        tk.rqs_bwd_shared(x.detach(), *small, tb, cty, ctl, inverse=inverse)
    planes = [t.expand(t.shape[0], B, D) for t in small]
    tb_p = tb.expand(B, D) if isinstance(tb, torch.Tensor) else tb
    px, *p = tk.rqs_bwd_plain(x.detach(), *planes, tb_p, cty, ctl,
                              inverse=inverse)
    torch.testing.assert_close(grads[0], px, atol=G_TOL, rtol=0)
    for g, q, par in zip(grads[1:], p, params):
        want = q.double().movedim(0, -1).sum_to_size(par.shape)
        assert g.shape == par.shape
        _rel_close(g.double(), want, SUM_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_c_gradients_through_a_callers_expanded_view(cuda, inverse):
    """Parameters the caller expanded itself (full size, row stride 0)
    reach ``rqs_fwd`` as they are: the backward gives that view one
    gradient per row (kernel C's per-element path), and autograd's expand
    backward sums them into the (1, D, K) leaves."""
    rng = np.random.default_rng(13)
    K, D, B = 8, 2, 5000
    x = _normal(rng, (B, D), 2.0).to(cuda)
    leaves = [_normal(rng, (1, D, n), 0.5).to(cuda).requires_grad_()
              for n in (K, K, K + 1)]
    cty, ctl = (_normal(rng, (B, D)).to(cuda) for _ in range(2))
    views = [t.expand(B, D, t.shape[-1]).movedim(-1, 0) for t in leaves]
    y, ld = tk.rqs_fwd(x, *views, 3.0, inverse=inverse)
    grads = torch.autograd.grad((y, ld), leaves, (cty, ctl))
    px, sums = _summed_planes(x, *(t.detach().movedim(-1, 0)
                                   for t in leaves), 3.0, cty, ctl, inverse)
    for g, p in zip(grads, sums):
        _rel_close(g.double(), p.movedim(0, -1), SUM_TOL)


def _d_operands(rng, K, cuda, B=70001):
    """The circular NSF's layout: x (2, B) with ties at ±tb in its first
    columns, full parameter planes, a per-feature tail bound (2, 1)."""
    x = _normal(rng, (2, B), 2.0).to(cuda)
    tb = torch.tensor([[np.pi], [3.0]], device=cuda)
    x[:, :2] = torch.cat([tb, -tb], dim=1)
    w, h = (_normal(rng, (K, 2, B), 0.5).to(cuda) for _ in range(2))
    d = _normal(rng, (K + 1, 2, B), 0.5).to(cuda)
    cty, ctl = (_normal(rng, (2, B)).to(cuda) for _ in range(2))
    return x, w, h, d, tb, cty, ctl


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
def test_kernel_d_matches_plain_and_kernel_c(cuda, K, inverse):
    """Kernel D against its plain version (1e-4 abs per element); against
    kernel C (the same gradients by other arithmetic) within 1e-4 of the
    largest magnitude away from the ties, and at x = ±tb half of C's
    x-gradient, as in JAX."""
    ops = _d_operands(np.random.default_rng(40 + K), K, cuda)
    got = tk.rqs_bwd_autodiff(*ops, inverse=inverse)
    want = tk.rqs_vjp_plain(*ops, inverse=inverse)
    c = tk.rqs_bwd(*ops, inverse=inverse)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, atol=G_TOL, rtol=0)
    for g, p in zip(got, c):
        _rel_close(g[..., 2:], p[..., 2:], G_TOL)
    torch.testing.assert_close(got[0][:, :2], 0.5 * c[0][:, :2], atol=1e-5,
                               rtol=1e-5)


def test_kernel_d_is_deterministic(cuda):
    ops = _d_operands(np.random.default_rng(5), 10, cuda)
    first = tk.rqs_bwd_autodiff(*ops, inverse=True)
    second = tk.rqs_bwd_autodiff(*ops, inverse=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# --- the per-element path (csrc/rqs_per_element.cuh) and D's ring ----------
# (csrc/rqs_ring.cuh)

RING_DTYPES = [torch.float32, torch.bfloat16]
_PER_ELEMENT = {"A": tk.rqs_fwd, "C": tk.rqs_bwd, "D": tk.rqs_bwd_autodiff}


def _materialised(rng, K, D, B, dtype, cuda):
    """x (B, D), (1, D, K)-shaped parameters (the CDF's) and the same
    parameters as full contiguous (K, B, D) planes, a float tail bound,
    cotangents (B, D): the shared paths take the former, the per-element
    path the latter."""
    x = _normal(rng, (B, D), 2.0).to(cuda, dtype)
    params = [_normal(rng, (1, D, n), 0.5).to(cuda, dtype)
              for n in (K, K, K + 1)]
    full = [t.expand(B, D, t.shape[-1]).movedim(-1, 0).contiguous()
            for t in params]
    cty, ctl = (_normal(rng, (B, D)).to(cuda, dtype) for _ in range(2))
    return x, params, full, cty, ctl


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_kernel_a_per_element_is_bitwise_its_shared_path(cuda, dtype, K,
                                                         inverse):
    """The per-element path on full planes materialised from (1, D, K)
    parameters gives the shared path's y and ld bit for bit (the shared
    path is bitwise the plain version): the schedule changes where
    operands come from, not the math."""
    x, params, full, _, _ = _materialised(np.random.default_rng(K), K, 4,
                                          65536 + 77, dtype, cuda)
    shared = tk.fused_unconstrained_rqs(x, *params, 3.0, inverse=inverse)
    per_element = tk.rqs_fwd(x, *full, 3.0, inverse=inverse)
    torch.cuda.synchronize()
    for a, b in zip(per_element, shared):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_kernel_c_gx_is_bitwise_its_shared_path(cuda, dtype, K, inverse):
    """Kernel C's per-element gx on materialised planes is its shared
    path's gx bit for bit: both run rqs_bwd_map on the same values."""
    x, params, full, cty, ctl = _materialised(
        np.random.default_rng(10 + K), K, 4, 65536 + 77, dtype, cuda)
    shared = tk.rqs_bwd_shared(x, *(t.movedim(-1, 0) for t in params), 3.0,
                               cty, ctl, inverse=inverse)
    per_element = tk.rqs_bwd(x, *full, 3.0, cty, ctl, inverse=inverse)
    torch.cuda.synchronize()
    assert torch.equal(per_element[0], shared[0])


def _offset_copy(t):
    """``t``'s values in a fresh buffer one element in: the same operand
    off 16 bytes (the by-lanes route; in bfloat16 off 4 bytes too)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kernel", ["A", "C", "D"])
@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_per_element_routes_agree_to_the_bit(cuda, dtype, kernel, inverse):
    """The same operands through 16-byte aligned views and through views
    one element into their buffers give the same bits, for A, C and D, and
    two calls are bitwise equal. At this size D takes its ring (its
    one-tile form would need a second wave), and ``ring_routes`` sends the
    two views down different routes (16-byte copies, each lane its
    element)."""
    rng = np.random.default_rng(30)
    K, D, B = 8, 3, 65536 + 64
    x = _normal(rng, (D, B), 2.0).to(cuda, dtype)
    planes = [_normal(rng, (n, D, B), 0.5).to(cuda, dtype)
              for n in (K, K, K + 1)]
    tb = torch.tensor([[1.5], [2.5], [3.0]], device=cuda, dtype=dtype)
    cts = [_normal(rng, (D, B)).to(cuda, dtype) for _ in range(2)]
    aligned = [x, *planes, tb] + (cts if kernel != "A" else [])
    moved = [_offset_copy(t) for t in aligned]
    fn = _PER_ELEMENT[kernel]
    got = [fn(*ops[:5], *ops[5:], inverse=inverse)
           for ops in (aligned, moved, aligned)]
    torch.cuda.synchronize()
    for a, b, c in zip(*got):
        assert torch.equal(a, b) and torch.equal(a, c)
    if kernel == "D":
        routes = [tk.ring_routes(ops[0], ops[1:4], ops[4], tuple(ops[5:]))
                  for ops in (aligned, moved)]
        assert routes[0] & 0b1111 == 0b1111 and routes[1] == 0


def _ring_operands(case, rng, cuda, dtype, K=8):
    """(x, w, h, d, tb, cty, ctl, small): kernel D's operands in a layout
    the ring copies by lanes, at ~100k elements (past the one wave of D's
    one-tile kernel at K 8), and ``small(t)``: an operand or output cut to
    its first rows or columns, few enough for the one-tile kernel (a
    one-column operand keeps its column)."""
    if case == "bin_minor":  # (B, 1, K) parameters, x (B, 1): cols 1
        B = 100000
        x = _normal(rng, (B, 1), 2.0).to(cuda, dtype)
        tb = torch.linspace(1.5, 3.0, B, device=cuda).to(dtype)[:, None]
        cut = (slice(None, 1000), slice(None))
    elif case == "broadcast_over_columns":  # (B, 1, K) over x (B, 4)
        B = 25000
        x = _normal(rng, (B, 4), 2.0).to(cuda, dtype)
        tb = 3.0
        cut = (slice(None, 250), slice(None))
    else:  # K-major (K, D, B) planes with D * B odd, x = inputs.T
        D, B = 3, 33333
        x = _normal(rng, (B, D), 2.0).to(cuda, dtype).T
        tb = torch.tensor([[1.5], [2.5], [3.0]], device=cuda, dtype=dtype)
        cut = (slice(None), slice(None, 333))
    if case == "kmajor_odd_bin_stride":
        planes = [_normal(rng, (n, D, B), 0.5).to(cuda, dtype)
                  for n in (K, K, K + 1)]
    else:  # bin-minor, as a coupling without a bin-major head hands them
        planes = [_normal(rng, (B, 1, n), 0.5).to(cuda, dtype).movedim(-1, 0)
                  for n in (K, K, K + 1)]
    cty, ctl = (_normal(rng, tuple(x.shape)).to(cuda, dtype)
                for _ in range(2))

    def small(t):
        if not isinstance(t, torch.Tensor):
            return t
        return t[..., cut[0], slice(None) if t.shape[-1] == 1 else cut[1]]
    return x, *planes, tb, cty, ctl, small


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("case", ["bin_minor", "broadcast_over_columns",
                                  "kmajor_odd_bin_stride"])
@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_kernel_d_ring_by_lanes_is_bitwise_its_one_tile_form(
        cuda, dtype, case, inverse):
    """Kernel D's ring on operands that it copies by lanes, at a size that
    takes it: bin-minor (B, 1, K) parameters (bin stride 1, column stride
    K, one column), (B, 1, K) parameters over x (B, 4) (column stride 0)
    and K-major planes with an odd bin stride (D * B odd: in bfloat16 the
    odd planes' elements in the other half of their words). Its outputs
    are bit for bit those of the same operands cut to a size that takes
    the one-tile kernel, and ``ring_routes`` copies none of the parameter
    planes by 16 bytes."""
    x, w, h, d, tb, cty, ctl, small = _ring_operands(
        case, np.random.default_rng(40), cuda, dtype)
    assert tk.ring_routes(x, (w, h, d), tb, (cty, ctl)) & 0b1110 == 0
    big = tk.rqs_bwd_autodiff(x, w, h, d, tb, cty, ctl, inverse=inverse)
    cut = tk.rqs_bwd_autodiff(*(small(t) for t in (x, w, h, d, tb, cty,
                                                   ctl)), inverse=inverse)
    torch.cuda.synchronize()
    for a, b in zip(big, cut):
        assert torch.equal(small(a), b)


def _edge_operands(case, rng, cuda, K=8):
    """(x, w, h, d, tb, plain planes, plain tb) for the route's edges; the
    kernels take the first five, the plain versions the planes broadcast
    to x."""
    tb = 3.0
    if case.startswith("cols_"):
        cols = int(case[5:])
        rows = 3 if cols < 1000 else 2
        x = _normal(rng, (rows, cols), 2.0).to(cuda)
        if cols == 1:  # bin-minor (B, 1, K), as a coupling without a head
            rows = 301
            x = _normal(rng, (rows, 1), 2.0).to(cuda)
            bm = [_normal(rng, (rows, 1, n), 0.5).to(cuda)
                  for n in (K, K, K + 1)]
            planes = [t.movedim(-1, 0) for t in bm]
        else:
            planes = [_normal(rng, (n, rows, cols), 0.5).to(cuda)
                      for n in (K, K, K + 1)]
        return (x, *planes, tb, planes, tb)
    if case == "kmajor_transposed_x":
        inputs = _normal(rng, (65536 + 5, 2), 2.0).to(cuda)
        planes = [_normal(rng, (n, 2, 65536 + 5), 0.5).to(cuda)
                  for n in (K, K, K + 1)]
        tb = torch.tensor([[np.pi], [3.0]], device=cuda)
        return (inputs.T, *planes, tb, planes, tb)
    if case == "broadcast_over_columns":  # (B, 1, K) over x (B, 4)
        x = _normal(rng, (1000, 4), 2.0).to(cuda)
        bm = [_normal(rng, (1000, 1, n), 0.5).to(cuda) for n in (K, K, K + 1)]
        planes = [t.movedim(-1, 0) for t in bm]
        return (x, *planes, tb, [p.expand(-1, 1000, 4) for p in planes], tb)
    # a tail bound per row
    x = _normal(rng, (999, 5), 2.0).to(cuda)
    planes = [_normal(rng, (n, 999, 5), 0.5).to(cuda) for n in (K, K, K + 1)]
    tb = torch.linspace(1.5, 3.0, 999, device=cuda)[:, None]
    return (x, *planes, tb, planes, tb.expand(999, 5))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("case", ["cols_1", "cols_31", "cols_33",
                                  "cols_257", "cols_65613",
                                  "kmajor_transposed_x",
                                  "broadcast_over_columns",
                                  "per_row_tail_bound"])
def test_per_element_route_edges_match_plain(cuda, case, inverse):
    """Ragged tiles (cols 31, 33, 257, 65613; one column with bin-minor
    (B, 1, K) parameters), K-major x as ``inputs.T``, (B, 1, K) parameters
    over x (B, 4) (column stride 0) and a tail bound per row: A against
    ``rqs_plain`` (1e-5 / 1e-4), C and D against their plain versions
    (1e-4 per element)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    x, w, h, d, tb, planes, tb_p = _edge_operands(case, rng, cuda)
    full = [p.expand(p.shape[0], *x.shape) for p in planes]
    y, ld = tk.rqs_fwd(x, w, h, d, tb, inverse=inverse)
    yp, lp = tk.rqs_plain(x, *full, tb_p, inverse=inverse)
    cty, ctl = (_normal(rng, tuple(x.shape)).to(cuda) for _ in range(2))
    gc = tk.rqs_bwd(x, *full, tb, cty, ctl, inverse=inverse)
    gcp = tk.rqs_bwd_plain(x, *full, tb_p, cty, ctl, inverse=inverse)
    gd = tk.rqs_bwd_autodiff(x, *full, tb, cty, ctl, inverse=inverse)
    gdp = tk.rqs_vjp_plain(x, *full, tb_p, cty, ctl, inverse=inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)
    for got, want in ((gc, gcp), (gd, gdp)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=G_TOL, rtol=0)


@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_per_element_kernels_are_deterministic(cuda, dtype):
    """A, C and D at a shape where every warp walks several tiles of the
    ring: two calls give the same bits."""
    rng = np.random.default_rng(8)
    K, rows, cols = 10, 1536, 256
    x = _normal(rng, (rows, cols), 2.0).to(cuda, dtype)
    planes = [_normal(rng, (n, rows, cols), 0.5).to(cuda, dtype)
              for n in (K, K, K + 1)]
    cts = [_normal(rng, (rows, cols)).to(cuda, dtype) for _ in range(2)]
    for fn, extra in ((tk.rqs_fwd, []), (tk.rqs_bwd, cts),
                      (tk.rqs_bwd_autodiff, cts)):
        first = fn(x, *planes, 3.0, *extra, inverse=True)
        second = fn(x, *planes, 3.0, *extra, inverse=True)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["analytic", "autodiff"])
def test_reverse_kld_step_on_cuda_matches_cpu(cuda, mode):
    """One ``make_reverse_kld_step`` with SGD on the circular NSF (K = 2,
    hidden 16, 4 bins), card against CPU on the same base draws, under
    each backward mode: the two layers' inverse (two MADE passes each)
    launch kernel A 4 times, and kernel C or D 4 times in the backward."""
    cpu_model = nt.build_circular_nsf(K=2, hidden=16, num_bins=4,
                                      device="cpu")
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for p in cpu_model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.2))
    gpu_model = nt.build_circular_nsf(K=2, hidden=16, num_bins=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    z0 = _normal(rng, (3000, 2))
    z0[:, 0] = torch.rand(3000, generator=torch.Generator().manual_seed(
        0)) * 2 * np.pi - np.pi
    losses = []
    tk.set_pallas_bwd_kernel(mode)
    try:
        for model in (cpu_model, gpu_model):
            model.p = _GaussVonMises()
            dev = next(model.parameters()).device
            model.q0.sample = lambda n, generator=None, z=z0.to(dev): z
            opt = torch.optim.SGD(model.parameters(), lr=0.05)
            step = nt.make_reverse_kld_step(opt, num_samples=3000)
            for c in (tk.rqs_fwd, tk.rqs_bwd, tk.rqs_bwd_autodiff):
                c.launches = 0
            losses.append(step(nt.init_train_state(model, opt), None))
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    launched = (tk.rqs_bwd.launches, tk.rqs_bwd_autodiff.launches)
    assert tk.rqs_fwd.launches == 4
    assert launched == ((4, 0) if mode == "analytic" else (0, 4))
    torch.cuda.synchronize()
    torch.testing.assert_close(losses[1].cpu(), losses[0], atol=MODEL_TOL,
                               rtol=0)
    for p, q in zip(gpu_model.parameters(), cpu_model.parameters()):
        _rel_close(p.grad.cpu(), q.grad, MODEL_TOL)


class _GaussVonMises:
    def log_prob(self, x):
        phi, z = x[..., 0], x[..., 1]
        return 2.0 * torch.cos(phi) - 0.5 * (z - 0.8 * torch.sin(phi)) ** 2


def test_kernel_a_refuses_unbuilt_bin_counts(cuda):
    x = torch.zeros(16, device=cuda)
    w = torch.zeros(5, 16, device=cuda)
    d = torch.zeros(6, 16, device=cuda)
    with pytest.raises(ValueError, match="built for K"):
        tk.rqs_fwd(x, w, w, d, 1.0, inverse=False)


# kernels B's and E's shapes: (D, H, B, strided), where strided takes x_t
# and cty as transposed (B, D) views, the layout a coupling passes. The
# first is the parity layout of the other kernels, the second the path's
# (build_nsf's couplings); the rest are the edges of the tilings: H below,
# at and above the 128-column W_eff tile and not a multiple of 8 or 16, B
# of one column and odd counts either side of a block's 256 columns, and,
# at K = 10 with circular tails and D = 4, the most head rows (M = 120).
# The last two are build_conditional_nsf's couplings: H = 64, half of
# the first W_eff tile, at the path's B and at a ragged one.
E_SHAPES = [(4, 128, 65536 + 77, False), (1, 128, 65536, True),
            (1, 16, 1, False), (4, 100, 255, True), (1, 512, 257, False),
            (4, 512, 65536 + 77, True), (1, 64, 65536, True),
            (1, 64, 65536 + 77, True)]
E_COMBOS = [(K, tails, inverse) for K in tk.SUPPORTED_BINS
            for tails in ("linear", "circular") for inverse in (False, True)]


def _b_operands(cuda, K, tails, shape, draw, offset=0):
    """Kernel B's operands at ``shape`` (those of :func:`_e_operands`
    without the cotangents); h_t begins ``offset`` floats into its
    buffer."""
    x_t, h_t, w, b, tb, _, _ = _e_operands(cuda, K, tails, shape, draw)
    if offset:
        buf = torch.empty(h_t.numel() + offset, device=cuda)
        shifted = buf[offset:].view(h_t.shape)
        shifted.copy_(h_t)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
        h_t = shifted
    return x_t, h_t, w, b, tb


def _b_close(got, want, y_tol=Y_TOL, ld_tol=LD_TOL):
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=y_tol, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=ld_tol, rtol=0)


@pytest.mark.parametrize("K, tails, inverse, shape, draw", [
    (K, tails, inverse, shape, draw) for shape in E_SHAPES
    for K, tails, inverse in E_COMBOS for draw in ("normal", "grid")])
def test_kernel_b_matches_plain(cuda, K, tails, inverse, shape, draw):
    """Kernel B against head_rqs_plain (torch.matmul's head product) at
    the bars of the JAX package's kernels; the grid draws make the head
    product exact in any order."""
    x_t, h_t, w, b, tb = _b_operands(cuda, K, tails, shape, draw)
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    _b_close(tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw),
             tshf.head_rqs_plain(x_t, h_t, w, b, tb, **kw))


@pytest.mark.parametrize("K, tails, inverse, shape", [
    (K, tails, inverse, shape) for shape in E_SHAPES
    for K, tails, inverse in E_COMBOS])
def test_kernel_b_is_bitwise_plain_summed_in_its_order(cuda, K, tails,
                                                       inverse, shape):
    """Under normal draws kernel B's y and ld are the bits of the plain
    version whose head product is summed in B's order (j ascending, one
    fmaf per step, then the bias): kernel E's recompute repeats that
    order, so this is what keeps E's parameters B's."""
    x_t, h_t, w, b, tb = _b_operands(cuda, K, tails, shape, "normal")
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    _b_close(tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw),
             tshf.head_rqs_plain_in_kernel_order(x_t, h_t, w, b, tb, **kw),
             0.0, 0.0)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_b_takes_h_t_off_16_bytes(cuda, offset):
    """A contiguous h_t whose storage begins ``offset`` floats into its
    buffer (the wrapper does not copy it), at the path's shape and at an
    odd B."""
    for shape in (E_SHAPES[1], (1, 128, 4097, True)):
        x_t, h_t, w, b, tb = _b_operands(cuda, 8, "linear", shape, "normal",
                                         offset)
        kw = dict(num_bins=8, tails="linear", inverse=False)
        _b_close(tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw),
                 tshf.head_rqs_plain_in_kernel_order(x_t, h_t, w, b, tb,
                                                     **kw), 0.0, 0.0)
# The cases where gx under normal draws differs from head_rqs_bwd_plain's
# by more than G_TOL on the H100 (up to 9e-4; at H = 64, K = 4, linear
# tails up to 4.6e-4): the plain version's
# torch.matmul sums the head product in another order than the kernel
# (kernel B's, j ascending), and the spline's derivatives carry that
# rounding of the parameters into gx; against float64 both are further
# off. There the kernel is held against the plain version summed in its
# own order (test_kernel_e_matches_plain_summed_in_its_order) and, with the
# head on binary grids where the product is exact, against
# head_rqs_bwd_plain itself.
E_ORDER_CASES = ([(4, t, i, E_SHAPES[1]) for t in ("linear", "circular")
                  for i in (False, True)]
                 + [(8, "circular", i, E_SHAPES[4]) for i in (False, True)]
                 + [(10, "linear", i, E_SHAPES[4]) for i in (False, True)]
                 + [(10, "circular", True, E_SHAPES[4])]
                 + [(4, "linear", i, s) for s in E_SHAPES[6:8]
                    for i in (False, True)])


def _e_operands(cuda, K, tails, shape, draw):
    """Kernel E's operands at ``shape``; with ``draw == "grid"`` the head's
    weights and activations lie on binary grids (multiples of 2^-12 and
    2^-3), so that W_eff @ h_t is exact in float32 whatever the order of
    summation."""
    D, H, B, strided = shape
    rng = np.random.default_rng(30 + K)
    m = (2 * K + (K - 1 if tails == "linear" else K)) * D
    x_t, cty = (_normal(rng, (B, D), s).to(cuda).T if strided
                else _normal(rng, (D, B), s).to(cuda) for s in (2.0, 1.0))
    h_t = _normal(rng, (H, B))
    w = _normal(rng, (m, H), 0.3 / np.sqrt(H))
    if draw == "grid":
        h_t, w = _on_grid(h_t, 2.0 ** -3), _on_grid(w, 2.0 ** -12)
    b = _normal(rng, (m,), 0.1).to(cuda)
    ctl = _normal(rng, (D, B)).to(cuda)
    tb = torch.tensor([1.5, 2.0, 2.5, 3.0][:D], device=cuda)
    return x_t, h_t.to(cuda), w.to(cuda), b, tb, cty, ctl


def _e_close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=G_TOL, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=G_TOL, rtol=0)
    _rel_close(got[2], want[2], SUM_TOL)
    _rel_close(got[3], want[3], SUM_TOL)


@pytest.mark.parametrize("K, tails, inverse, shape, draw", [
    (K, tails, inverse, shape, draw) for shape in E_SHAPES
    for K, tails, inverse in E_COMBOS for draw in ("normal", "grid")
    if draw == "grid" or (K, tails, inverse, shape) not in E_ORDER_CASES])
def test_kernel_e_matches_plain(cuda, K, tails, inverse, shape, draw):
    ops = _e_operands(cuda, K, tails, shape, draw)
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    _e_close(tshf.fused_head_rqs_bwd(*ops, **kw),
             tshf.head_rqs_bwd_plain(*ops, **kw))


@pytest.mark.parametrize("K, tails, inverse, shape", E_ORDER_CASES)
def test_kernel_e_matches_plain_summed_in_its_order(cuda, K, tails, inverse,
                                                     shape):
    """Normal draws where head_rqs_bwd_plain's order of summing the head
    product moves gx past G_TOL: against the plain version summed in the
    kernel's order, the kernel holds the same bars."""
    ops = _e_operands(cuda, K, tails, shape, "normal")
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    _e_close(tshf.fused_head_rqs_bwd(*ops, **kw),
             tshf.head_rqs_bwd_plain_in_kernel_order(*ops, **kw))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_e_takes_h_t_off_16_bytes(cuda, offset):
    """A contiguous h_t whose storage begins ``offset`` floats into its
    buffer (the wrapper does not copy it) at B % 4 == 0: kernel E stages it
    with 4-byte copies, not 16-byte ones, and matches its plain version."""
    x_t, h_t, w, b, tb, cty, ctl = _e_operands(cuda, 8, "linear",
                                               (1, 128, 65536, True),
                                               "normal")
    buf = torch.empty(h_t.numel() + offset, device=cuda)
    shifted = buf[offset:].view(h_t.shape)
    shifted.copy_(h_t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    ops = (x_t, shifted, w, b, tb, cty, ctl)
    kw = dict(num_bins=8, tails="linear", inverse=False)
    _e_close(tshf.fused_head_rqs_bwd(*ops, **kw),
             tshf.head_rqs_bwd_plain(*ops, **kw))


def test_kernel_backwards_are_once_differentiable(cuda):
    """Kernels C, D and E have no backward of their own: a second
    derivative through them raises instead of coming out wrong."""
    K, B = 4, 64
    x = torch.randn(1, B, device=cuda, requires_grad=True)
    w = torch.zeros(K, 1, B, device=cuda, requires_grad=True)
    d = torch.zeros(K + 1, 1, B, device=cuda)
    for mode in ("analytic", "autodiff"):
        tk.set_pallas_bwd_kernel(mode)
        try:
            y, _ = tk.rqs_fwd(x, w, w, d, 1.0, inverse=False)
        finally:
            tk.set_pallas_bwd_kernel("analytic")
        (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            g.sum().backward()
    m = 3 * K - 1
    h_t = torch.randn(16, B, device=cuda, requires_grad=True)
    y, _ = tshf.fused_head_rqs(x, h_t, torch.zeros(m, 16, device=cuda), None,
                               num_bins=K)
    (g,) = torch.autograd.grad(y.square().sum(), h_t, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


@pytest.mark.parametrize("D", [1, 4])
def test_kernel_e_is_deterministic(cuda, D):
    """gW and gb are reduced in a fixed order: two runs give the same
    bits."""
    rng = np.random.default_rng(3)
    B, H, K = 65536, 128, 8
    m = (3 * K - 1) * D
    args = [_normal(rng, (D, B), 2.0).to(cuda), _normal(rng, (H, B)).to(cuda),
            _normal(rng, (m, H), 0.3 / np.sqrt(H)).to(cuda),
            _normal(rng, (m,), 0.1).to(cuda), torch.full((D,), 3.0,
                                                         device=cuda),
            _normal(rng, (D, B)).to(cuda), _normal(rng, (D, B)).to(cuda)]
    kw = dict(num_bins=K, tails="linear", inverse=True)
    first = tshf.fused_head_rqs_bwd(*args, **kw)
    second = tshf.fused_head_rqs_bwd(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch", [6000, 2000])
def test_training_step_on_cuda_matches_cpu(cuda, batch):
    """One ``make_forward_kld_step`` with SGD on the card against the same
    step on the CPU. B*D = 6000 takes kernel B forward and kernel E
    backward in the transform halves; 2000 (< 4096) takes kernel A and C
    there. The CDFs run A and C at both sizes."""
    cpu_model = nt.build_nsf(dim=2, K=2, hidden=16, num_bins=4,
                             device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in cpu_model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.2))
    gpu_model = nt.build_nsf(dim=2, K=2, hidden=16, num_bins=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = _normal(rng, (batch, 2), 1.5)
    losses = []
    for model, xb in ((cpu_model, x), (gpu_model, x.to(cuda))):
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        state = nt.init_train_state(model, opt)
        step = nt.make_forward_kld_step(opt)
        for c in (tk.rqs_fwd, tk.rqs_bwd, tshf.fused_head_rqs,
                  tshf.fused_head_rqs_bwd):
            c.launches = 0
        losses.append(step(state, xb))
    fused = batch >= 4096  # B*D, with D = 1 transformed feature
    assert (tk.rqs_fwd.launches, tk.rqs_bwd.launches) == \
        ((2, 2) if fused else (4, 4))
    assert (tshf.fused_head_rqs.launches, tshf.fused_head_rqs_bwd.launches) \
        == ((2, 2) if fused else (0, 0))
    torch.cuda.synchronize()
    torch.testing.assert_close(losses[1].cpu(), losses[0], atol=MODEL_TOL,
                               rtol=0)
    for p, q in zip(gpu_model.parameters(), cpu_model.parameters()):
        _rel_close(p.grad.cpu(), q.grad, MODEL_TOL)
        torch.testing.assert_close(p.detach().cpu(), q.detach(),
                                   atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("residual", [True, False])
def test_made_out_degrees_on_cuda(cuda, residual):
    """``out_degrees`` of a MADE's blocks on the card: the degrees its
    buffers hold, as numpy arrays."""
    made = MADE(3, 16, num_blocks=2, output_multiplier=5,
                use_residual_blocks=residual).to(cuda)
    assert made.initial_layer.degrees.device.type == "cuda"
    for blk in made.blocks:
        last = blk.linear_layers[1] if residual else blk.linear
        np.testing.assert_array_equal(blk.out_degrees,
                                      last.degrees.cpu().numpy())


def test_model_on_cuda_matches_cpu_and_runs_both_kernels(cuda):
    cpu_model = nt.build_nsf(dim=2, K=2, hidden=16, num_bins=4,
                             device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in cpu_model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.2))
    gpu_model = nt.build_nsf(dim=2, K=2, hidden=16, num_bins=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = _normal(rng, (6000, 2), 1.5)  # B*D = 6000 >= 4096: kernel B
    tk.rqs_fwd.launches = tshf.fused_head_rqs.launches = 0
    tk.rqs_bwd.launches = tshf.fused_head_rqs_bwd.launches = 0
    with torch.inference_mode():
        lp = gpu_model.log_prob(x.to(cuda))
        torch.cuda.synchronize()
        want = cpu_model.log_prob(x)
    assert tk.rqs_fwd.launches == 2
    assert tshf.fused_head_rqs.launches == 2
    assert tk.rqs_bwd.launches == tshf.fused_head_rqs_bwd.launches == 0
    torch.testing.assert_close(lp.cpu(), want, atol=MODEL_TOL, rtol=0)


# --- CUDA graphs: serving and the captured steps ------------------------------
# A replay runs the launches of its capture on the same inputs, so graph and
# eager agree to 1e-6 (serving; bitwise for the sampler) and 1e-5 (losses and
# parameters after five training steps).

GRAPH_TOL, STEP_TOL = 1e-6, 1e-5
GRAPH_SMALL = dict(dim=2, K=2, hidden=16, num_bins=4)


def _perturbed(build, seed=0, **kw):
    model = build(**kw)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.2).to(p.device))
    return model


def _eager_log_prob(model, x):
    with torch.no_grad():
        return model.log_prob(x)


def test_compiled_log_prob_graph_matches_eager(cuda):
    """B*D = 6000 takes kernels A and B; the capture counted 2 of each;
    a result the caller holds is not overwritten by the next call."""
    model = _perturbed(nt.build_nsf, **GRAPH_SMALL)
    rng = np.random.default_rng(1)
    x1, x2 = (_normal(rng, (6000, 2), 1.5).to(cuda) for _ in range(2))
    fn = nt.compile_log_prob(model, (6000, 2))
    want = {k: 0 for k in tops.launch_counts()}
    want.update(rqs_fwd=2, head_rqs_fwd=2)
    assert fn.launches == want
    held = fn(x1)
    again = fn(x2)
    torch.testing.assert_close(held, _eager_log_prob(model, x1),
                               atol=GRAPH_TOL, rtol=0)
    torch.testing.assert_close(again, _eager_log_prob(model, x2),
                               atol=GRAPH_TOL, rtol=0)
    assert held.data_ptr() != again.data_ptr()


@pytest.mark.parametrize("build", ["nsf", "circular"])
def test_compiled_sampler_is_bitwise_the_eager_sampler(cuda, build):
    model = (_perturbed(nt.build_nsf, **GRAPH_SMALL) if build == "nsf"
             else _perturbed(nt.build_circular_nsf, K=2, hidden=16,
                             num_bins=4))
    fn = nt.compile_sampler(model, 5000)
    for seed in (0, 7, 0):
        z, log_q = fn(seed)
        with torch.no_grad():
            z_e, log_q_e = model.sample(5000, generator=torch.Generator(
                "cuda").manual_seed(seed))
        assert torch.equal(z, z_e) and torch.equal(log_q, log_q_e)


def test_bucketed_graphs_match_eager_at_ragged_sizes(cuda):
    """Each request against the eager model on the same padded bucket (the
    same kernels), and against the eager model on the request itself."""
    model = _perturbed(nt.build_nsf, **GRAPH_SMALL)
    fn = nt.compile_log_prob_buckets(model, 5000, (2,))
    assert fn.buckets[-1] == 5000 and len(fn.buckets) == 14
    rng = np.random.default_rng(2)
    for n in (1, 1000, 3000, 5000):
        x = _normal(rng, (n, 2), 1.5).to(cuda)
        b = next(b for b in fn.buckets if b >= n)
        padded = torch.cat([x, x[-1:].expand(b - n, 2)])
        got = fn(x)
        assert got.shape == (n,)
        torch.testing.assert_close(got, _eager_log_prob(model, padded)[:n],
                                   atol=GRAPH_TOL, rtol=0)
        torch.testing.assert_close(got, _eager_log_prob(model, x),
                                   atol=MODEL_TOL, rtol=0)
    with pytest.raises(ValueError, match="largest bucket"):
        fn(torch.zeros(5001, 2, device=cuda))


def test_with_model_on_cuda_keeps_the_old_handles_weights(cuda):
    a = _perturbed(nt.build_nsf, 0, **GRAPH_SMALL)
    b = _perturbed(nt.build_nsf, 1, **GRAPH_SMALL)
    x = _normal(np.random.default_rng(3), (6000, 2), 1.5).to(cuda)
    fa = nt.compile_log_prob(a, (6000, 2))
    fb = fa.with_model(b)
    for _ in range(2):
        torch.testing.assert_close(fb(x), _eager_log_prob(b, x),
                                   atol=GRAPH_TOL, rtol=0)
        torch.testing.assert_close(fa(x), _eager_log_prob(a, x),
                                   atol=GRAPH_TOL, rtol=0)
    with torch.no_grad():
        want = a.log_prob(x)
        for p in a.parameters():
            p.add_(0.5)  # training the original in place changes no handle
    torch.testing.assert_close(fa(x), want, atol=GRAPH_TOL, rtol=0)


def test_load_refuses_to_build_while_capturing(cuda):
    """A library first asked for inside a capture raises: the warm-up
    calls must load it."""
    from nf_tpu_torch.ops import _build

    x = torch.zeros(16, device=cuda)
    w = torch.zeros(4, 16, device=cuda)
    d = torch.zeros(5, 16, device=cuda)
    tk.rqs_fwd(x, w, w, d, 3.0, inverse=False)  # built and loaded
    lib = _build._LIBS.pop("rqs_fwd")
    try:
        with pytest.raises(RuntimeError, match="not loaded"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                tk.rqs_fwd(x, w, w, d, 3.0, inverse=False)
    finally:
        _build._LIBS["rqs_fwd"] = lib


def _adam(model, **kw):
    return torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True,
                            **kw)


@pytest.mark.parametrize("options", [
    {}, dict(ema_decay=0.9, skip_nonfinite=True, accum_steps=2)],
    ids=["plain", "ema_guard_accum"])
def test_captured_forward_steps_match_eager(cuda, options):
    """Five steps at B = 6000 (kernels A and B forward, C and E backward):
    two eager warm-up steps, the capture (replayed once), two replays."""
    base = _perturbed(nt.build_nsf, **GRAPH_SMALL)
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    ema = "ema_decay" in options
    states = [nt.init_train_state(m, o, with_ema=ema)
              for m, o in zip(models, opts)]
    graphed = nt.make_forward_kld_step(opts[0], **options)
    eager = nt.make_forward_kld_step(opts[1], **options).eager
    rng = np.random.default_rng(4)
    k = options.get("accum_steps", 1)
    for i in range(5):
        x = _normal(rng, (6000, 2), 1.5).to(cuda)
        xb = nt.reshape_for_accum(x, k) if k > 1 else x
        lg, le = graphed(states[0], xb), eager(states[1], xb)
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    assert states[0].step == states[1].step == 5
    for p, q in zip(_train_params(states[0]), _train_params(states[1])):
        torch.testing.assert_close(p, q, atol=STEP_TOL, rtol=0)
    # two couplings per microbatch; a microbatch of 3000 rows is below the
    # fused-head gate (B*D >= 4096), so its transform halves take A and C
    fused = 6000 // k >= 4096
    per = 2 * k
    want = {k_: 0 for k_ in tops.launch_counts()}
    want.update(rqs_fwd=per * (1 if fused else 2),
                rqs_bwd=per * (1 if fused else 2),
                head_rqs_fwd=per if fused else 0,
                head_rqs_bwd=per if fused else 0)
    assert graphed.launches == want


def _train_params(state):
    out = [p.detach() for p in state.model.parameters()]
    if state.ema is not None:
        out += list(state.ema.parameters())
    return out


@pytest.mark.parametrize("mode", ["analytic", "autodiff"])
def test_captured_reverse_steps_match_eager(cuda, mode):
    """Five reverse-KLD steps of the circular NSF with a beta schedule, the
    graph's generator and the eager one seeded alike."""
    base = _perturbed(nt.build_circular_nsf, K=2, hidden=16, num_bins=4)
    base.p = _GaussVonMises()
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    kw = dict(num_samples=3000, beta_schedule=lambda s: min(1.0, 0.3 + 0.2 * s))
    graphed = nt.make_reverse_kld_step(opts[0], **kw)
    eager = nt.make_reverse_kld_step(opts[1], **kw).eager
    gens = [torch.Generator("cuda").manual_seed(5) for _ in range(2)]
    tk.set_pallas_bwd_kernel(mode)
    try:
        for _ in range(5):
            lg, le = graphed(states[0], gens[0]), eager(states[1], gens[1])
            torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, atol=STEP_TOL, rtol=0)
    kernel = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
    assert graphed.launches["rqs_fwd"] == 4 and graphed.launches[kernel] == 4


def _captured_step(cuda):
    model = _perturbed(nt.build_circular_nsf, K=2, hidden=16, num_bins=4)
    model.p = _GaussVonMises()
    opt = _adam(model)
    state = nt.init_train_state(model, opt)
    step = nt.make_reverse_kld_step(opt, num_samples=1000)
    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(3):  # two eager warm-up steps, then the capture
        step(state, gen)
    return step, state, opt, gen


def test_captured_step_refuses_a_host_side_optimizer(cuda):
    model = _perturbed(nt.build_nsf, **GRAPH_SMALL)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = nt.make_forward_kld_step(opt)
    with pytest.raises(ValueError, match="capturable=True"):
        step(nt.init_train_state(model, opt), torch.zeros(100, 2,
                                                          device=cuda))


def test_captured_step_raises_on_a_changed_lr(cuda):
    step, state, opt, gen = _captured_step(cuda)
    opt.param_groups[0]["lr"] = 1e-4
    with pytest.raises(RuntimeError, match="param_groups changed"):
        step(state, gen)


def test_captured_step_raises_on_a_changed_backward_mode(cuda):
    step, state, _, gen = _captured_step(cuda)
    tk.set_pallas_bwd_kernel("autodiff")
    try:
        with pytest.raises(RuntimeError, match="backward kernel"):
            step(state, gen)
    finally:
        tk.set_pallas_bwd_kernel("analytic")


def test_captured_step_raises_on_another_generator(cuda):
    step, state, _, _ = _captured_step(cuda)
    with pytest.raises(ValueError, match="generator"):
        step(state, torch.Generator("cuda").manual_seed(0))


def test_captured_step_raises_on_a_loaded_optimizer_state(cuda):
    """``load_state_dict`` gives the optimizer new state tensors; the graph
    would go on updating the old ones."""
    step, state, opt, gen = _captured_step(cuda)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    with pytest.raises(RuntimeError, match="state tensors were replaced"):
        step(state, gen)


def _residual(cuda):
    """A small ``build_residual`` (K 2, nets [2, 16, 16, 2]) on the card,
    perturbed, its power iterations advanced on the new weights."""
    from nf_tpu_torch.utils import update_lipschitz

    model = nt.build_residual(K=2, hidden=16, n_hidden_layers=2)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in model.parameters():
            noise = np.asarray(rng.standard_normal(tuple(p.shape)) * 0.2,
                               dtype=np.float32)
            p.add_(torch.from_numpy(noise).to(p.device))
    return update_lipschitz(model, 200)


def _keyed_step(opt):
    from nf_tpu_torch.utils import update_lipschitz

    return nt.make_forward_kld_step(
        opt, with_key=True, post_update=lambda m: update_lipschitz(m, 5))


def test_captured_keyed_residual_step_matches_eager(cuda):
    """The residual forward-KLD step with ``with_key`` (its probes and
    series lengths from the step's generator, registered with the graph)
    and ``post_update`` (the power iteration inside the graph): five
    captured steps against five eager ones on the same seeds, the loss,
    the parameters and the buffers ``u`` and ``v``."""
    base = _residual(cuda)
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m, weight_decay=1e-5) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed, eager = _keyed_step(opts[0]), _keyed_step(opts[1]).eager
    rng = np.random.default_rng(8)
    for i in range(5):
        x = _normal(rng, (512, 2), 1.5).to(cuda)
        lg, le = graphed(states[0], x, 100 + i), eager(states[1], x, 100 + i)
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    for a, b in zip(models[0].state_dict().values(),
                    models[1].state_dict().values()):
        torch.testing.assert_close(a, b, atol=STEP_TOL, rtol=0)
    assert not any(graphed.launches.values())


def test_captured_step_with_post_update_raises_on_a_loaded_optimizer_state(
        cuda):
    model = _residual(cuda)
    opt = _adam(model)
    state = nt.init_train_state(model, opt)
    step = _keyed_step(opt)
    x = torch.zeros((256, 2), device=cuda)
    for i in range(3):
        step(state, x, i)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    with pytest.raises(RuntimeError, match="state tensors were replaced"):
        step(state, x, 3)


def test_residual_graphs_match_eager(cuda):
    """Under the exact 2D log-det: the captured ``log_prob`` against eager
    and the sampler (each fixed point a WHILE node with kernel F) bitwise
    against eager, no layer's flag set."""
    from nf_tpu_torch import flows as tflows

    model = tflows.set_exact_logdet(_residual(cuda))
    x = _normal(np.random.default_rng(9), (3000, 2), 1.5).to(cuda)
    lp_fn = nt.compile_log_prob(model, (3000, 2))
    with torch.no_grad():
        want = model.log_prob(x)
    torch.testing.assert_close(lp_fn(x), want, atol=1e-6, rtol=0)
    sampler = nt.compile_sampler(model, 3000)
    z, log_q = sampler(5)
    with torch.no_grad():
        ze, lqe = model.sample(3000, generator=torch.Generator(
            "cuda").manual_seed(5))
    assert torch.equal(z, ze) and torch.equal(log_q, lqe)
    stats = tflows.fixed_point_stats(sampler._compiled.weights.model)
    assert len(stats) == 2 and not any(s[2] for s in stats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 131072])
def test_kernel_f_matches_plain_on_edge_planes(cuda, n, dtype):
    """Kernel F (the fixed-point loop's condition) against
    ``fixed_point_go`` on every edge plane of ``chip_smoke.edge_planes``
    (exact threshold, NaN, +-inf, counts 1000 and 1001, empty): the count
    set and bumped, go, the state's reset slots; in float32 also JAX's
    decision."""
    cs = _chip_smoke()
    assert cs.f_edge_cases(cuda, getattr(torch, dtype), n,
                           np.random.default_rng(n)) == 0


def test_kernel_f_at_the_exact_threshold(cuda):
    """``chip_smoke.f_threshold_trials``: random full planes with one
    element at ``d^2 / tol == 1`` and one ulp past it; each test is two
    counted launches of F."""
    cs = _chip_smoke()
    before = tops.launch_counts()["fixed_point_cond"]
    assert cs.f_threshold_trials(cuda, np.random.default_rng(5)) == 0
    assert tops.launch_counts()["fixed_point_cond"] - before \
        == 4 * cs.F_THRESHOLD_TRIALS


def test_residual_sampler_graph_past_32_passes(cuda):
    """``build_residual(lipschitz_const=0.99)`` with phase 18's
    closed-form weights (``chip_smoke.stiff_residual_model``) at B =
    4096: eager fixed points of over 32 passes, and the sampler graph
    (WHILE nodes, kernel F, two launches per layer at its capture)
    bitwise eager with the same counts per layer and no flag."""
    cs = _chip_smoke()
    model = cs.stiff_residual_model(cuda)
    sampler = nt.compile_sampler(model, 4096)
    assert sampler.launches["fixed_point_cond"] == 2 * cs.RES_STIFF_K
    counts = cs.sampler_loop_check("stiff sampler", model, sampler, 4096, 3)
    assert max(counts) > 32


def test_captured_residual_reverse_step_matches_eager(cuda):
    """The residual reverse-KLD step on TwoModes under the exact 2D
    log-det (its fixed points and their implicit VJPs WHILE nodes): five
    captured steps against five eager ones from twin generators, the loss
    and the parameters within 1e-5, the same fixed-point and VJP counts
    per layer, no flag."""
    from nf_tpu_torch import flows as tflows

    base = tflows.set_exact_logdet(_residual(cuda))
    base.p = nt.TwoModes()
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    gens = [torch.Generator("cuda").manual_seed(4) for _ in range(2)]
    graphed = nt.make_reverse_kld_step(opts[0], 512)
    eager = nt.make_reverse_kld_step(opts[1], 512).eager
    for _ in range(5):
        lg, le = graphed(states[0], gens[0]), eager(states[1], gens[1])
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(a, b, atol=STEP_TOL, rtol=0)
    stats = [tflows.fixed_point_stats(m) for m in models]
    assert stats[0] == stats[1] and not any(s[2] for s in stats[0])
    assert graphed.launches["fixed_point_cond"] == 4 * 2


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kernel_c_programmatic_edge_survives_capture(cuda):
    """Kernel C's shared-parameter sum is a programmatic dependent launch;
    stream capture keeps it as a programmatic edge (one per CDF backward:
    two couplings)."""
    from nf_tpu_torch._graphs import warm_up

    dependency_types = _chip_smoke().dependency_types
    model = _perturbed(nt.build_nsf, **GRAPH_SMALL)
    opt = _adam(model)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt)
    x = _normal(np.random.default_rng(6), (6000, 2), 1.5).to(cuda)
    warm_up(lambda: step.eager(state, x), cuda, 2)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = tops.launch_counts()["rqs_bwd"]
    with torch.cuda.graph(graph):
        step.eager(state, x)
    assert tops.launch_counts()["rqs_bwd"] - before == 2
    assert dependency_types(graph)["programmatic"] == 2


@pytest.mark.parametrize("build", ["nsf", "circular"])
def test_mixed_precision_on_cuda(cuda, build):
    """bf16 conditioners on the card: the circular NSF's bf16 MADEs within
    0.05 of the same model's bf16 on the CPU (the plain path), not its f32
    model's values, and its graph equal to eager; ``build_nsf``'s
    couplings at B*D >= 4096 take kernel B with the f32 trunk, so its
    log_prob is the f32 model's, bitwise. How far bf16 lies from f32 is
    held at the JAX package's bar on the CPU against JAX
    (``test_torch_mixed_precision.py``) and at full size by
    ``chip_smoke.py``."""
    kw = (GRAPH_SMALL if build == "nsf"
          else dict(K=2, hidden=64, num_bins=4))
    make = nt.build_nsf if build == "nsf" else nt.build_circular_nsf
    mixed = _perturbed(make, mixed_precision=True, **kw)
    f32 = make(**kw)
    f32.load_state_dict({k.replace(".net.", "."): v
                         for k, v in mixed.state_dict().items()})
    x = _normal(np.random.default_rng(7), (6000, 2), 1.5).to(cuda)
    lp = _eager_log_prob(mixed, x)
    lp32 = _eager_log_prob(f32, x)
    if build == "nsf":
        assert torch.equal(lp, lp32)
        return
    cpu = copy.deepcopy(mixed).to("cpu")
    torch.testing.assert_close(lp.cpu(), _eager_log_prob(cpu, x.cpu()),
                               atol=0.05, rtol=0)
    assert not torch.equal(lp, lp32)
    torch.testing.assert_close(nt.compile_log_prob(mixed, (6000, 2))(x), lp,
                               atol=GRAPH_TOL, rtol=0)


# --- the conditional NSF, RealNVP and MAF ------------------------------------

COND_SMALL = dict(K=2, hidden=64, num_bins=4)


def _contexts(rng, n, cuda):
    """``examples/conditional_flow.py``'s contexts: mean U(-1, 1), std
    U(0.5, 1.5)."""
    mu = rng.uniform(-1, 1, (n, 2))
    sigma = rng.uniform(0.5, 1.5, (n, 2))
    return torch.from_numpy(np.concatenate([mu, sigma], 1)
                            .astype(np.float32)).to(cuda)


def test_conditional_model_on_cuda_matches_cpu_and_runs_a_and_b(cuda):
    """The context-gated trunk at hidden 64 feeds kernel B (B*D = 6000)
    and the CDF kernel A, and the card agrees with the CPU."""
    model = _perturbed(nt.build_conditional_nsf, **COND_SMALL)
    cpu = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(11)
    x = _normal(rng, (6000, 2), 1.5).to(cuda)
    ctx = _contexts(rng, 6000, cuda)
    tops.reset_launch_counts()
    lp = _eager_log_prob_ctx(model, x, ctx)
    torch.cuda.synchronize()
    counts = tops.launch_counts()
    assert counts["rqs_fwd"] == 2 and counts["head_rqs_fwd"] == 2
    assert counts["rqs_bwd"] == counts["head_rqs_bwd"] == 0
    torch.testing.assert_close(
        lp.cpu(), _eager_log_prob_ctx(cpu, x.cpu(), ctx.cpu()),
        atol=MODEL_TOL, rtol=0)


def _eager_log_prob_ctx(model, x, ctx):
    with torch.no_grad():
        return model.log_prob(x, context=ctx)


def test_served_log_prob_reads_a_new_context_each_replay(cuda):
    model = _perturbed(nt.build_conditional_nsf, **COND_SMALL)
    rng = np.random.default_rng(12)
    x = _normal(rng, (6000, 2), 1.5).to(cuda)
    fn = nt.compile_log_prob(model, (6000, 2), context_shape=(6000, 4))
    assert fn.launches["head_rqs_fwd"] == 2
    outs = []
    for _ in range(3):
        ctx = _contexts(rng, 6000, cuda)
        got = fn(x, ctx)
        torch.testing.assert_close(got, _eager_log_prob_ctx(model, x, ctx),
                                   atol=GRAPH_TOL, rtol=0)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])
    sampler = nt.compile_sampler(model, 6000, context_shape=(6000, 4))
    for seed in (0, 3):
        z, log_q = sampler(seed, ctx)
        with torch.no_grad():
            ze, lqe = model.sample(6000, generator=torch.Generator("cuda")
                                   .manual_seed(seed), context=ctx)
        assert torch.equal(z, ze) and torch.equal(log_q, lqe)
    buckets = nt.compile_log_prob_buckets(model, 6000, (2,),
                                          context_shape=(4,))
    for n in (1, 1000, 5000):
        b = next(b for b in buckets.buckets if b >= n)
        xp = torch.cat([x[:n], x[n - 1:n].expand(b - n, 2)])
        cp = torch.cat([ctx[:n], ctx[n - 1:n].expand(b - n, 4)])
        torch.testing.assert_close(
            buckets(x[:n], ctx[:n]), _eager_log_prob_ctx(model, xp, cp)[:n],
            atol=GRAPH_TOL, rtol=0)


def test_captured_step_on_a_context_batch_matches_eager(cuda):
    """Five forward-KLD steps on ``(x, context)``, B = 6000: A and B
    forward, C and E backward, graph against eager."""
    base = _perturbed(nt.build_conditional_nsf, **COND_SMALL)
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed = nt.make_forward_kld_step(opts[0])
    eager = nt.make_forward_kld_step(opts[1]).eager
    rng = np.random.default_rng(13)
    for _ in range(5):
        ctx = _contexts(rng, 6000, cuda)
        x = ctx[:, :2] + ctx[:, 2:] * _normal(rng, (6000, 2)).to(cuda)
        lg, le = graphed(states[0], (x, ctx)), eager(states[1], (x, ctx))
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, atol=STEP_TOL, rtol=0)
    want = {k: 0 for k in tops.launch_counts()}
    want.update(rqs_fwd=2, head_rqs_fwd=2, rqs_bwd=2, head_rqs_bwd=2)
    assert graphed.launches == want


def test_actnorm_init_after_capture_is_seen_by_the_replay(cuda):
    """``init_from_data`` sets the ActNorms in place: a step captured
    before it computes its loss on the new values, and a served function
    rebound with ``with_model`` answers with them, with no recapture."""
    model = nt.build_realnvp(K=4, hidden=[16, 16])
    rng = np.random.default_rng(14)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".s." in name or ".t." in name:
                p.add_(_normal(rng, tuple(p.shape), 0.2).to(cuda))
    x = _normal(rng, (4096, 2), 1.5).to(cuda) + 3.0
    fn = nt.compile_log_prob(model, (4096, 2))
    opt = _adam(model)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt)
    for _ in range(3):  # two warm-up steps, then the capture
        step(state, x)
    graph = step.graphs[next(iter(step.graphs))].graph
    model.init_from_data(x)
    assert float(model.flows[1].data_dep_init_done) == 1.0
    with torch.no_grad():
        want = model.forward_kld(x)
    torch.testing.assert_close(step(state, x), want, atol=STEP_TOL, rtol=0)
    assert step.graphs[next(iter(step.graphs))].graph is graph
    rebound = fn.with_model(model)
    torch.testing.assert_close(rebound(x), _eager_log_prob(model, x),
                               atol=GRAPH_TOL, rtol=0)


@pytest.mark.parametrize("build", ["realnvp", "realnvp_scan", "maf"])
def test_kernel_free_models_serve_as_graphs(cuda, build):
    """RealNVP (unrolled and scanned, bitwise alike) and MAF on the card:
    graph against eager, card against CPU, and no port kernel in the
    capture."""
    model = (nt.build_maf(K=2, hidden=16) if build == "maf" else
             nt.build_realnvp(K=4, hidden=[16, 16],
                              scan=build == "realnvp_scan"))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        # small noise: a MAF's scales sigmoid(s + 2) + 1e-3 stay away
        # from 1e-3, and the log-densities of order 10
        for p in model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.05).to(cuda))
    x = _normal(np.random.default_rng(15), (6000, 2), 1.5).to(cuda)
    fn = nt.compile_log_prob(model, (6000, 2))
    assert not any(fn.launches.values())
    lp = _eager_log_prob(model, x)
    torch.testing.assert_close(fn(x), lp, atol=GRAPH_TOL, rtol=0)
    cpu = copy.deepcopy(model).to("cpu")
    torch.testing.assert_close(lp.cpu(), _eager_log_prob(cpu, x.cpu()),
                               atol=MODEL_TOL, rtol=0)
    sampler = nt.compile_sampler(model, 6000)
    z, log_q = sampler(5)
    with torch.no_grad():
        ze, lqe = model.sample(6000, generator=torch.Generator("cuda")
                               .manual_seed(5))
    assert torch.equal(z, ze) and torch.equal(log_q, lqe)


# --- the image stack: kernels A and C on 4D views, the image models ---------

# build_image_nsf's couplings at its defaults: (transformed channels, side)
IMG_LEVELS = ((6, 16), (12, 8))
IMG_REL_TOL = 1e-4  # a whole image model against the CPU, relative


def _image_planes(rng, batch, ct, side, cuda, K=8):
    """x (B, C, H, W) and a conditioner output (B, C*P, H, W) ~ N(0,
    0.5²) with its bin-major (P, B, C, H, W) view, as the image coupling
    makes them."""
    x = _normal(rng, (batch, ct, side, side), 1.5).to(cuda)
    out = _normal(rng, (batch, ct * (3 * K - 1), side, side), 0.5).to(cuda)
    return x, out


def _image_spline(x, out, inverse, K=8):
    """The image coupling's spline on ``out``'s bin-major view."""
    from nf_tpu_torch.ops import splines

    b, c, h, w = x.shape
    p = out.reshape(b, c, -1, h, w).permute(2, 0, 1, 3, 4)
    return splines.unconstrained_rational_quadratic_spline_kmajor(
        x, p[:K] / 8, p[K:2 * K] / 8, p[2 * K:], inverse=inverse,
        tails="linear", tail_bound=3.0)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch", [256, 64, 3])
@pytest.mark.parametrize("level", [0, 1])
def test_kernels_a_and_c_on_image_views_match_plain(cuda, level, batch,
                                                    inverse):
    """The image coupling's (P, B, C, H, W) planes reach kernel A as
    (P, B*C, H*W) views of the conditioner's output (no copy); A and C
    match their plain versions there, and autograd through the coupling's
    feed (kernel C, then the view, the scaling, the padding and the
    permute) gives the conditioner's output ``rqs_bwd_plain``'s
    gradients in its own (B, C*P, H, W) layout."""
    from nf_tpu_torch.ops import splines

    ct, side = IMG_LEVELS[level]
    rng = np.random.default_rng(100 + 10 * level + batch)
    x, out = _image_planes(rng, batch, ct, side, cuda)
    p = out.reshape(batch, ct, -1, side, side).permute(2, 0, 1, 3, 4)
    w, h = p[:8] / 8, p[8:16] / 8
    d = splines.pad_derivatives(p[16:], "linear", 1e-3, axis=0)
    views = tk.param_views(x, w, h, d)
    assert all(v.shape[1:] == (batch * ct, side * side)
               and v.data_ptr() == t.data_ptr()
               for v, t in zip(views, (w, h, d)))
    y, ld = tk.rqs_fwd(x, w, h, d, 3.0, inverse=inverse)
    yp, lp = tk.rqs_plain(x, w, h, d, 3.0, inverse=inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)
    cty, ctl = (_normal(rng, x.shape).to(cuda) for _ in range(2))
    got = tk.rqs_bwd(x, w, h, d, 3.0, cty, ctl, inverse=inverse)
    gx, gw, gh, gd = tk.rqs_bwd_plain(x, w, h, d, 3.0, cty, ctl,
                                      inverse=inverse)
    for a, b in zip(got, (gx, gw, gh, gd)):
        torch.testing.assert_close(a, b, atol=G_TOL, rtol=0)
    leaf = out.detach().clone().requires_grad_()
    xs = x.detach().clone().requires_grad_()
    tops.reset_launch_counts()
    y, ld = _image_spline(xs, leaf, inverse)
    torch.autograd.backward((y, ld), (cty, ctl))
    counts = tops.launch_counts()
    assert counts["rqs_fwd"] == 1 and counts["rqs_bwd"] == 1
    # the linear tails' padded end planes are constants: no gradient
    planes = torch.cat([gw / 8, gh / 8, gd[1:-1]])
    want = planes.permute(1, 2, 0, 3, 4).reshape(out.shape)
    torch.testing.assert_close(leaf.grad, want, atol=G_TOL, rtol=0)
    torch.testing.assert_close(xs.grad, gx, atol=G_TOL, rtol=0)


def _image_model(build, cuda, batch=16, seed=0, **kw):
    """An image model at its defaults (``build``: "image_nsf" or "glow"),
    every parameter moved by N(0, s²) (s 0.02 and 0.01: larger noise
    sends the untrained models' samples out of float32), its ActNorms set
    from procedural images; with a batch of those images and labels."""
    if build == "image_nsf":
        model, size = nt.build_image_nsf(**kw), 0.02
    else:
        model, size = nt.build_glow_multiscale(**kw), 0.01
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(_normal(rng, tuple(p.shape), size).to(cuda))
    from nf_tpu_torch.utils.preprocessing import Jitter, Scale

    imgs, y = nt.data.procedural_image_classes(seed, 4 * batch)
    x = Jitter()(Scale()(torch.from_numpy(imgs).to(cuda).float() / 255),
                 generator=torch.Generator(cuda).manual_seed(seed))
    y = torch.from_numpy(y).long().to(cuda)
    model.init_from_data(x, y if build == "glow" else None)
    return model, x[:batch], y[:batch]


@pytest.mark.parametrize("build", ["image_nsf", "glow"])
def test_image_models_on_cuda_match_cpu(cuda, build):
    model, x, y = _image_model(build, cuda)
    ys = (y,) if build == "glow" else ()
    tops.reset_launch_counts()
    with torch.no_grad():
        lp = model.log_prob(x, *ys)
    counts = tops.launch_counts()
    assert counts["rqs_fwd"] == (8 if build == "image_nsf" else 0)
    cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        want = cpu.log_prob(x.cpu(), *(v.cpu() for v in ys))
    _rel_close(lp.cpu(), want, IMG_REL_TOL)


@pytest.mark.parametrize("build", ["image_nsf", "glow"])
def test_image_models_serve_and_train_as_graphs(cuda, build):
    """log_prob graph against eager (same kernels: equal), the tempered
    sampler bitwise for a seed (with labels, and drawing its own), five
    captured steps against eager (bitwise: deterministic convolutions),
    and the captures' launches."""
    model, x, y = _image_model(build, cuda)
    cc = build == "glow"
    ys = (y,) if cc else ()
    fn = nt.compile_log_prob(model, tuple(x.shape), class_cond=cc)
    with torch.no_grad():
        want = model.log_prob(x, *ys)
    _rel_close(fn(x, *ys), want, GRAPH_TOL)
    per = 8 if build == "image_nsf" else 0
    expect = {k: 0 for k in tops.launch_counts()}
    assert fn.launches == dict(expect, rqs_fwd=per)
    samplers = [(nt.compile_sampler(model, 16, temperature=0.7,
                                    class_cond=cc), ys)]
    if cc:
        samplers.append((nt.compile_sampler(model, 16, temperature=0.7),
                         ()))
    for sampler, labels in samplers:
        for seed in (0, 7):
            z, log_q = sampler(seed, *labels)
            with torch.no_grad():
                ze, lqe = model.sample(
                    16, torch.Generator("cuda").manual_seed(seed),
                    y=labels[0] if labels else None, temperature=0.7)
            assert torch.equal(z, ze) and torch.equal(log_q, lqe)
    models = [copy.deepcopy(model) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed = nt.make_forward_kld_step(opts[0])
    eager = nt.make_forward_kld_step(opts[1]).eager
    batch = (x, y) if cc else x
    for _ in range(5):
        lg, le = graphed(states[0], batch), eager(states[1], batch)
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, atol=STEP_TOL, rtol=0)
    assert graphed.launches == dict(expect, rqs_fwd=per, rqs_bwd=per)


def test_image_step_under_kernel_d_matches_kernel_c(cuda):
    """One image-NSF step's gradients with kernel D as the spline's
    backward against kernel C's, 8 launches of each."""
    model, x, _ = _image_model("image_nsf", cuda)
    grads = {}
    try:
        for mode in ("analytic", "autodiff"):
            tk.set_pallas_bwd_kernel(mode)
            m = copy.deepcopy(model)
            tops.reset_launch_counts()
            m.forward_kld(x).backward()
            counts = tops.launch_counts()
            assert counts[{"analytic": "rqs_bwd",
                           "autodiff": "rqs_bwd_autodiff"}[mode]] == 8
            grads[mode] = [p.grad for p in m.parameters()]
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    for a, b in zip(grads["autodiff"], grads["analytic"]):
        _rel_close(a, b, SUM_TOL)


def test_convs_compute_float32_and_deterministically_with_tf32_allowed(
        cuda):
    """With ``torch.backends.cudnn.allow_tf32`` True (PyTorch's default)
    the conditioners' convolutions, forward and backward, stay within
    float32 rounding of float64 (TF32 would be ~1e-3 off), two backward
    passes agree bitwise, and the flags are left as they were."""
    from nf_tpu_torch.nets import ConvNet2d, ConvResidualNet

    gen = torch.Generator().manual_seed(3)
    nets = [(ConvResidualNet(6, 138, 64, generator=gen), (32, 6, 16, 16)),
            (ConvNet2d((6, 256, 256, 12), (3, 1, 3), init_zeros=False,
                       generator=gen), (16, 6, 16, 16))]
    rng = np.random.default_rng(16)
    before = torch.backends.cudnn.allow_tf32, \
        torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = True
    try:
        for net, shape in nets:
            net = net.to(cuda)
            x = _normal(rng, shape).to(cuda)
            g = _normal(rng, net(x).shape).to(cuda)
            runs = []
            for dtype in (torch.float32, torch.float32, torch.float64):
                m = copy.deepcopy(net).to(dtype)
                out = m(x.to(dtype))
                (out * g.to(dtype)).sum().backward()
                runs.append([out.detach()] + [p.grad for p in
                                              m.parameters()])
            for a, b in zip(runs[0], runs[1]):
                assert torch.equal(a, b)
            for a, b in zip(runs[0], runs[2]):
                _rel_close(a.double().cpu(), b.cpu(), 1e-5)
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = before
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic) == before


def test_remat_step_matches_the_unrolled_step(cuda):
    """``scan=True, remat=True`` Glow: one eager step's loss and gradients
    against the unrolled model's, at less peak memory."""
    model, x, y = _image_model("glow", cuda, batch=32)
    remat = nt.load_reference_state_dict(
        nt.build_glow_multiscale(scan=True, remat=True),
        {k: v.cpu().numpy() for k, v in model.state_dict().items()})
    out = []
    for m in (model, remat):
        m = copy.deepcopy(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = m.forward_kld(x, y)
        loss.backward()
        torch.cuda.synchronize()
        out.append((loss.detach(), [p.grad for p in m.parameters()],
                    torch.cuda.max_memory_allocated() - base))
    _rel_close(out[1][0].cpu(), out[0][0].cpu(), 1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        _rel_close(a.cpu(), b.cpu(), 1e-5)
    assert out[1][2] < out[0][2]


@pytest.mark.parametrize("build", ["image_nsf", "glow"])
def test_mixed_precision_image_models_on_cuda(cuda, build):
    """bf16 conditioners (cuDNN's bf16 convolutions) within the JAX
    package's bar of the same weights in float32 (0.05 abs + 0.05
    relative), the graph equal to eager, and a step's float32 gradients
    finite."""
    f32, x, y = _image_model(build, cuda, batch=8)
    make = nt.build_image_nsf if build == "image_nsf" \
        else nt.build_glow_multiscale
    mixed = nt.load_reference_state_dict(
        make(mixed_precision=True),
        {k: v.cpu().numpy() for k, v in f32.state_dict().items()})
    ys = (y,) if build == "glow" else ()
    with torch.no_grad():
        lp, lp32 = mixed.log_prob(x, *ys), f32.log_prob(x, *ys)
    torch.testing.assert_close(lp, lp32, atol=0.05, rtol=0.05)
    assert not torch.equal(lp, lp32)
    fn = nt.compile_log_prob(mixed, tuple(x.shape),
                             class_cond=build == "glow")
    torch.testing.assert_close(fn(x, *ys), lp, atol=0, rtol=0)
    mixed.forward_kld(x, *ys).backward()
    grads = [p.grad for p in mixed.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32
                         and bool(torch.isfinite(g).all()) for g in grads)


# --- dropout and batch norm on the kernel paths --------------------------------

DROPOUT_P = 0.1


def _dropout_nsf(cuda, batch_norm=False):
    """``build_nsf``'s layers at small size (dim 2, K 2, hidden 16, 4
    bins, LULinearPermute) with ``dropout_probability`` 0.1 in every
    coupling trunk (or, with ``batch_norm``, batch-norm trunks), perturbed
    by N(0, 0.2²)."""
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import ResidualBlock

    gen = torch.Generator().manual_seed(0)
    flows = []
    for i in range(2):
        flows += [tflows.CoupledRationalQuadraticSpline(
                      2, 2, 16, num_bins=4, tail_bound=3.0,
                      dropout_probability=DROPOUT_P, reverse_mask=i % 2 == 1,
                      generator=gen),
                  tflows.LULinearPermute(2, generator=gen)]
    model = nt.NormalizingFlow(tdist.DiagGaussian(2, trainable=False), flows)
    if batch_norm:
        for m in model.modules():
            if isinstance(m, ResidualBlock):
                from nf_tpu_torch.nets.resnet import _batch_norms
                m.batch_norm_layers = _batch_norms(True, 16, torch.float32)
    model = model.to(cuda)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.2).to(cuda))
    return model


def test_captured_keyed_dropout_step_matches_eager(cuda):
    """The keyed forward-KLD step of a dropped-out NSF at B = 8192 (kernel
    B forward, E backward): its masks come from the step's generator,
    registered with the graph and reseeded per call, so five replays on
    five seeds match five eager steps; another seed drops other
    activations; without a generator the same weights are the p = 0
    model's."""
    base = _dropout_nsf(cuda)
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed = nt.make_forward_kld_step(opts[0], with_key=True)
    eager = nt.make_forward_kld_step(opts[1], with_key=True).eager
    rng = np.random.default_rng(12)
    xs = [_normal(rng, (8192, 2), 1.5).to(cuda) for _ in range(6)]
    for i in range(5):
        lg, le = graphed(states[0], xs[i], 40 + i), eager(states[1], xs[i],
                                                           40 + i)
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, atol=STEP_TOL, rtol=0)
    want = {k: 0 for k in tops.launch_counts()}
    want.update(rqs_fwd=2, rqs_bwd=2, head_rqs_fwd=2, head_rqs_bwd=2)
    assert graphed.launches == want
    m = models[1]
    with torch.no_grad():
        keyed = [m.forward_kld(xs[5], generator=torch.Generator(
            cuda).manual_seed(s)) for s in (1, 1, 2)]
        plain = m.forward_kld(xs[5])
    assert torch.equal(keyed[0], keyed[1])
    assert not torch.equal(keyed[0], keyed[2])
    assert not torch.equal(keyed[0], plain)
    p0 = copy.deepcopy(m)
    for mod in p0.modules():
        if hasattr(mod, "dropout_probability"):
            mod.dropout_probability = 0.0
    with torch.no_grad():
        assert torch.equal(p0.log_prob(xs[5]), m.log_prob(xs[5]))
        assert torch.equal(p0.forward_kld(xs[5], generator=torch.Generator(
            cuda).manual_seed(1)), plain)


def test_kernels_b_and_e_behind_a_batch_norm_trunk_match_plain(cuda):
    """Kernel B's and E's operands from a batch-norm trunk (h_t normalised
    over the batch on the transposed layout) at B = 8192, against their
    plain versions; and the layer's log_prob and gradients on the card
    (B and E) against the CPU (the unfused plain path)."""
    from nf_tpu_torch.flows.neural_spline.feed import FusedFeed

    model = _dropout_nsf(cuda, batch_norm=True)
    layer = model.flows[0].prqct
    net = layer.transform_net
    rng = np.random.default_rng(13)
    x = _normal(rng, (8192, 2), 1.5).to(cuda)
    with torch.no_grad():
        id_split, t_split = layer._split(x)
        params = layer._transform_params(id_split, None)
        assert isinstance(params, FusedFeed)
        h_t = params.h_t.contiguous()
        w, b = tshf.effective_head(
            net.final_layer.weight, net.final_layer.bias, num_bins=4,
            feats=1, tails="linear", softmax_scale=layer.softmax_scale)
    tb = torch.full((1,), 3.0, device=cuda)
    x_t = t_split.T.contiguous()
    cty, ctl = (_normal(rng, (1, 8192)).to(cuda) for _ in range(2))
    for inverse in (False, True):
        kw = dict(num_bins=4, tails="linear", inverse=inverse)
        y, ld = tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw)
        yp, lp = tshf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
        torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
        torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)
        got = tshf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty, ctl, **kw)
        plain = tshf.head_rqs_bwd_plain_in_kernel_order(
            x_t, h_t, w, b, tb, cty, ctl, **kw)
        for g, p in zip(got[:2], plain[:2]):
            torch.testing.assert_close(g, p, atol=G_TOL, rtol=0)
        for g, p in zip(got[2:], plain[2:]):
            assert float((g - p).abs().max()) \
                <= SUM_TOL * max(float(p.abs().max()), 1.0)
    cpu = copy.deepcopy(model).to("cpu")
    before = tops.launch_counts()
    loss = model.forward_kld(x)
    loss.backward()
    after = tops.launch_counts()
    assert after["head_rqs_fwd"] - before["head_rqs_fwd"] == 2
    assert after["head_rqs_bwd"] - before["head_rqs_bwd"] == 2
    loss_cpu = cpu.forward_kld(x.cpu())
    loss_cpu.backward()
    assert abs(float(loss.detach()) - float(loss_cpu.detach())) <= MODEL_TOL
    for p, q in zip(model.parameters(), cpu.parameters()):
        if q.grad is not None:
            scale = max(float(q.grad.abs().max()), 1.0)
            assert float((p.grad.cpu() - q.grad).abs().max()) \
                <= MODEL_TOL * scale


@pytest.mark.parametrize("score_fn", [True, False])
def test_captured_circular_step_with_made_dropout_matches_eager(cuda,
                                                                score_fn):
    """The circular NSF's reverse-KLD step with MADE dropout (kernels A and
    C), sticking the landing's re-pass on the sampling pass's masks under
    ``score_fn=False``: five replays against five eager steps."""
    from nf_tpu_torch.nets.made import MaskedResidualBlock

    base = _perturbed(nt.build_circular_nsf, K=2, hidden=16, num_bins=4)
    for m in base.modules():
        if isinstance(m, MaskedResidualBlock):
            m.dropout_probability = DROPOUT_P
    base.p = _GaussVonMises()
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    kw = dict(num_samples=4096, score_fn=score_fn)
    graphed = nt.make_reverse_kld_step(opts[0], **kw)
    eager = nt.make_reverse_kld_step(opts[1], **kw).eager
    gens = [torch.Generator("cuda").manual_seed(9) for _ in range(2)]
    for _ in range(5):
        lg, le = graphed(states[0], gens[0]), eager(states[1], gens[1])
        torch.testing.assert_close(lg, le, atol=STEP_TOL, rtol=0)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, atol=STEP_TOL, rtol=0)
    per = 4 if score_fn else 6  # the re-pass: one more A and C per layer
    assert graphed.launches["rqs_fwd"] == per
    assert graphed.launches["rqs_bwd"] == per


def test_ar_layer_round_trip_under_one_draw_on_cuda(cuda):
    """One circular AR layer (kernel A) with MADE dropout: under one draw
    (``shared_masks``) ``inverse(forward(x))`` is x; with two draws it is
    not."""
    from nf_tpu_torch.nets._dropout import shared_masks

    model = _perturbed(nt.build_circular_nsf, K=1, hidden=16, num_bins=4)
    layer = model.flows[0]
    for m in layer.modules():
        if hasattr(m, "dropout_probability"):
            m.dropout_probability = 0.3
    rng = np.random.default_rng(14)
    x = torch.stack([torch.from_numpy(rng.uniform(-3.0, 3.0, 4096)),
                     torch.from_numpy(rng.standard_normal(4096))],
                    dim=1).float().to(cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    with torch.no_grad(), shared_masks():
        y, ld = layer.forward(x, generator=gen)
        back, ld_back = layer.inverse(y, generator=gen)
    torch.testing.assert_close(back, x, atol=1e-3, rtol=0)
    torch.testing.assert_close(ld + ld_back, torch.zeros_like(ld),
                               atol=1e-3, rtol=0)
    with torch.no_grad():
        y, _ = layer.forward(x, generator=gen)
        back, _ = layer.inverse(y, generator=gen)
    assert float((back - x).abs().max()) > 1e-2


# --- stochastic flows, HAIS and the infrastructure ----------------------------

def _small_snf(cuda, nsf=False):
    """A K 2 SNF (HMC after the second block) on TwoModes, on the card:
    affine blocks, or ``build_nsf``'s layer pairs (kernels B and E above
    the fused-head gate)."""
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import MLP
    from nf_tpu_torch.utils.masks import create_alternating_binary_mask

    gen = torch.Generator().manual_seed(0)
    base = tdist.DiagGaussian(2, trainable=False)
    target = tdist.TwoModes()
    if nsf:
        flows = list(nt.build_nsf(K=2, hidden=32, device="cpu").flows)
    else:
        flows = []
        for i in range(2):
            flows += [tflows.MaskedAffineFlow(
                create_alternating_binary_mask(2, even=(i % 2 == 0)),
                t=MLP([2, 16, 16, 2], generator=gen),
                s=MLP([2, 16, 16, 2], generator=gen)), tflows.ActNorm(2)]
    flows.append(tflows.HamiltonianMonteCarlo(
        tdist.LinearInterpolation(target, base, alpha=1.0), 5,
        np.log(np.full(2, 0.2)), np.zeros(2)))
    return nt.NormalizingFlow(base, flows, p=target).to(cuda)


@pytest.mark.parametrize("nsf", [False, True])
def test_hmc_reverse_step_captures_its_double_backward(cuda, nsf):
    """The reverse-KLD step through an HMC layer (its leapfrog gradient
    built with ``create_graph=True``) captured as a CUDA graph: five
    captured steps equal five eager ones within 1e-5, and the HMC layer's
    parameters moved."""
    model = _small_snf(cuda, nsf)
    models = [copy.deepcopy(model) for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3, capturable=True)
            for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    batch = 4096
    graphed = nt.make_reverse_kld_step(opts[0], num_samples=batch)
    eager = nt.make_reverse_kld_step(opts[1], num_samples=batch).eager
    gens = [torch.Generator(device=cuda).manual_seed(1) for _ in range(2)]
    for _ in range(5):
        lg = graphed(states[0], gens[0])
        le = eager(states[1], gens[1])
        torch.testing.assert_close(lg, le, atol=1e-5, rtol=0)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(p, q, atol=1e-5, rtol=0)
    hmc = models[0].flows[-1]
    assert float((hmc.log_step_size.detach() - np.log(0.2)).abs().max()) > 0
    if nsf:
        assert graphed.launches["head_rqs_fwd"] == 2
        assert graphed.launches["head_rqs_bwd"] == 2


def test_prefetch_orders_its_copies_before_the_consumer(cuda):
    """``prefetch_to_device`` copies on a side stream; each batch is
    complete when the consumer's stream reads it, while a long kernel
    holds that stream: a sum on the consumer's stream equals numpy's."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((16 * 65536, 4)).astype(np.float32)
    ds = nt.data.ArrayDataset(data, batch_size=65536, shuffle=False)
    sums = []
    for b in nt.data.prefetch_to_device(ds, size=3):
        assert b.is_cuda
        torch.cuda._sleep(2_000_000)
        sums.append(b.double().sum())
    want = data.reshape(16, 65536, 4).astype(np.float64).sum(axis=(1, 2))
    np.testing.assert_allclose(torch.stack(sums).cpu().numpy(), want,
                               rtol=1e-9)


def test_capture_survives_a_prefetch_worker_allocating(cuda):
    """A step captured while ``prefetch_to_device``'s worker pins and
    copies the next batch (``cudaHostAlloc`` and ``cudaMalloc`` in another
    thread, each batch larger than the last so the caching allocators
    miss): the capture holds (``_graphs.capture`` captures thread-local;
    under CUDA's global mode the worker's calls invalidate it), a replay
    gives the captured value, and the worker's batches arrive whole."""
    import time

    from nf_tpu_torch._graphs import capture

    def batches():
        for i in range(4):
            if i:
                time.sleep(0.05)  # the worker allocates inside the capture
            yield np.full((1 << (20 + i),), float(i + 1), np.float32)

    it = nt.data.prefetch_to_device(batches(), size=1)
    first = next(it)
    w = torch.arange(4.0, device=cuda)

    def step():
        time.sleep(0.3)  # hold the capture open while the worker runs
        return (first[:4] * w).sum()

    graph, out, _ = capture(step, cuda)
    graph.replay()
    torch.cuda.synchronize()
    assert float(out) == float((first[:4] * w).sum())
    rest = [float(b[0]) for b in it]
    assert rest == [2.0, 3.0, 4.0]


def test_checkpoint_round_trip_of_a_captured_step(cuda, tmp_path):
    """A ``CheckpointManager`` save of a captured reverse-KLD step's state
    (model, capturable Adam, the step's generator), restored in place: the
    replays after the restore equal those of the uninterrupted run,
    bitwise, and the captured graph keeps running."""
    model = _small_snf(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True)
    state = nt.init_train_state(model, opt)
    step = nt.make_reverse_kld_step(opt, num_samples=1024)
    gen = torch.Generator(device=cuda).manual_seed(2)
    manager = nt.utils.CheckpointManager(tmp_path, max_to_keep=1)
    for _ in range(4):
        step(state, gen)
    manager.save(state.step, state, generator=gen)
    after = [step(state, gen) for _ in range(3)]
    params = [p.detach().clone() for p in model.parameters()]
    _, at = manager.restore(state, generator=gen)
    again = [step(state, gen) for _ in range(3)]
    assert at == 4 and state.step == 7
    for a, b in zip(after, again):
        assert torch.equal(a, b)
    for p, q in zip(params, model.parameters()):
        assert torch.equal(p, q.detach())


# --- the kernels as torch.library ops (nf_tpu_torch.ops) ----------------------

def _op_operands(cuda, rng, K=8, rows=4096, cols=2):
    """Kernel views for the spline ops: x (rows, cols), full per-element
    parameter planes (K, rows, cols) / (K+1, ...), a float tail bound,
    cotangents."""
    x = _normal(rng, (rows, cols), 1.5).to(cuda)
    w, h = (_normal(rng, (K, rows, cols), 0.5).to(cuda) for _ in range(2))
    d = _normal(rng, (K + 1, rows, cols), 0.5).to(cuda)
    cty, ctl = (_normal(rng, (rows, cols)).to(cuda) for _ in range(2))
    return x, w, h, d, cty, ctl


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_ops_match_their_plain_twins_on_cuda(cuda, inverse):
    """Each spline op on CUDA tensors (the kernel) against its plain twin
    on the same tensors: A 1e-5 / 1e-4, C, D and C's shared path 1e-4
    (per element; the shared path's row sums relative to the largest).
    The ops count their launches as the wrappers did."""
    ops = torch.ops.nf_tpu_torch
    minima = (1e-3, 1e-3, 1e-3)
    x, w, h, d, cty, ctl = _op_operands(cuda, np.random.default_rng(40))
    tops.reset_launch_counts()
    y, ld = ops.rqs_fwd(x, w, h, d, None, 3.0, inverse, *minima)
    yp, lp = tk.rqs_plain(x, w, h, d, 3.0, inverse=inverse)
    assert _max_err(y, yp) <= Y_TOL and _max_err(ld, lp) <= LD_TOL
    for name, plain in (("rqs_bwd", tk.rqs_bwd_plain),
                        ("rqs_bwd_autodiff", tk.rqs_vjp_plain)):
        got = getattr(ops, name)(x, w, h, d, None, 3.0, cty, ctl, inverse,
                                 *minima)
        want = plain(x, w, h, d, 3.0, cty, ctl, inverse=inverse)
        for a, b in zip(got, want):
            assert _max_err(a, b) <= G_TOL
    small = [t[:, :1] for t in (w, h, d)]
    got = ops.rqs_bwd_shared(x, *small, None, 3.0, cty, ctl, inverse,
                             *minima)
    want = tk.rqs_bwd_shared_plain(x, *small, 3.0, cty, ctl, inverse=inverse)
    assert _max_err(got[0], want[0]) <= G_TOL
    for a, b in zip(got[1:], want[1:]):
        assert _max_err(a, b) <= SUM_TOL * max(float(b.abs().max()), 1.0)
    assert tops.launch_counts() == {"rqs_fwd": 1, "head_rqs_fwd": 0,
                                    "rqs_bwd": 2, "head_rqs_bwd": 0,
                                    "rqs_bwd_autodiff": 1,
                                    "fixed_point_cond": 0}


def _max_err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("inverse", [False, True])
def test_head_ops_match_their_plain_twins_on_cuda(cuda, inverse):
    """Kernels B and E through their ops against the plain versions summed
    in the kernels' order (the head product's rounding is then the
    kernels'): B 1e-5 / 1e-4, E 1e-4 per element, gW and gb 1e-4
    relative to the largest."""
    rng = np.random.default_rng(41)
    K, D, H, B = 8, 1, 128, 8192
    m = (3 * K - 1) * D
    x_t = _normal(rng, (B, D), 1.5).to(cuda).T
    h_t = _normal(rng, (H, B)).to(cuda)
    w = _normal(rng, (m, H), 0.3 / np.sqrt(H)).to(cuda)
    b = _normal(rng, (m,), 0.1).to(cuda)
    tb = torch.full((D,), 3.0, device=cuda)
    cty, ctl = (_normal(rng, (D, B)).to(cuda) for _ in range(2))
    kw = dict(num_bins=K, tails="linear", inverse=inverse)
    ops = torch.ops.nf_tpu_torch
    y, ld = ops.head_rqs_fwd(x_t, h_t, w, b, tb, K, False, inverse, 1e-3,
                             1e-3, 1e-3)
    yp, lp = tshf.head_rqs_plain_in_kernel_order(x_t, h_t, w, b, tb, **kw)
    assert _max_err(y, yp) <= Y_TOL and _max_err(ld, lp) <= LD_TOL
    got = ops.head_rqs_bwd(x_t, h_t, w, b, tb, K, False, cty, ctl, inverse,
                           1e-3, 1e-3, 1e-3)
    want = tshf.head_rqs_bwd_plain_in_kernel_order(x_t, h_t, w, b, tb, cty,
                                                   ctl, **kw)
    for a, bb in zip(got[:2], want[:2]):
        assert _max_err(a, bb) <= G_TOL
    for a, bb in zip(got[2:], want[2:]):
        assert _max_err(a, bb) <= SUM_TOL * max(float(bb.abs().max()), 1.0)


def test_captured_op_routed_step_is_bitwise_its_eager_step(cuda):
    """``build_nsf``'s forward-KLD step at B = 6000, its kernels reached
    through the ops (A, B forward; C, E as their registered backward):
    five captured steps are bitwise five eager ones."""
    base = _perturbed(nt.build_nsf, 5, **GRAPH_SMALL)
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [_adam(m) for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed = nt.make_forward_kld_step(opts[0])
    eager = nt.make_forward_kld_step(opts[1]).eager
    rng = np.random.default_rng(42)
    for _ in range(5):
        x = _normal(rng, (6000, 2), 1.5).to(cuda)
        assert torch.equal(graphed(states[0], x), eager(states[1], x))
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p, q)
    assert graphed.launches["head_rqs_fwd"] == 2


def test_exported_artifacts_on_cuda(cuda):
    """A ``build_nsf`` on the card at B = 6000 exported and reloaded: the
    artifact holds one op node per launch of the compiled replay, its
    graph answers within 1e-5 of ``compile_log_prob`` and its sampler is
    bitwise ``compile_sampler``'s; moved to the CPU (``platforms``), its
    ``log_prob`` is within 1e-3 of the card's."""
    from nf_tpu_torch import serving

    model = _perturbed(nt.build_nsf, 6, **GRAPH_SMALL)
    x = _normal(np.random.default_rng(43), (6000, 2), 1.5).to(cuda)
    compiled = nt.compile_log_prob(model, (6000, 2))
    blob = serving.export_log_prob(model, (6000, 2), platforms=("cuda",
                                                                 "cpu"))
    fn = serving.load_exported(blob)
    assert fn.kernel_nodes() == {k: v for k, v in compiled.launches.items()
                                 if v}
    got = fn(x)
    torch.testing.assert_close(got, compiled(x), atol=1e-5, rtol=0)
    torch.testing.assert_close(fn(x), got, atol=0, rtol=0)
    assert fn.launches == compiled.launches
    cpu = serving.load_exported(blob, device="cpu")
    torch.testing.assert_close(cpu(x.cpu()), got.cpu(), atol=MODEL_TOL,
                               rtol=0)
    sampler = serving.load_exported(serving.export_sampler(model, 6000))
    want = nt.compile_sampler(model, 6000)
    for seed in (1, 2, 1):
        z, log_q = sampler(seed)
        zc, lqc = want(seed)
        assert torch.equal(z, zc) and torch.equal(log_q, lqc)
    with pytest.raises(ValueError, match="platforms"):
        serving.load_exported(serving.export_log_prob(model, (6000, 2)),
                              device="cpu")


# --- the bfloat16 instantiations of kernels A, C and D ------------------------

def _bf16_ulps(got, want, grad):
    """max |got - want| over one bfloat16 ulp of ``want``, ``2^-7 |want| +
    1e-6`` (gradients ``+ 1e-4 max |want|``): at most 1 passes."""
    g, w = got.float(), want.float()
    bar = 2.0 ** -7 * w.abs() + 1e-6
    if grad:
        bar = bar + 1e-4 * float(w.abs().max())
    return float(((g - w).abs() / bar).max())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
def test_bf16_kernels_match_their_plain_versions(cuda, K, inverse):
    """A, C and D on bfloat16 operands at a ragged (D, B) with a
    per-feature tail bound: bfloat16 outputs, each element within one
    bfloat16 ulp of the plain version (which widens, computes in float32
    and rounds); A bitwise."""
    rng = np.random.default_rng(100 + K)
    D, B = 3, 70001
    bf = torch.bfloat16
    x = _normal(rng, (D, B), 2.0).to(cuda, bf)
    w, h = (_normal(rng, (K, D, B), 0.5).to(cuda, bf) for _ in range(2))
    d = _normal(rng, (K + 1, D, B), 0.5).to(cuda, bf)
    tb = torch.tensor([[1.5], [2.5], [3.0]], device=cuda, dtype=bf)
    cty, ctl = (_normal(rng, (D, B)).to(cuda, bf) for _ in range(2))
    before = tops.bf16_launch_counts()
    y, ld = tk.rqs_fwd(x, w, h, d, tb, inverse=inverse)
    yp, lp = tk.rqs_plain(x, w, h, d, tb, inverse=inverse)
    gc = tk.rqs_bwd(x, w, h, d, tb, cty, ctl, inverse=inverse)
    gcp = tk.rqs_bwd_plain(x, w, h, d, tb, cty, ctl, inverse=inverse)
    gd = tk.rqs_bwd_autodiff(x, w, h, d, tb, cty, ctl, inverse=inverse)
    gdp = tk.rqs_vjp_plain(x, w, h, d, tb, cty, ctl, inverse=inverse)
    torch.cuda.synchronize()
    after = tops.bf16_launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "rqs_fwd": 1, "rqs_bwd": 1, "rqs_bwd_autodiff": 1,
        "head_rqs_fwd": 0, "head_rqs_bwd": 0, "rqs_bwd_shared": 0}
    assert torch.equal(y, yp) and torch.equal(ld, lp)
    for got, want in ((gc, gcp), (gd, gdp)):
        for a, b in zip(got, want):
            assert a.dtype == bf and _bf16_ulps(a, b, True) <= 1.0


def test_bf16_spline_gradients_run_the_bf16_kernels(cuda):
    """Autograd through kernel A on bfloat16 leaves runs kernel C's (or,
    under "autodiff", D's) bfloat16 instantiation and gives bfloat16
    gradients; the CDF's shared path takes bfloat16 too, and raises on
    float16."""
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    x = _normal(rng, (4, 3000), 2.0).to(cuda, bf).requires_grad_()
    w = _normal(rng, (8, 4, 3000), 0.5).to(cuda, bf).requires_grad_()
    d = _normal(rng, (9, 4, 3000), 0.5).to(cuda, bf).requires_grad_()
    for mode in ("analytic", "autodiff"):
        tk.set_pallas_bwd_kernel(mode)
        try:
            before = tops.bf16_launch_counts()
            y, ld = tk.rqs_fwd(x, w, w, d, 3.0, inverse=True)
            (y.float().sum() + ld.float().sum()).backward()
        finally:
            tk.set_pallas_bwd_kernel("analytic")
        after = tops.bf16_launch_counts()
        name = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
        assert after[name] - before[name] == 1
        assert x.grad.dtype == w.grad.dtype == bf
        x.grad = w.grad = d.grad = None
    xs = x.detach()[:, :8]
    ws, ds = (t.detach()[:, :1, :8] for t in (w, d))
    before = tops.bf16_launch_counts()["rqs_bwd_shared"]
    grads = tk.rqs_bwd_shared(xs, ws, ws, ds, 3.0, xs, xs, inverse=False)
    assert all(g.dtype == bf for g in grads)
    assert tops.bf16_launch_counts()["rqs_bwd_shared"] - before == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.rqs_bwd_shared(*(t.half() for t in (xs, ws, ws, ds)), 3.0,
                          xs.half(), xs.half(), inverse=False)


# --- the bfloat16 instantiations of kernels B, E and C's shared path --------

# (D, H, K, tails): build_nsf's coupling, the circular coupled model's
# trunk width and bins, a dim-4 coupling (two features), a width that is
# not a multiple of 16 (the tensor-core kernels pad H with zeros), 4 bins
# (P = 11 padded to 16 parameter rows), six features (E's blocks of 4
# warps) and four at H 1024 (E's W_eff in 16 tiles of 64 columns, B's in 4)
BF16_HEAD_SHAPES = [(1, 128, 8, "linear"), (1, 512, 10, "circular"),
                    (2, 64, 8, "linear"), (1, 100, 8, "linear"),
                    (1, 64, 4, "linear"), (6, 32, 10, "circular"),
                    (4, 1024, 10, "circular")]


def _bf16_head_operands(rng, cuda, D, H, K, tails, B):
    bf = torch.bfloat16
    m = (2 * K + (K - 1 if tails == "linear" else K)) * D
    x_t = _normal(rng, (B, D), 1.5).to(cuda, bf).T  # a transposed view
    h_t = _normal(rng, (H, B)).to(cuda, bf)
    w = _normal(rng, (m, H), 0.3 / np.sqrt(H)).to(cuda, bf)
    b = _normal(rng, (m,), 0.1).to(cuda, bf)
    tb = torch.full((D,), 3.0, device=cuda, dtype=bf)
    cty, ctl = (_normal(rng, (D, B)).to(cuda, bf) for _ in range(2))
    return x_t, h_t, w, b, tb, cty, ctl


# the tensor-core head sums against float64's, over sum_j |w_j h_j|: the
# worst measured on the H100 2^-21.9 (torch.matmul's float32 sums 2^-22.1)
MMA_SUMS_TOL = 2.0 ** -20


@pytest.mark.parametrize("B", [65536, 4099])
@pytest.mark.parametrize("shape", BF16_HEAD_SHAPES,
                         ids=lambda s: f"D{s[0]}-H{s[1]}-K{s[2]}-{s[3]}")
def test_bf16_head_kernels_match_their_plain_versions(cuda, shape, B):
    """B and E on bfloat16 operands (B = 4099: rows of h_t that start off
    16 bytes, the kernels' element-load staging) against their plain
    versions, each element of y, ld, gx, gh, gW and gb within one bfloat16
    ulp; bfloat16 out, the bfloat16 launches counted. The plain versions
    run on the kernels' own head sums (``head_params_bf16``, the shared
    tensor-core product alone; ``head_rqs_plain_on_sums``): the tensor
    cores round each k16 step their own way, and where a log-det sits near
    0 or a column near a knot, the last bits of a parameter move y and ld
    by up to 6 bfloat16 ulps and E's gx by up to 338 (the H100, against
    ``torch.matmul``'s sums, whose own distance from float64's is the
    same). The sums themselves are held against float64's."""
    D, H, K, tails = shape
    x_t, h_t, w, b, tb, cty, ctl = _bf16_head_operands(
        np.random.default_rng(200 + H + B % 7), cuda, D, H, K, tails, B)
    sums = tshf.head_params_bf16(h_t, w, feats=D)
    exact = w.double() @ h_t.double()
    scale = (w.double().abs() @ h_t.double().abs()).clamp_min(1e-30)
    assert float(((sums.double() - exact).abs() / scale).max()) \
        <= MMA_SUMS_TOL
    for inverse in (False, True):
        kw = dict(num_bins=K, tails=tails, inverse=inverse)
        before = tops.bf16_launch_counts()
        got = tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=3.0, **kw)
        want = tshf.head_rqs_plain_on_sums(x_t, sums, b, tb, **kw)
        gotb = tshf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty, ctl, **kw)
        wantb = tshf.head_rqs_bwd_plain_on_sums(x_t, h_t, w, b, tb, cty,
                                                ctl, sums, **kw)
        torch.cuda.synchronize()
        after = tops.bf16_launch_counts()
        assert after["head_rqs_fwd"] - before["head_rqs_fwd"] == 1
        assert after["head_rqs_bwd"] - before["head_rqs_bwd"] == 1
        for a, c in zip(got, want):
            assert a.dtype == torch.bfloat16
            assert _bf16_ulps(a, c, False) <= 1.0
        for a, c in zip(gotb, wantb):
            assert a.dtype == torch.bfloat16
            assert _bf16_ulps(a, c, True) <= 1.0


@pytest.mark.parametrize("B", [65536, 4099])
@pytest.mark.parametrize("shape", [(1, 128, 8, "linear"),
                                   (1, 512, 10, "circular"),
                                   (2, 100, 4, "circular")],
                         ids=lambda s: f"D{s[0]}-H{s[1]}-K{s[2]}-{s[3]}")
def test_bf16_head_kernels_are_bitwise_from_call_to_call(cuda, shape, B):
    """Two calls of the bfloat16 B and of E on the same operands give the
    same bits: the tensor-core products run one fixed sequence of
    instructions, and E's gW and gb sum the blocks' float32 partials in a
    fixed order (no atomics)."""
    D, H, K, tails = shape
    x_t, h_t, w, b, tb, cty, ctl = _bf16_head_operands(
        np.random.default_rng(230 + H + B % 7), cuda, D, H, K, tails, B)
    for inverse in (False, True):
        kw = dict(num_bins=K, tails=tails, inverse=inverse)
        calls = [(tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=3.0, **kw),
                  tshf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty, ctl,
                                          **kw)) for _ in range(2)]
        torch.cuda.synchronize()
        for one, two in zip(*(f + g for f, g in calls)):
            assert one.dtype == torch.bfloat16 and torch.equal(one, two)


@pytest.mark.parametrize("B", [65536, 4099])
def test_bf16_shared_path_matches_its_plain_version(cuda, B):
    """Kernel C's shared path on a bfloat16 CDF (x (B, 2), (K, 1, 2)
    parameters, tail bound 3), both directions: gx and the parameter sums
    within one bfloat16 ulp of ``rqs_bwd_shared_plain``, bfloat16 out, the
    bfloat16 shared launch counted."""
    from nf_tpu_torch.ops import splines

    bf = torch.bfloat16
    rng = np.random.default_rng(210 + B % 7)
    x = _normal(rng, (B, 2), 1.5).to(cuda, bf)
    cty, ctl = (_normal(rng, (B, 2)).to(cuda, bf) for _ in range(2))
    uw, uh = (_normal(rng, (8, 1, 2), 0.5).to(cuda, bf) for _ in range(2))
    ud = splines.pad_derivatives(_normal(rng, (7, 1, 2), 0.5).to(cuda, bf),
                                 "linear", 1e-3, axis=0)
    for inverse in (False, True):
        before = tops.bf16_launch_counts()["rqs_bwd_shared"]
        got = tk.rqs_bwd_shared(x, uw, uh, ud, 3.0, cty, ctl,
                                inverse=inverse)
        want = tk.rqs_bwd_shared_plain(x, uw, uh, ud, 3.0, cty, ctl,
                                       inverse=inverse)
        torch.cuda.synchronize()
        assert tops.bf16_launch_counts()["rqs_bwd_shared"] - before == 1
        for a, c in zip(got, want):
            assert a.dtype == bf and _bf16_ulps(a, c, True) <= 1.0


def _bf16_coupled(cuda, hidden=32, couplings=2):
    """``build_nsf(permutation=False)``'s stack in bfloat16 from the
    public layers, perturbed by N(0, 0.1²)."""
    bf = torch.bfloat16
    layers = [nt.flows.CoupledRationalQuadraticSpline(
        num_input_channels=2, num_blocks=2, num_hidden_channels=hidden,
        num_bins=8, tails="linear", tail_bound=3.0,
        reverse_mask=(i % 2 == 1), dtype=bf) for i in range(couplings)]
    model = nt.NormalizingFlow(
        nt.distributions.DiagGaussian(2, trainable=False, dtype=bf), layers)
    rng = np.random.default_rng(220)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(_normal(rng, tuple(p.shape), 0.1).to(p.dtype))
    return model.to(cuda)


def test_bf16_coupled_graphs_launch_only_bf16_kernels(cuda):
    """One captured ``log_prob`` and one captured forward-KLD step of a
    bfloat16 coupled NSF at B*D >= 4096 (kernel B's gate), the graphs'
    kernel nodes read by name: per coupling the bfloat16 B and A, and in
    the step E (and its partials' sum) and C's shared path (its two
    launches), every port kernel a bfloat16 instantiation and no cast
    (``direct_copy_kernel``) among the nodes."""
    chip = _chip_smoke()
    model = _bf16_coupled(cuda)
    x = _normal(np.random.default_rng(221), (8192, 2), 1.5).to(
        cuda, torch.bfloat16)

    def log_prob():
        with torch.inference_mode():
            return model.log_prob(x)

    opt = _adam(model)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt)
    want = {"log_prob": {"rqs_fwd": 2, "head_rqs_fwd": 2},
            "step": {"rqs_fwd": 2, "head_rqs_fwd": 2, "rqs_bwd": 4,
                     "head_rqs_bwd": 4}}
    for what, fn, warm in (("log_prob", log_prob, 1),
                           ("step", lambda: step.eager(state, x), 2)):
        names = chip.captured_kernel_names(fn, warm)
        ours = {}
        for n in names:
            k = chip.kernel_of(n)
            if k is not None:
                assert "__nv_bfloat16" in n, n
                ours[k] = ours.get(k, 0) + 1
        assert ours == want[what], (what, ours)
        assert not [n for n in names if "direct_copy_kernel" in n], what


def test_bf16_coupled_step_runs_the_tensor_core_kernels(cuda):
    """A captured forward-KLD step of a bfloat16 coupled NSF holds the
    tensor-core kernels B and E (``head_rqs_fwd_bf16_kernel``,
    ``head_rqs_bwd_bf16_kernel`` and the partials' sum), one of each per
    coupling, and no launch of the float32 kernels' template."""
    chip = _chip_smoke()
    model = _bf16_coupled(cuda, hidden=128)
    x = _normal(np.random.default_rng(222), (8192, 2), 1.5).to(
        cuda, torch.bfloat16)
    opt = _adam(model)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt)
    names = chip.captured_kernel_names(lambda: step.eager(state, x), 2)
    count = {k: sum(k in n for n in names) for k in (
        "head_rqs_fwd_bf16_kernel", "head_rqs_bwd_bf16_kernel",
        "reduce_partials", "head_rqs_fwd_kernel", "head_rqs_bwd_kernel")}
    assert count == {"head_rqs_fwd_bf16_kernel": 2,
                     "head_rqs_bwd_bf16_kernel": 2, "reduce_partials": 2,
                     "head_rqs_fwd_kernel": 0,
                     "head_rqs_bwd_kernel": 0}, count
