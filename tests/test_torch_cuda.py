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

import numpy as np
import pytest
import torch

import nf_tpu_torch as nt
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


@pytest.mark.parametrize("tb_kind", ["float", "one_element_tensor"])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_a_broadcast_parameters(cuda, inverse, tb_kind):
    """The unconditional CDF's call: (1, D, K) parameters, stride 0 over the
    batch, a transposed input; the tail bound as a float or as a
    one-element CUDA tensor (read in the kernel with stride 0)."""
    rng = np.random.default_rng(1)
    K, D, B = 8, 2, 5000
    x = _normal(rng, (D, B), 2.0).to(cuda).T
    uw, uh = (_normal(rng, (1, D, K), 0.5).to(cuda) for _ in range(2))
    ud = _normal(rng, (1, D, K + 1), 0.5).to(cuda)
    tb = 3.0 if tb_kind == "float" else torch.full((1, 1), 3.0, device=cuda)
    y, ld = tk.fused_unconstrained_rqs(x, uw, uh, ud, tb, inverse=inverse)
    w, h, d = (t.expand(B, D, t.shape[-1]).movedim(-1, 0)
               for t in (uw, uh, ud))
    yp, lp = tk.rqs_plain(x, w, h, d, 3.0, inverse=inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)


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
    runs once, and autograd's sum of its planes matches the plain
    version's autograd."""
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


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("K", tk.SUPPORTED_BINS)
def test_kernel_b_matches_plain(cuda, K, tails, inverse):
    rng = np.random.default_rng(K)
    D, B, H = 4, 65536 + 77, 128
    m = (2 * K + (K - 1 if tails == "linear" else K)) * D
    x_t = _normal(rng, (D, B), 2.0).to(cuda)
    h_t = _normal(rng, (H, B)).to(cuda)
    w = _normal(rng, (m, H), 0.3 / np.sqrt(H)).to(cuda)
    b = _normal(rng, (m,), 0.1).to(cuda)
    tb = torch.tensor([1.5, 2.0, 2.5, 3.0], device=cuda)
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    y, ld = tshf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw)
    yp, lp = tshf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld, lp, atol=LD_TOL, rtol=0)


# kernel E's shapes: (D, H, B, strided), where strided takes x_t and cty as
# transposed (B, D) views, the layout a coupling passes. The first is the
# parity layout of the other kernels; the rest are the edges of E's tiling:
# H below, at and above its 128-column W_eff tile and not a multiple of 16,
# B of one column and one either side of its 256-column block, and, at
# K = 10 with circular tails and D = 4, its most head rows (M = 120).
E_SHAPES = [(4, 128, 65536 + 77, False), (1, 128, 65536, True),
            (1, 16, 1, False), (4, 100, 255, True), (1, 512, 257, False),
            (4, 512, 65536 + 77, True)]
E_COMBOS = [(K, tails, inverse) for K in tk.SUPPORTED_BINS
            for tails in ("linear", "circular") for inverse in (False, True)]
# The cases where gx under normal draws differs from head_rqs_bwd_plain's
# by more than G_TOL on the H100 (up to 9e-4): the plain version's
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
                 + [(10, "circular", True, E_SHAPES[4])])


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
