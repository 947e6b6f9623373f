"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA inputs, and the model on CUDA against the model
on the CPU.

This file imports neither JAX nor ``nf_tpu``, so it runs on a machine that
has only PyTorch and the CUDA toolkit, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips. Tolerances: 1e-5 abs on spline outputs
and 1e-4 abs on log-dets (the JAX package's bar for its kernels); 1e-3 abs
on a whole model's log-density, where the card's matrix products sum in
another order than the CPU's.
"""

import numpy as np
import pytest
import torch

import nf_tpu_torch as nt
from nf_tpu_torch.ops import spline_head_fused as tshf
from nf_tpu_torch.ops import splines_kernel as tk

pytestmark = pytest.mark.cuda

Y_TOL, LD_TOL, MODEL_TOL = 1e-5, 1e-4, 1e-3


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


def test_kernel_a_refuses_gradients(cuda):
    x = torch.zeros(16, device=cuda, requires_grad=True)
    w = torch.zeros(8, 16, device=cuda)
    d = torch.zeros(9, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        tk.rqs_fwd(x, w, w, d, 1.0, inverse=False)


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
    with torch.inference_mode():
        lp = gpu_model.log_prob(x.to(cuda))
        torch.cuda.synchronize()
        want = cpu_model.log_prob(x)
    assert tk.rqs_fwd.launches == 2
    assert tshf.fused_head_rqs.launches == 2
    torch.testing.assert_close(lp.cpu(), want, atol=MODEL_TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="training slice"):
        gpu_model.forward_kld(x.to(cuda))
