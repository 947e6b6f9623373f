"""The port's fused head + spline (``nf_tpu_torch.ops.spline_head_fused``)
against the JAX package's ``fused_head_rqs`` in interpret mode.

Inputs are drawn with numpy from a seed, as ``tests/test_fused_head.py``
draws them (head weight ~ N(0, (0.3/sqrt(H))²), bias ~ N(0, 0.1²)), with
B = 300 so the batch is not a multiple of any block. Tolerances are that
file's: 1e-5 abs on outputs, 1e-4 abs on log-dets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu_torch.flows.neural_spline.feed import kmajor_spline_feed
from nf_tpu_torch.nets import ResidualNet
from nf_tpu_torch.ops import spline_head_fused as tshf

Y_TOL, LD_TOL = 1e-5, 1e-4
D, B, H, K = 4, 300, 16, 4


def _mk(seed, tails, batch=B, hidden=H, num_bins=K, feats=D):
    rng = np.random.default_rng(seed)
    nd = num_bins - 1 if tails == "linear" else num_bins
    m = (2 * num_bins + nd) * feats
    x_t = (rng.standard_normal((feats, batch)) * 2.0).astype(np.float32)
    h_t = rng.standard_normal((hidden, batch)).astype(np.float32)
    w = (rng.standard_normal((m, hidden)) * (0.3 / np.sqrt(hidden))) \
        .astype(np.float32)
    b = (rng.standard_normal(m) * 0.1).astype(np.float32)
    return x_t, h_t, w, b


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("tb_kind", ["scalar", "per_feature"])
def test_plain_fused_head_matches_pallas(tails, inverse, tb_kind):
    x_t, h_t, w, b = _mk(0, tails)
    tb = (2.5 if tb_kind == "scalar"
          else np.asarray([1.5, 2.0, 2.5, 3.0], np.float32))
    yj, lj = jshf.fused_head_rqs(
        jnp.asarray(x_t), jnp.asarray(h_t), jnp.asarray(w), jnp.asarray(b),
        num_bins=K, tails=tails, tail_bound=jnp.asarray(tb),
        inverse=inverse, interpret=True)
    yt, lt = tshf.fused_head_rqs(
        *(torch.from_numpy(a) for a in (x_t, h_t, w, b)), num_bins=K,
        tails=tails, tail_bound=torch.as_tensor(tb), inverse=inverse)
    _close(yt, yj, Y_TOL)
    _close(lt, lj, LD_TOL)


@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_effective_head_matches_jax(tails, scale):
    _, _, w, b = _mk(1, tails)
    wj, bj = jshf.effective_head(jnp.asarray(w), jnp.asarray(b),
                                 num_bins=K, feats=D, tails=tails,
                                 softmax_scale=scale)
    wt, bt = tshf.effective_head(torch.from_numpy(w), torch.from_numpy(b),
                                 num_bins=K, feats=D, tails=tails,
                                 softmax_scale=scale)
    _close(wt, wj, 0.0)
    _close(bt, bj, 0.0)


@pytest.mark.parametrize("tails", ["linear", "circular"])
def test_fused_head_matches_the_unfused_feed(tails):
    """Kernel B's plain version against the port's own unfused path (head
    product, then the k-major spline feed), softmax scale folded in by
    ``effective_head`` on one side and applied to the planes on the
    other."""
    x_t, h_t, w, b = _mk(2, tails)
    scale = 1.0 / np.sqrt(H)
    xt, ht, wt, bt = (torch.from_numpy(a) for a in (x_t, h_t, w, b))
    w_eff, b_eff = tshf.effective_head(wt, bt, num_bins=K, feats=D,
                                       tails=tails, softmax_scale=scale)
    y_f, ld_f = tshf.fused_head_rqs(xt, ht, w_eff, b_eff, num_bins=K,
                                    tails=tails, tail_bound=2.5)
    planes = (wt @ ht + bt[:, None]).reshape(-1, D, B)
    y_u, ld_u = kmajor_spline_feed(
        xt.T, planes, num_bins=K, tails=tails, tail_bound=2.5,
        tail_bound_arr=None, softmax_scale=scale, inverse=False,
        min_bin_width=1e-3, min_bin_height=1e-3, min_derivative=1e-3)
    torch.testing.assert_close(y_f.T, y_u, atol=Y_TOL, rtol=0)
    torch.testing.assert_close(ld_f.sum(0), ld_u, atol=LD_TOL, rtol=0)


def test_build_d_list_edges():
    planes = [torch.full((2, 3), float(i)) for i in range(3)]
    lin = tshf._build_d_list(planes, planes[0], "linear", 1e-3)
    circ = tshf._build_d_list(planes, planes[0], "circular", 1e-3)
    edge = float(np.log(np.exp(1 - 1e-3) - 1))
    assert len(lin) == 5 and len(circ) == 4
    assert torch.all(lin[0] == edge) and torch.all(lin[-1] == edge)
    assert circ[-1] is planes[0]


def test_transposed_trunk_matches_batch_major():
    gen = torch.Generator().manual_seed(3)
    net = ResidualNet(3, 44, 32, context_features=5, num_blocks=2,
                      bin_major_head=(4, 11), generator=gen)
    x = torch.randn(64, 3, generator=gen)
    c = torch.randn(64, 5, generator=gen)
    want = net(x, c)
    got = net.final_layer.matmul_t(net.features_transposed(x, c))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_fused_head_rejects_mixed_tails():
    x_t, h_t, w, b = (torch.from_numpy(a) for a in _mk(4, "linear"))
    with pytest.raises(ValueError, match="homogeneous"):
        tshf.fused_head_rqs(x_t, h_t, w, b, num_bins=K,
                            tails=["linear", "circular"])

