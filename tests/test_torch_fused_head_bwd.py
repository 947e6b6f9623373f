"""Kernel E's plain version (``nf_tpu_torch.ops.spline_head_fused.
head_rqs_bwd_plain``) against the JAX package's fused head backward.

The JAX side is ``jax.vjp`` of ``spline_head_fused.fused_head_rqs(...,
interpret=True)``, whose custom VJP runs the Pallas kernel
``_head_bwd_kernel`` (the body kernel E ports) in interpret mode. Inputs
are drawn with numpy from a seed as ``tests/test_fused_head.py`` draws them
(head weight ~ N(0, (0.3/sqrt(H))²), bias ~ N(0, 0.1²), x ~ N(0, 2²)),
cotangents ~ N(0, 1), B = 300 (not a multiple of any block), H = 16.
Tolerance: the JAX package's gradient bar, 1e-4 abs on each gradient
divided by ``max(max |gradient|, 1)`` (``tests/test_splines_pallas.py:
140-145``); gW and gb are sums over the batch, taken in another order.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu_torch.ops import spline_head_fused as tshf

G_TOL = 1e-4
D, B, H = 4, 300, 16


def _mk(seed, tails, K):
    rng = np.random.default_rng(seed)
    nd = K - 1 if tails == "linear" else K
    m = (2 * K + nd) * D
    x_t = (rng.standard_normal((D, B)) * 2.0).astype(np.float32)
    h_t = rng.standard_normal((H, B)).astype(np.float32)
    w = (rng.standard_normal((m, H)) * (0.3 / np.sqrt(H))).astype(np.float32)
    b = (rng.standard_normal(m) * 0.1).astype(np.float32)
    cty = rng.standard_normal((D, B)).astype(np.float32)
    ctl = rng.standard_normal((D, B)).astype(np.float32)
    return x_t, h_t, w, b, cty, ctl


def _close(got, want, tol=G_TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


TB = np.asarray([1.5, 2.0, 2.5, 3.0], np.float32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("K", [4, 8])
def test_head_bwd_plain_matches_pallas_vjp(K, tails, inverse):
    x_t, h_t, w, b, cty, ctl = _mk(K, tails, K)
    fn = lambda *a: jshf.fused_head_rqs(  # noqa: E731
        *a, num_bins=K, tails=tails, tail_bound=jnp.asarray(TB),
        inverse=inverse, interpret=True)
    want = jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(
        tuple(jnp.asarray(a) for a in (x_t, h_t, w, b)),
        (jnp.asarray(cty), jnp.asarray(ctl)))
    got = tshf.head_rqs_bwd_plain(
        *(torch.from_numpy(a) for a in (x_t, h_t, w, b)),
        torch.from_numpy(TB), torch.from_numpy(cty), torch.from_numpy(ctl),
        num_bins=K, tails=tails, inverse=inverse)
    for name, g, wnt in zip(("gx", "gh", "gW", "gb"), got, want):
        assert tuple(g.shape) == tuple(wnt.shape), name
        _close(g, wnt)


@pytest.mark.parametrize("tails", ["linear", "circular"])
def test_head_bwd_plain_matches_autograd_of_the_forward(tails):
    """The fold of the derivative cotangents into head rows, against
    PyTorch's autograd of kernel B's plain version."""
    K = 4
    arrs = [torch.from_numpy(a) for a in _mk(7, tails, K)]
    x_t, h_t, w, b, cty, ctl = arrs
    tb = torch.from_numpy(TB)
    leaves = [t.clone().requires_grad_() for t in (x_t, h_t, w, b)]
    y, ld = tshf.head_rqs_plain(*leaves, tb, num_bins=K, tails=tails,
                                inverse=False)
    want = torch.autograd.grad((y * cty).sum() + (ld * ctl).sum(), leaves)
    got = tshf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty, ctl, num_bins=K,
                                  tails=tails, inverse=False)
    for g, a in zip(got, want):
        _close(g, a)


def test_kernel_e_wrapper_takes_only_cuda_tensors():
    x_t, h_t, w, b, cty, ctl = (torch.from_numpy(a)
                                for a in _mk(8, "linear", 4))
    with pytest.raises(ValueError, match="CUDA"):
        tshf.fused_head_rqs_bwd(x_t, h_t, w, b, torch.from_numpy(TB), cty,
                                ctl, num_bins=4, tails="linear",
                                inverse=False)
    tshf.fused_head_rqs_bwd.launches = 0
    leaves = [t.requires_grad_() for t in (x_t, h_t, w, b)]
    y, ld = tshf.fused_head_rqs(*leaves, num_bins=4, tails="linear",
                                tail_bound=torch.from_numpy(TB))
    (y.sum() + ld.sum()).backward()  # the CPU path: plain autograd
    assert tshf.fused_head_rqs_bwd.launches == 0
    assert all(t.grad is not None for t in leaves)


def test_kernel_e_block_constants_match_the_cuda_source():
    """The wrapper sizes kernel E's workspace (one row per block of
    ``_E_THREADS`` columns) and checks its shared memory from constants
    that must equal the ``constexpr``s of ``csrc/head_rqs_bwd.cu``; at the
    training shapes (M = 23, H = 128) a block stays under the 48 KB it
    gets without opting in."""
    src = (Path(tshf.__file__).parent.parent / "csrc"
           / "head_rqs_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kChunk"]),
            int(consts["kTile"])) == (tshf._E_THREADS, tshf._E_CHUNK,
                                      tshf._E_TILE)
    assert tshf.kernel_e_shared_bytes(23, 128) < 48 * 1024
