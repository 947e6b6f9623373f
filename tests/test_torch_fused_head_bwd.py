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


def _plain_against_pallas_vjp(plain, K, tails, inverse):
    x_t, h_t, w, b, cty, ctl = _mk(K, tails, K)
    fn = lambda *a: jshf.fused_head_rqs(  # noqa: E731
        *a, num_bins=K, tails=tails, tail_bound=jnp.asarray(TB),
        inverse=inverse, interpret=True)
    want = jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(
        tuple(jnp.asarray(a) for a in (x_t, h_t, w, b)),
        (jnp.asarray(cty), jnp.asarray(ctl)))
    got = plain(
        *(torch.from_numpy(a) for a in (x_t, h_t, w, b)),
        torch.from_numpy(TB), torch.from_numpy(cty), torch.from_numpy(ctl),
        num_bins=K, tails=tails, inverse=inverse)
    for name, g, wnt in zip(("gx", "gh", "gW", "gb"), got, want):
        assert tuple(g.shape) == tuple(wnt.shape), name
        _close(g, wnt)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("K", [4, 8])
def test_head_bwd_plain_matches_pallas_vjp(K, tails, inverse):
    _plain_against_pallas_vjp(tshf.head_rqs_bwd_plain, K, tails, inverse)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("K", [4, 8])
def test_head_bwd_plain_in_kernel_order_matches_pallas_vjp(K, tails,
                                                           inverse):
    """The plain version that sums the head product in kernel E's order
    (the card tests' yardstick where torch.matmul's order moves gx) holds
    the same bar against the Pallas kernel."""
    _plain_against_pallas_vjp(tshf.head_rqs_bwd_plain_in_kernel_order, K,
                              tails, inverse)


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
    training shapes (M = 23, D = 1, H = 128) two blocks fit in an H100 SM's
    228 KB of shared memory (each also holds 1 KB for the system), as its
    ``__launch_bounds__(256, 2)`` asks."""
    src = (Path(tshf.__file__).parent.parent / "csrc"
           / "head_rqs_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    names = ("kThreads", "kColPad", "kJ", "kG", "kChunk", "kRowPad",
             "kTileM", "kTileJ", "kMaxSharedBytes")
    assert tuple(int(consts[n]) for n in names) == (
        tshf._E_THREADS, tshf._E_COL_PAD, tshf._E_WTILE, tshf._E_GH_ROWS,
        tshf._E_CHUNK, tshf._E_ROW_PAD, tshf._E_TILE_M, tshf._E_TILE_J,
        tshf._MAX_SHARED_BYTES)
    assert 2 * (tshf.kernel_e_shared_bytes(23, 1, 128) + 1024) <= 228 * 1024


@pytest.mark.parametrize("tails", ["linear", "circular"])
@pytest.mark.parametrize("K", [4, 8, 10])
def test_kernel_e_shared_memory_admits_every_supported_shape(K, tails):
    """Kernel E takes D from 1 to 4 and hidden widths from 16 to 512 (up
    to M = 120 head rows at K = 10, circular, D = 4) within the H100's
    shared memory per block."""
    nd = K - 1 if tails == "linear" else K
    for feats in range(1, 5):
        m = (2 * K + nd) * feats
        for hidden in range(16, 513):
            assert tshf.kernel_e_shared_bytes(m, feats, hidden) \
                <= tshf._MAX_SHARED_BYTES, (feats, hidden)


def _e_operands(feats, hidden, m, batch=8):
    z = torch.zeros
    return (z(feats, batch), z(hidden, batch), z(m, hidden), z(m),
            z(feats), z(feats, batch), z(feats, batch))


@pytest.mark.parametrize("case", ["shared_memory", "bins", "rows"])
def test_kernel_e_launch_raises_on_shapes_it_does_not_take(case):
    """Kernel E's launch checks the shape before it builds or launches
    anything: above its shared memory (M = 120 at hidden 1024), at a bin
    count without an instantiation, or with a head of the wrong height,
    it raises."""
    K, tails, feats, hidden, m = {
        "shared_memory": (10, "circular", 4, 1024, 120),
        "bins": (5, "linear", 1, 16, 14),
        "rows": (4, "linear", 2, 16, 24),
    }[case]
    if case == "shared_memory":
        assert tshf.kernel_e_shared_bytes(m, feats, hidden) \
            > tshf._MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="kernel E"):
        tshf._launch_bwd(*_e_operands(feats, hidden, m), num_bins=K,
                         tails=tails, inverse=False, mbw=1e-3, mbh=1e-3,
                         md=1e-3)


@pytest.mark.parametrize("K", [4, 8, 10])
def test_kernel_e_builds_one_library_per_bin_count(K):
    """Kernel E's wrapper loads ``head_rqs_bwd@K``: the same source built
    with ``-DNF_BINS=K``, whose launcher instantiates that bin count alone,
    under a file name of its own."""
    from nf_tpu_torch.ops import _build

    source, flags = _build._flags(f"head_rqs_bwd@{K}")
    assert source == "head_rqs_bwd" and flags[-1] == f"-DNF_BINS={K}"
    assert _build._flags("head_rqs_bwd") == ("head_rqs_bwd",
                                             _build.NVCC_FLAGS)
    paths = {_build._lib_path(f"head_rqs_bwd@{k}") for k in (4, 8, 10)}
    assert len(paths | {_build._lib_path("head_rqs_bwd")}) == 4
    src = (Path(tshf.__file__).parent.parent / "csrc"
           / "head_rqs_bwd.cu").read_text()
    assert f"#if !defined(NF_BINS) || NF_BINS == {K}\n" \
           f"    NF_HEAD_BWD_CASE({K})\n#endif" in src
