"""The residual flows' fixed-point loop against JAX's ``lax.while_loop``,
on the CPU: its condition (``flows.residual.fixed_point_go``, kernel F's
plain version) against JAX's ``cond`` on edge planes, kernel F's plain
version through its op, and both solves, ``x = y - g(x)`` and the implicit
VJP, at a block that needs far more than 32 passes, against JAX's
``_fp_inverse``.

The block: ``LipschitzMLP([2, 16, 16, 2], lipschitz_const=0.99)`` whose
layers are set in closed form (``chip_smoke.stiff_layers``, phase 18's
stiff model at a smaller width: each dense layer
0.99 times an identity block, the hidden biases placing the two active
channels at Swish's steepest point) plus N(0, 0.01²) numpy noise, its
power iterations advanced 200 steps. Near that point each pass shrinks
the error by about 0.99^3, so the solves take about a hundred passes,
where random weights take a few. The same weights cross to the port
through ``test_torch_residual.residual_state_dict``. Tolerances: 1e-4 abs
on the solution; gradients 1e-4 after dividing by max(max |gradient|, 1)
(``test_torch_residual``'s bars); the counts equal JAX's. The captured
loop (a WHILE node and kernel F) runs only on the card:
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
from nf_tpu.flows.residual import _fp_inverse
from nf_tpu.nets import LipschitzMLP as JLipschitzMLP
from nf_tpu.nets.lipschitz import Swish as JSwish
from nf_tpu.utils import update_lipschitz as jupdate_lipschitz
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.flows import residual as tres
from nf_tpu_torch.nets import LipschitzMLP
from nf_tpu_torch.ops import fixed_point as tfp
from test_torch_residual import (_close, _inputs, _load, _param_grads,
                                 _rel_close, _t, residual_state_dict)

DIMS = [2, 16, 16, 2]
L = 0.99
BATCH = 64
OLD_FIXED_COUNT = 32  # the masked count a captured solve used to run
NOISE = 0.01  # on the stiff net's closed-form weights


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module: the stiff
    weights and the edge planes are its phase 18's and kernel F's."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _stiff_pair(seed):
    """A JAX ``Residual`` over the stiff net and the port's with the same
    weights: (JAX iResBlock, port iResBlock)."""
    jnet = JLipschitzMLP.create(jax.random.PRNGKey(seed), DIMS,
                                lipschitz_const=L)
    layers, dense = [], iter(CS.stiff_layers(DIMS, L, seed, NOISE))
    for layer in jnet.layers:
        if not isinstance(layer, JSwish):
            w, b = next(dense)
            layer = layer.replace(weight=jnp.asarray(w), bias=jnp.asarray(b))
        layers.append(layer)
    jflow = jflows.Residual.create(jnet.replace(layers=tuple(layers)),
                                   reduce_memory=False)
    jflow = jupdate_lipschitz(jflow, 200)
    tflow = _load(tflows.Residual(LipschitzMLP(DIMS, lipschitz_const=L),
                                  reduce_memory=False),
                  residual_state_dict(jflow))
    return jflow.iresblock, tflow.iresblock


def _jax_counts(jblock, y, u):
    """JAX's passes of the two loops of ``_fp_inverse`` (its ``cond`` and
    ``body``, ``nf_tpu/flows/residual.py:42-58`` and ``:71-97``, counted):
    the solve from ``y`` and the implicit VJP's from the cotangent ``u``."""
    def loop(step, start, first, tol):
        def cond(state):
            x, x_prev, i = state
            not_conv = jnp.any((x - x_prev) ** 2 / tol >= 1)
            return jnp.logical_and(not_conv, i <= 1000)

        def body(state):
            x, _, i = state
            return step(x), x, i + 1

        return jax.lax.while_loop(cond, body, (first, start, 0))

    x, _, n_fwd = loop(lambda x: y - jblock.nnet(x), y,
                       y - jblock.nnet(y), 1e-5 + jnp.abs(y) * 1e-5)
    _, vjp_fn = jax.vjp(jblock.nnet, x)
    _, _, n_vjp = loop(lambda v: u - vjp_fn(v)[0], u, u - vjp_fn(u)[0],
                       1e-6 + jnp.abs(u) * 1e-6)
    return int(n_fwd), int(n_vjp)


@pytest.mark.parametrize("seed", [0, 1])
def test_both_solves_match_jax_past_the_old_fixed_count(seed):
    """The inverse, the cotangent of y and the net's gradients against
    JAX's ``_fp_inverse`` at a block whose solves take over 32 passes; the
    port's counts are JAX's and no flag is set."""
    jblock, tblock = _stiff_pair(seed)
    y = _inputs((BATCH, 2), seed=seed + 50, scale=1.5)

    def jloss(b, yy):
        x = _fp_inverse(b, yy)
        return jnp.sum(jnp.sin(x) * x), x

    (_, x), (jg_block, jg_y) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jblock, jnp.asarray(y))
    yt = _t(y).requires_grad_(True)
    xt = tblock.inverse(yt)
    torch.sum(torch.sin(xt) * xt).backward()
    _close(xt, x)
    _rel_close(yt.grad, jg_y)
    for want, got in _param_grads(jg_block, tblock):
        _rel_close(got, want)
    (it, vjp_it, unconverged), = tflows.fixed_point_stats(tblock)
    u = np.asarray(jnp.sin(x) + x * jnp.cos(x))  # the loss's cotangent
    assert (it, vjp_it) == _jax_counts(jblock, jnp.asarray(y),
                                       jnp.asarray(u))
    assert it > OLD_FIXED_COUNT and vjp_it > OLD_FIXED_COUNT
    assert not unconverged


def _jax_go(x, x_prev, tol, count):
    """JAX's ``cond`` (``nf_tpu/flows/residual.py:47-50``) on numpy
    planes."""
    not_conv = jnp.any((jnp.asarray(x) - jnp.asarray(x_prev)) ** 2
                       / jnp.asarray(tol) >= 1)
    return bool(jnp.logical_and(not_conv, count <= 1000))


EDGE_CASES = list(CS.F_EDGE_CASES)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fixed_point_go_is_jax_cond_on_edge_planes(case):
    x, x_prev, tol, count = CS.edge_planes(case)
    got = tres.fixed_point_go(*map(torch.from_numpy, (x, x_prev, tol)),
                              torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == _jax_go(x, x_prev, tol, count) \
        == CS.F_EXPECTED_GO[case]


@pytest.mark.parametrize("case", ["threshold", "nan", "cap", "empty"])
def test_kernel_f_plain_version_counts_and_tests(case):
    """Kernel F's op on CPU tensors (its plain version): the count set to
    0, then incremented, ``state[2]`` the test at that count, the flag and
    ticket slots left at zero."""
    *planes, start = CS.edge_planes(case)
    x, x_prev, tol = map(torch.from_numpy, planes)
    count = torch.zeros((), dtype=torch.int32)
    state = torch.zeros(3, dtype=torch.int32)
    before = tfp.fixed_point_cond.launches
    tfp.fixed_point_cond(x, x_prev, tol, count, state, False)
    assert int(count) == 0
    assert bool(state[2]) == _jax_go(x.numpy(), x_prev.numpy(),
                                     tol.numpy(), 0)
    count.fill_(start - 1)
    tfp.fixed_point_cond(x, x_prev, tol, count, state, True)
    assert int(count) == start
    assert bool(state[2]) == CS.F_EXPECTED_GO[case]
    assert state[:2].tolist() == [0, 0]
    assert tfp.fixed_point_cond.launches == before  # the CPU launches none


def test_loop_stops_at_jax_cap_still_moving():
    """A body that never settles (``x <- -x``) stops at JAX's count, 1001
    passes, with the block's flag meaning "stopped at the cap"."""
    x0 = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)

    def cond(state):
        x, x_prev, i = state
        return jnp.logical_and(jnp.any((x - x_prev) ** 2 / 1e-5 >= 1),
                               i <= 1000)

    _, _, n_jax = jax.lax.while_loop(
        cond, lambda s: (-s[0], s[0], s[2] + 1),
        (jnp.asarray(-x0), jnp.asarray(x0), 0))
    count = torch.zeros((), dtype=torch.int32)
    x, unconverged = tres._iterate(lambda x: -x, torch.from_numpy(-x0),
                                   torch.from_numpy(x0),
                                   torch.full((2, 2), 1e-5), count)
    assert int(count) == int(n_jax) == tres.FIXED_POINT_MAX_ITER + 1
    assert bool(unconverged)
    assert torch.equal(x, torch.from_numpy(x0 if int(n_jax) % 2 else -x0))


def test_the_masked_fixed_count_is_gone():
    """Under a capture the loop is a WHILE node: no fixed count of masked
    passes is left for a captured solve to fall short of."""
    assert not hasattr(tres, "FIXED_POINT_GRAPH_ITERATIONS")
    assert tres.FIXED_POINT_MAX_ITER == tfp.MAX_COUNT == 1000
