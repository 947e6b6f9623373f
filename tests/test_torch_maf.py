"""The port's MAF (``Permute``, ``MaskedAffineAutoregressive``,
``build_maf``) against the JAX package, on the CPU.

A small ``build_maf`` (dim 2 and 3, K = 2, hidden 16) is built in JAX,
its export perturbed with numpy noise (N(0, 0.05²) on every float array
but the MADE masks, which stay 0/1: a MADE is not zero-initialised, so the
model is off the identity already, and larger noise pushes the scales
``sigmoid(s + 2) + 1e-3`` towards 1e-3, where log-densities of ~1e3 leave
float32 no room for the 1e-4 bar) and loaded into both frameworks; the
MADE head rows come across through ``_head_to_bin_major`` at output
multiplier 2. Inputs come from a numpy seed. Tolerance: 1e-4 abs on
outputs, log-dets and log-densities, and on gradients divided by
``max(max |gradient|, 1)``. ``log_prob`` (the inverse) runs D MADE passes
per layer and ``sample`` one; both are held against JAX.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nf_tpu.models as jmodels
import nf_tpu.parallel as jpar
import nf_tpu_torch as nt
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.flows import MaskedAffineAutoregressive as JMAF
from nf_tpu.flows import Permute as JPermute
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.compat import _head_to_bin_major
from nf_tpu_torch.nets.made import MADE
from test_torch_conditional import jax_fixed, torch_fixed

TOL = 1e-4
SMALL = dict(K=2, hidden=16)
BATCH = 300
_PAIRS = {}


def _perturbed(sd, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if v.dtype.kind == "f" and not k.endswith((".mask", ".degrees")):
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _pair(dim):
    """(JAX model, port model, state dict); fresh port copies each call."""
    if dim not in _PAIRS:
        jmodel = jmodels.build_maf(jax.random.PRNGKey(dim), dim=dim, **SMALL)
        sd = _perturbed(export_state_dict(jmodel), dim)
        _PAIRS[dim] = (import_state_dict(jmodel, sd),
                       nt.load_reference_state_dict(
                           nt.build_maf(dim=dim, device="cpu", **SMALL), sd),
                       sd)
    jmodel, tmodel, sd = _PAIRS[dim]
    return jmodel, copy.deepcopy(tmodel), sd


def _inputs(dim, n=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * 1.5).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _grad_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _port_layout(tmodel, sd):
    heads = {f"{name}.final_layer.": mod.bin_major_head
             for name, mod in tmodel.named_modules()
             if isinstance(mod, MADE) and mod.bin_major_head is not None}
    out = {}
    for name, v in sd.items():
        head = heads.get(name[:name.rfind(".") + 1])
        out[name] = _head_to_bin_major(np.asarray(v), head) if head else \
            np.asarray(v)
    return out


@pytest.mark.parametrize("method", ["forward", "inverse"])
@pytest.mark.parametrize("mode", ["shuffle", "swap"])
@pytest.mark.parametrize("channels", [4, 5])
def test_permute_matches_jax(channels, mode, method):
    jflow = JPermute.create(jax.random.PRNGKey(channels), channels, mode=mode)
    tflow = tflows.Permute(channels, mode=mode)
    sd = export_state_dict(jflow)
    assert set(sd) == ({"perm", "inv_perm"} if mode == "shuffle" else set())
    nt.load_reference_state_dict(tflow, sd)
    x = _inputs(channels, n=16)
    zj, lj = getattr(jflow, method)(jnp.asarray(x))
    zt, lt = getattr(tflow, method)(torch.from_numpy(x))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    back = getattr(tflow, "inverse" if method == "forward" else "forward")(
        zt)[0]
    np.testing.assert_array_equal(back.numpy(), x)


def test_permute_shuffle_is_drawn_from_the_generator():
    a = tflows.Permute(8, generator=torch.Generator().manual_seed(3))
    b = tflows.Permute(8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.perm, b.perm)
    assert torch.equal(a.perm[a.inv_perm], torch.arange(8))


@pytest.mark.parametrize("bin_major", [True, False])
@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_masked_affine_autoregressive_matches_jax(method, bin_major):
    """One MAF layer both ways, with the bin-major head (the default:
    scale and shift are contiguous planes) and the feature-major one."""
    jlayer = JMAF.create(jax.random.PRNGKey(4), features=3,
                         hidden_features=16, bin_major_head=bin_major)
    sd = _perturbed(export_state_dict(jlayer), 4)
    jlayer = import_state_dict(jlayer, sd)
    tlayer = nt.load_reference_state_dict(
        tflows.MaskedAffineAutoregressive(3, 16, bin_major_head=bin_major),
        sd)
    x = _inputs(3, seed=5)
    zj, lj = getattr(jlayer, method)(jnp.asarray(x))
    with torch.no_grad():
        zt, lt = getattr(tlayer, method)(torch.from_numpy(x))
    _close(zt, zj)
    _close(lt, lj)
    with torch.no_grad():
        other = "inverse" if method == "forward" else "forward"
        back, lb = getattr(tlayer, other)(zt)
    _close(back, x)
    _close(lb, -lt)


def test_inverse_runs_one_made_pass_per_feature_and_forward_one():
    """The density direction (``inverse``) is D sequential MADE passes,
    the sampling direction (``forward``) one."""
    layer = tflows.MaskedAffineAutoregressive(3, 16)
    calls = []
    layer.autoregressive_net.register_forward_hook(
        lambda *args: calls.append(1))
    x = torch.from_numpy(_inputs(3, n=8))
    with torch.no_grad():
        layer.inverse(x)
        assert len(calls) == 3
        layer.forward(x)
    assert len(calls) == 4


@pytest.mark.parametrize("method", ["log_prob", "inverse_and_log_det",
                                    "forward_and_log_det"])
@pytest.mark.parametrize("dim", [2, 3])
def test_build_maf_matches_jax(dim, method):
    jmodel, tmodel, _ = _pair(dim)
    x = _inputs(dim, seed=6)
    want = getattr(jmodel, method)(jnp.asarray(x))
    with torch.no_grad():
        got = getattr(tmodel, method)(torch.from_numpy(x))
    if method == "log_prob":
        got, want = (None, got), (None, want)
    else:
        _close(got[0], want[0])
        assert float(np.abs(np.asarray(want[0]) - x).max()) > 0.1
    _close(got[1], want[1])


def test_sample_log_q_matches_jax_on_shared_draws():
    jmodel, tmodel, _ = _pair(2)
    eps = np.random.default_rng(7).standard_normal((BATCH, 2)).astype(
        np.float32)
    zj, lqj = jax_fixed(jmodel, eps, None).sample(jax.random.PRNGKey(0),
                                                  BATCH)
    with torch.no_grad():
        z, log_q = torch_fixed(tmodel, eps, None).sample(BATCH)
        lp = tmodel.log_prob(z)
    _close(z, zj)
    _close(log_q, lqj)
    _close(lp, log_q)


def test_forward_kld_gradients_match_jax():
    jmodel, tmodel, _ = _pair(3)
    x = _inputs(3, seed=8)
    params, static = partition(jmodel)
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).forward_kld(jnp.asarray(x))))(params)
    want = _port_layout(tmodel, export_state_dict(combine(grads, static)))
    loss_t = tmodel.forward_kld(torch.from_numpy(x))
    loss_t.backward()
    _close(float(loss_t.detach()), float(loss_j))
    named = dict(tmodel.named_parameters())
    assert named
    for name, p in named.items():
        assert p.grad is not None, name
        _grad_close(p.grad, want[name])


def test_forward_kld_steps_match_optax():
    """Two SGD steps of ``make_forward_kld_step`` against the JAX step
    with ``optax.sgd``, on TwoMoons-sized batches of numpy data."""
    lr = 0.05
    jmodel, tmodel, _ = _pair(2)
    batches = [_inputs(2, seed=s) for s in (9, 10)]
    jopt = optax.sgd(lr)
    jstate, static = jpar.init_train_state(jmodel, jopt)
    jstep = jpar.make_forward_kld_step(static, jopt)
    topt = torch.optim.SGD(tmodel.parameters(), lr=lr)
    tstate = nt.init_train_state(tmodel, topt)
    tstep = nt.make_forward_kld_step(topt)
    for x in batches:
        jstate, loss_j = jstep(jstate, jnp.asarray(x))
        loss_t = tstep(tstate, torch.from_numpy(x))
        _close(float(loss_t), float(loss_j))
    want = _port_layout(tmodel, export_state_dict(
        jpar.model_of_state(jstate, static)))
    for name, p in tmodel.named_parameters():
        _close(p.detach().numpy(), want[name])


def test_builder_defaults():
    m = nt.build_maf(device="cpu")
    assert len(m.flows) == 16
    assert isinstance(m.flows[0], tflows.MaskedAffineAutoregressive)
    assert isinstance(m.flows[1], tflows.Permute)
    made = m.flows[0].autoregressive_net
    assert made.bin_major_head == (2, 2) and len(made.blocks) == 2
    assert made.initial_layer.weight.shape == (64, 2)
    mixed = nt.build_maf(device="cpu", mixed_precision=True)
    assert isinstance(mixed.flows[0].autoregressive_net, nt.MixedPrecision)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nt.build_maf()
