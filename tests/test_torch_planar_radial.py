"""The port's planar and radial flows (``Planar``, ``Radial``,
``build_planar_stack``, ``build_radial_stack``) against the JAX package,
on the CPU.

The JAX modules' trainable arrays get numpy noise N(0, 0.3²), cross to
the port through ``nf_tpu.compat_export.export_state_dict`` and
``load_reference_state_dict``, and both frameworks see the same numpy
inputs; sampling is compared as the push-forward of the same base noise
(the draws themselves differ between JAX keys and torch generators).
Tolerance 1e-4 abs on outputs, log-dets and losses; gradients 1e-4 after
dividing by max(max |gradient|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import NormalizingFlow as JNormalizingFlow
from nf_tpu.distributions import DiagGaussian as JDiagGaussian
from nf_tpu.distributions import TwoModes as JTwoModes
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.distributions.base import _gaussian_sample

TOL = 1e-4
BATCH = 128
K = 4


def perturb(jmodule, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    params, static = partition(jmodule)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(scale * rng.standard_normal(a.shape),
                                  a.dtype), params)
    return combine(params, static)


def _state_dict(jmodule):
    return {k: np.asarray(v) for k, v in export_state_dict(jmodule).items()}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return np.asarray(a.detach() if torch.is_tensor(a) else a)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _rel_close(got, want, tol=TOL):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    assert float(np.max(np.abs(got - want))) \
        / max(float(np.max(np.abs(want))), 1.0) <= tol


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _layer_pair(kind, act="tanh", seed=0):
    key = jax.random.PRNGKey(seed)
    if kind == "planar":
        jf = perturb(jflows.Planar.create(key, (2,), act=act), seed)
        tf = tflows.Planar((2,), act=act)
    else:
        jf = perturb(jflows.Radial.create(key, (2,)), seed)
        tf = tflows.Radial((2,))
    tf.load_state_dict({k: _t(v) for k, v in _state_dict(jf).items()})
    return jf, tf


@pytest.mark.parametrize("kind,act", [("planar", "tanh"),
                                      ("planar", "leaky_relu"),
                                      ("radial", None)])
def test_layer_matches_jax(kind, act):
    jf, tf = _layer_pair(kind, act or "tanh", seed=1)
    z = _inputs((BATCH, 2), seed=2)
    zj, ldj = jf.forward(jnp.asarray(z))
    zt, ldt = tf.forward(_t(z))
    _close(zt, zj)
    _close(ldt, ldj)
    if act == "leaky_relu":
        xj, lij = jf.inverse(zj)
        xt, lit = tf.inverse(zt)
        _close(xt, xj)
        _close(lit, lij)
        _close(xt, z)
        _close(lit, -ldt)
    else:  # no algebraic inverse, on either side
        with pytest.raises(NotImplementedError):
            jf.inverse(zj)
        with pytest.raises(NotImplementedError):
            tf.inverse(zt)


def _builder_pair(kind, seed):
    build = {"planar": (jmodels.build_planar_stack, nt.build_planar_stack),
             "radial": (jmodels.build_radial_stack, nt.build_radial_stack)}
    jbuild, tbuild = build[kind]
    jmodel = perturb(jbuild(jax.random.PRNGKey(seed), dim=2, K=K), seed)
    tmodel = nt.load_reference_state_dict(
        tbuild(dim=2, K=K, device="cpu"), _state_dict(jmodel))
    return jmodel, tmodel


@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_builder_sample_push_forward_matches_jax(kind):
    """``sample`` is the base draw pushed through the chain; the same base
    noise gives the same samples and log q."""
    jmodel, tmodel = _builder_pair(kind, seed=3)
    eps = _inputs((BATCH, 2), seed=4)
    zj0 = jmodel.q0.loc + jnp.exp(jmodel.q0.log_scale) * jnp.asarray(eps)
    zj, ldj = jmodel.forward_and_log_det(zj0)
    lqj = jmodel.q0.log_prob(zj0) - ldj
    tmodel.q0.forward = lambda n, generator=None: _gaussian_sample(
        tmodel.q0.loc, tmodel.q0.log_scale, _t(eps))
    zt, lqt = tmodel.sample(BATCH)
    _close(zt, zj)
    _close(lqt, lqj)
    # neither stack has an inverse: log_prob raises on both sides
    with pytest.raises(NotImplementedError):
        jmodel.log_prob(zj)
    with pytest.raises(NotImplementedError):
        tmodel.log_prob(zt)


def test_leaky_relu_planar_stack_log_prob_matches_jax():
    """A planar stack with the invertible activation: ``log_prob`` through
    the algebraic inverses."""
    key = jax.random.PRNGKey(5)
    jflows_ = [jflows.Planar.create(k, (2,), act="leaky_relu")
               for k in jax.random.split(key, K)]
    # small noise: larger moves some layer near 1 + w.u = 0, where the
    # log-densities reach 1e3 and float32 cannot hold 1e-4
    jmodel = perturb(JNormalizingFlow.create(
        JDiagGaussian.create(2, trainable=True), jflows_), 5, scale=0.1)
    tmodel = nt.load_reference_state_dict(
        nt.NormalizingFlow(tdist.DiagGaussian(2),
                           [tflows.Planar((2,), act="leaky_relu")
                            for _ in range(K)]), _state_dict(jmodel))
    x = _inputs((BATCH, 2), seed=6) * 2
    _close(tmodel.log_prob(_t(x)), jmodel.log_prob(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_annealed_reverse_kld_gradients_match_jax(kind):
    """One annealed reverse-KLD loss (beta 0.3) on the same base noise:
    the loss and every parameter's gradient, the base's included."""
    jmodel, tmodel = _builder_pair(kind, seed=7)
    jmodel = jmodel.replace(p=JTwoModes())
    tmodel.p = nt.TwoModes()
    eps = _inputs((BATCH, 2), seed=8)
    beta = 0.3

    def jloss(p):
        m = combine(p, static)
        z0 = m.q0.loc + jnp.exp(m.q0.log_scale) * jnp.asarray(eps)
        z, ld = m.forward_and_log_det(z0)
        log_q = m.q0.log_prob(z0) - ld
        return jnp.mean(log_q) - beta * jnp.mean(m.p.log_prob(z))

    params, static = partition(jmodel)
    jl, jg = jax.value_and_grad(jloss)(params)
    tmodel.q0.forward = lambda n, generator=None: _gaussian_sample(
        tmodel.q0.loc, tmodel.q0.log_scale, _t(eps))
    tl = tmodel.reverse_kld(BATCH, beta=beta)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= TOL
    want = _state_dict(combine(jg, static))
    for name, p in tmodel.named_parameters():
        _rel_close(p.grad, want[name])


@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_annealed_reverse_kld_step_trains(kind):
    """``make_reverse_kld_step`` with the comparison example's annealing
    (``examples/comparison_plan_rad_aff.py``): finite losses, and the
    unannealed reverse KLD on fixed draws falls."""
    _, tmodel = _builder_pair(kind, seed=9)
    tmodel.p = nt.TwoModes()

    def kld():
        with torch.no_grad():
            return float(tmodel.reverse_kld(
                4096, generator=torch.Generator().manual_seed(11)))

    before = kld()
    opt = torch.optim.Adam(tmodel.parameters(), lr=5e-3)
    state = nt.init_train_state(tmodel, opt)
    step = nt.make_reverse_kld_step(
        opt, 256, beta_schedule=lambda t: min(1.0, 0.05 + t / 30))
    gen = torch.Generator().manual_seed(10)
    losses = [float(step(state, gen)) for _ in range(60)]
    assert np.isfinite(losses).all()
    assert kld() < before
