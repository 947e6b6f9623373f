"""The port's HAIS (``nf_tpu_torch.sampling.HAIS``) and the limits
``chip_smoke.py`` holds its card runs to, on the CPU.

``HAIS.create``'s layers, their annealing weights, step sizes and masses
are the JAX package's; ``sample_with_stats`` on the JAX draws (the prior's
normal from ``keys[0]`` of ``split(key, n_layers + 1)``, each HMC layer's
momentum and uniforms from its key, as ``test_torch_stochastic`` feeds
them) gives the JAX samples, log-weights and per-layer acceptance: 4
annealing steps (3 HMC layers), 64 samples. Tolerances: samples 1e-5
abs, log-weights 1e-4 abs, acceptance exact, on chains whose accept
decisions are no threshold ties (``|u - p| < 1e-5`` at some layer; their
count is the ``threshold_ties`` property).

The card limits: HAIS's ``log Z`` estimate at ``examples/hais_sampling.
py``'s settings and the Metropolis-Hastings chain's first two moments
are held against a numpy quadrature of TwoModes
(``chip_smoke.two_modes_quadrature``). Each limit is 4 times the spread of
the CPU's plain path over 5 seeds, or a floor, whichever is larger; the
tests here measure that spread and hold ``chip_smoke``'s constants to it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import nf_tpu_torch as nt
from nf_tpu.distributions import DiagGaussian as JDiagGaussian
from nf_tpu.distributions import TwoModes as JTwoModes
from nf_tpu.sampling import HAIS as JHAIS
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from test_torch_stochastic import TIE, DrawFeed, _np, _t, hmc_draws

Z_TOL = 1e-5
LW_TOL = 1e-4
BATCH = 64
BETAS = np.linspace(1.0, 0.0, 5)
STEP = [0.3, 0.4]
LOG_MASS = [0.1, -0.1]
SEEDS = 5


def _pair():
    jhais = JHAIS.create(BETAS, JDiagGaussian.create(2, trainable=False),
                         JTwoModes(), num_leapfrog=5,
                         step_size=jnp.asarray(STEP), log_mass=jnp.asarray(
                             LOG_MASS))
    thais = nt.sampling.HAIS.create(
        BETAS, tdist.DiagGaussian(2, trainable=False), tdist.TwoModes(),
        num_leapfrog=5, step_size=STEP, log_mass=LOG_MASS, device="cpu")
    return jhais, thais


def test_create_builds_the_jax_layers():
    jhais, thais = _pair()
    assert len(thais.layers) == len(jhais.layers) == 3
    for jl, tl in zip(jhais.layers, thais.layers):
        assert isinstance(tl, tflows.HamiltonianMonteCarlo)
        assert tl.target.alpha == jl.target.alpha
        assert tl.target.dist1 is thais.target
        assert tl.target.dist2 is thais.prior
        assert tl.steps == jl.steps == 5
        np.testing.assert_allclose(_np(tl.log_step_size),
                                   np.asarray(jl.log_step_size), atol=1e-7)
        np.testing.assert_array_equal(_np(tl.log_mass),
                                      np.asarray(jl.log_mass))
    assert [tl.target.alpha for tl in thais.layers] == [0.25, 0.5, 0.75]
    # the bridges hold the prior and the target without registering them
    assert sorted(thais.state_dict()) == sorted(
        ["prior.loc", "prior.log_scale"]
        + [f"layers.{i}.{n}" for i in range(3)
           for n in ("log_step_size", "log_mass")])


def test_sample_with_stats_matches_jax_on_its_draws(record_property):
    jhais, thais = _pair()
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, len(jhais.layers) + 1)
    eps = np.asarray(jax.random.normal(keys[0], (BATCH, 2), jnp.float32))
    q = thais.prior
    q.forward = lambda num_samples=1, generator=None, context=None: \
        tdist.base._gaussian_sample(q.loc, q.log_scale, _t(eps))
    draws = [hmc_draws(k, (BATCH, 2)) for k in keys[1:]]
    feed = DrawFeed(list(zip(thais.layers, draws)))
    z, log_w, acc = jax.jit(lambda k: jhais.sample_with_stats(k, BATCH))(key)
    with torch.no_grad():
        tz, tlog_w, tacc = thais.sample_with_stats(BATCH)
        # threshold ties at each layer, the probability in float64 on the
        # port's own input to the layer
        ties = np.zeros(BATCH, bool)
        zl = _t(eps) * torch.exp(q.log_scale) + q.loc
        for layer, (p_unit, u) in zip(thais.layers, draws):
            l64 = copy.deepcopy(layer).double()
            _, prob = l64.trajectory(zl.double(), _t(p_unit).double())
            ties |= np.abs(u.astype(np.float64) - prob.numpy()) < TIE
            zl, _, _ = layer.step(zl, (_t(p_unit), _t(u)))
    record_property("threshold_ties", int(ties.sum()))
    assert feed.calls == 3
    assert tuple(tacc.shape) == (3,)
    ok = ~ties
    np.testing.assert_allclose(_np(tz)[ok], np.asarray(z)[ok], atol=Z_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(tlog_w)[ok], np.asarray(log_w)[ok],
                               atol=LW_TOL, rtol=0)
    np.testing.assert_allclose(_np(tacc), np.asarray(acc),
                               atol=ties.sum() / BATCH, rtol=0)
    assert 0.0 < float(tacc.min()) and float(tacc.max()) <= 1.0


def test_sample_is_sample_with_stats_and_serves_as_a_graph_input():
    """``sample`` has ``NormalizingFlow.sample``'s signature, so
    ``compile_sampler`` serves it (eagerly on the CPU, bound to a copy of
    the weights): a seed gives the eager draws."""
    _, thais = _pair()
    sampler = nt.compile_sampler(thais, 32)
    z, log_w = sampler(9)
    z2, log_w2, acc = thais.sample_with_stats(
        32, torch.Generator().manual_seed(9))
    assert torch.equal(z, z2) and torch.equal(log_w, log_w2)
    assert not z.requires_grad


def test_create_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.sampling.HAIS.create(BETAS, tdist.DiagGaussian(2),
                                tdist.TwoModes(), 5, STEP, LOG_MASS)


def test_effective_sample_size_of_equal_weights_is_the_count():
    lw = torch.full((100,), -3.0)
    assert abs(float(nt.utils.effective_sample_size(lw)) - 100.0) < 1e-3


# --- the card's limits, from the CPU's plain path ---------------------------

def test_hais_log_z_limit_covers_four_times_the_cpu_spread():
    """``examples/hais_sampling.py``'s settings (4096 samples, 32 annealing
    steps, 5 leapfrog steps of 0.12) on 5 seeds: each estimate lies within
    ``chip_smoke.HAIS_LOGZ_TOL`` of the quadrature's ``log Z``, and the
    limit is at least 4 times the estimates' standard deviation (its
    floor 0.05)."""
    log_z, _ = chip_smoke.two_modes_quadrature()
    estimates = []
    for seed in range(SEEDS):
        hais = chip_smoke.hais_model(torch.device("cpu"))
        with torch.no_grad():
            _, log_w, _ = hais.sample_with_stats(
                chip_smoke.HAIS_SAMPLES, torch.Generator().manual_seed(seed))
        estimates.append(chip_smoke.log_z_estimate(log_w))
    spread = float(np.std(estimates))
    print(f"HAIS log Z on the CPU over {SEEDS} seeds: {estimates}, std "
          f"{spread:.4g}, quadrature {log_z:.6f}")
    assert chip_smoke.HAIS_LOGZ_TOL >= max(0.05, 4 * spread)
    assert max(abs(e - log_z) for e in estimates) <= chip_smoke.HAIS_LOGZ_TOL


def test_mh_moment_limit_covers_four_times_the_cpu_spread():
    """The Metropolis-Hastings chain of ``chip_smoke``'s phase 22c (65536
    chains from (+-3, +-3), DiagGaussianProposal 0.5, 200 steps, the JAX
    test's settings) on 5 seeds: every moment within
    ``chip_smoke.MH_MOMENT_TOL`` of the quadrature's, the limit at least 4
    times the largest deviation."""
    _, want = chip_smoke.two_modes_quadrature()
    devs = []
    for seed in range(SEEDS):
        with torch.no_grad():
            z, _, _ = chip_smoke.mh_chain(torch.device("cpu"), seed)
        devs.append(np.abs(chip_smoke.moments(z) - want))
    worst = float(np.max(devs))
    print(f"MH moments on the CPU: largest deviation from the quadrature "
          f"over {SEEDS} seeds {worst:.4g}")
    assert chip_smoke.MH_MOMENT_TOL >= 4 * worst
