"""The port's stochastic normalizing flows (``flows.MetropolisHastings``,
``flows.HamiltonianMonteCarlo``, ``distributions.LinearInterpolation``,
``DiagGaussianProposal``, ``NormalizingFlow.sample_with_mcmc_stats`` and
the reverse KLD through MCMC layers) against the JAX package, on the CPU.

The frameworks draw different numbers, so the port is fed the JAX
package's own draws: each MCMC layer's ``draw`` is replaced by one that
returns what the JAX layer draws from its key (HMC: ``k_mom, k_acc =
split(key)``, the momentum ``normal(k_mom, z.shape)`` and the uniforms
``uniform(k_acc, (B,))``; MH: ``split(key, steps)``, each step's key split
into the proposal's normal and the accept uniform), the model's per-flow
keys split as ``nf_tpu.core._split_keys`` splits them; the base gets the
JAX base's normal draw. An accept decision ``u < p`` (``w <= w_accept``
in MH) can flip on float rounding, so the accept masks must agree except
on chains whose uniform lies within 1e-5 of its acceptance probability
(the probability from the port in float64); the count of such chains is
recorded as the test's ``threshold_ties`` property.

Small sizes: dim 2, 64 chains, an SNF of K 2 blocks (``MaskedAffineFlow``
+ ``ActNorm`` over MLPs [2, 8, 8, 2], or ``build_nsf``'s coupled spline
and ``LULinearPermute`` at hidden 8) with an HMC layer (5 leapfrog steps
of 0.2) after the second block. The JAX layers' weights are perturbed
with numpy noise and cross to the port through reference-named state
dicts (:func:`snf_state_dict`: the JAX exporter has no entry for an MCMC
layer). Tolerances: a layer's z 1e-5 abs and log-det 1e-4 abs, a whole
SNF's samples and log q 1e-4 abs (the leapfrog amplifies the float32
differences of the layers before it), losses 1e-5 relative, gradients
1e-4 after dividing each tensor by max(max |gradient|, 1), the
repository's bar for gradients against the JAX package.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu import core as jcore
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import _split_keys
from nf_tpu.distributions import DiagGaussian as JDiagGaussian
from nf_tpu.distributions import DiagGaussianProposal as JProposal
from nf_tpu.distributions import LinearInterpolation as JInterp
from nf_tpu.distributions import TwoModes as JTwoModes
from nf_tpu.nets import MLP as JMLP
from nf_tpu.utils.masks import create_alternating_binary_mask as jmask
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.nets import MLP
from nf_tpu_torch.nets import _dropout
from nf_tpu_torch.utils.masks import create_alternating_binary_mask
from test_torch_conditional import _port_layout

Z_TOL = 1e-5
LD_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TIE = 1e-5
# a whole SNF's samples and log q: the chain's float32 differences before
# the HMC layer (~2e-6 after the splines) leave its five leapfrog steps
# ~10 times larger
MODEL_TOL = 1e-4
BATCH = 64
DIM = 2
LEAPFROG = 5
SNF_STEP = 0.2  # the example's HMC step


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


# --- the JAX layers' draws ---------------------------------------------------

def hmc_draws(key, z_shape, dtype=jnp.float32):
    """The unit momentum and uniforms the JAX HMC layer draws from
    ``key``."""
    k_mom, k_acc = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_mom, z_shape, dtype)),
            np.asarray(jax.random.uniform(k_acc, (z_shape[0],), dtype)))


def mh_draws(key, steps, z_shape, dtype=jnp.float32):
    """Per step, the proposal's normal and the accept uniform the JAX MH
    layer draws from ``key``."""
    out = []
    for k in jax.random.split(key, steps):
        k_prop, k_acc = jax.random.split(k)
        out.append((np.asarray(jax.random.normal(k_prop, z_shape, dtype)),
                    np.asarray(jax.random.uniform(k_acc, (z_shape[0],),
                                                  dtype))))
    return out


def layer_draws(jlayer, key, z_shape):
    if isinstance(jlayer, jflows.HamiltonianMonteCarlo):
        return hmc_draws(key, z_shape)
    return mh_draws(key, jlayer.steps, z_shape)


def _as_torch(draws):
    if isinstance(draws, tuple):
        return tuple(_t(d) for d in draws)
    return [tuple(_t(d) for d in step) for step in draws]


class DrawFeed:
    """Replaces each port MCMC layer's ``draw`` (instance attribute) with
    the JAX draws given for it, and counts the calls."""

    def __init__(self, layers_and_draws):
        self.calls = 0
        for layer, draws in layers_and_draws:
            layer.draw = self._feeder(_as_torch(draws))

    def _feeder(self, draws):
        def draw(z, generator=None):
            self.calls += 1
            return draws
        return draw


def model_draws(jmodel, tmodel, key, n):
    """The JAX model's base normal and every MCMC layer's draws from
    ``key`` as ``NormalizingFlow.sample`` splits it; feeds them to the
    port model (its base's draw and each MCMC layer's ``draw``) and
    returns the feed."""
    keys = _split_keys(key, len(jmodel.flows) + 1)
    eps = np.asarray(jax.random.normal(keys[0], (n, DIM), jnp.float32))
    q = tmodel.q0
    q.forward = lambda num_samples=1, generator=None, context=None: \
        tdist.base._gaussian_sample(q.loc, q.log_scale, _t(eps))
    pairs = [(tl, layer_draws(jl, k, (n, DIM)))
             for jl, tl, k in zip(jmodel.flows, tmodel.flows, keys[1:])
             if isinstance(jl, (jflows.HamiltonianMonteCarlo,
                                jflows.MetropolisHastings))]
    return DrawFeed(pairs)


# --- the state dict bridge ---------------------------------------------------

def mcmc_state_dict(jlayer, prefix=""):
    """The reference names of a JAX MCMC layer's own state (the JAX
    importer's, ``nf_tpu/compat.py:444-456``)."""
    if isinstance(jlayer, jflows.HamiltonianMonteCarlo):
        return {prefix + "log_step_size": np.asarray(jlayer.log_step_size),
                prefix + "log_mass": np.asarray(jlayer.log_mass)}
    return {prefix + "proposal.scale": np.asarray(jlayer.proposal.scale)}


def snf_state_dict(jmodel):
    """A JAX SNF's reference-named state dict: the base and each
    deterministic layer through ``export_state_dict`` under its prefix,
    the MCMC layers by :func:`mcmc_state_dict`."""
    sd = {f"q0.{k}": v for k, v in export_state_dict(jmodel.q0).items()}
    for i, flow in enumerate(jmodel.flows):
        p = f"flows.{i}."
        if isinstance(flow, (jflows.HamiltonianMonteCarlo,
                             jflows.MetropolisHastings)):
            sd.update(mcmc_state_dict(flow, p))
        else:
            sd.update({p + k: v for k, v in export_state_dict(flow).items()})
    return sd


def _perturb(sd, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        keep = (k.startswith("q0.") or k.endswith(("data_dep_init_done",
                                                    ".b", ".P", ".sign_S",
                                                    ".eye", "perm",
                                                    "inv_perm")))
        if v.dtype.kind == "f" and not keep:
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _import_layers(jmodel, sd):
    """The JAX SNF with ``sd``'s values, layer by layer (the JAX importer
    cannot convert a bridge that holds the base)."""
    flows = []
    for i, flow in enumerate(jmodel.flows):
        p = f"flows.{i}."
        sub = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
        if isinstance(flow, jflows.HamiltonianMonteCarlo):
            flow = flow.replace(log_step_size=jnp.asarray(
                sub["log_step_size"]), log_mass=jnp.asarray(sub["log_mass"]))
        else:
            flow = import_state_dict(flow, sub)
        flows.append(flow)
    return jmodel.replace(flows=tuple(flows))


# --- the SNFs ----------------------------------------------------------------

def jax_snf(kind, key, K=2, hidden=8):
    """``examples/stochastic_nf.py``'s SNF (``kind`` "affine") or the same
    over ``build_nsf``'s layer pairs (``kind`` "nsf")."""
    base = JDiagGaussian.create(DIM, trainable=False)
    target = JTwoModes()
    keys = jax.random.split(key, 2 * K + 1)
    nsf = jmodels.build_nsf(keys[-1], dim=DIM, K=K, hidden=hidden) \
        if kind == "nsf" else None
    flows = []
    for i in range(K):
        if kind == "affine":
            b = jmask(DIM, even=(i % 2 == 0))
            s = JMLP.create(keys[2 * i], [DIM, hidden, hidden, DIM],
                            init_zeros=True)
            t = JMLP.create(keys[2 * i + 1], [DIM, hidden, hidden, DIM],
                            init_zeros=True)
            flows += [jflows.MaskedAffineFlow.create(b, t=t, s=s),
                      jflows.ActNorm.create(DIM)]
        else:
            flows += list(nsf.flows[2 * i:2 * i + 2])
        if (i + 1) % 2 == 0:
            flows.append(jflows.HamiltonianMonteCarlo.create(
                JInterp(dist1=target, dist2=base, alpha=(i + 1) / K),
                steps=LEAPFROG,
                log_step_size=jnp.log(jnp.full((DIM,), SNF_STEP)),
                log_mass=jnp.zeros((DIM,))))
    return jcore.NormalizingFlow.create(base, flows, p=target)


def torch_snf(kind, K=2, hidden=8):
    base = tdist.DiagGaussian(DIM, trainable=False)
    target = tdist.TwoModes()
    nsf = nt.build_nsf(dim=DIM, K=K, hidden=hidden, device="cpu") \
        if kind == "nsf" else None
    flows = []
    for i in range(K):
        if kind == "affine":
            b = create_alternating_binary_mask(DIM, even=(i % 2 == 0))
            flows += [tflows.MaskedAffineFlow(
                b, t=MLP([DIM, hidden, hidden, DIM], init_zeros=True),
                s=MLP([DIM, hidden, hidden, DIM], init_zeros=True)),
                tflows.ActNorm(DIM)]
        else:
            flows += list(nsf.flows[2 * i:2 * i + 2])
        if (i + 1) % 2 == 0:
            flows.append(tflows.HamiltonianMonteCarlo(
                tdist.LinearInterpolation(target, base, alpha=(i + 1) / K),
                LEAPFROG, np.log(np.full(DIM, SNF_STEP)), np.zeros(DIM)))
    return nt.NormalizingFlow(base, flows, p=target)


_PAIRS = {}


def snf_pair(kind):
    """(JAX SNF, port SNF): the same perturbed weights; fresh port copy."""
    if kind not in _PAIRS:
        jmodel = jax_snf(kind, jax.random.PRNGKey(3))
        sd = _perturb(snf_state_dict(jmodel), 4)
        _PAIRS[kind] = (_import_layers(jmodel, sd),
                        nt.load_reference_state_dict(torch_snf(kind), sd))
    jmodel, tmodel = _PAIRS[kind]
    return jmodel, copy.deepcopy(tmodel)


def _z(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, DIM)) * 1.5).astype(np.float32)


# --- the layers on injected draws --------------------------------------------

def _hmc_pair(max_abs_grad=None, log_mass=(0.1, -0.2)):
    jbase = JDiagGaussian.create(DIM, trainable=False)
    jtarget = JInterp(dist1=JTwoModes(), dist2=jbase, alpha=0.7)
    log_step = np.log(np.array([0.5, 0.8], np.float32))
    jlayer = jflows.HamiltonianMonteCarlo.create(
        jtarget, LEAPFROG, jnp.asarray(log_step), jnp.asarray(log_mass,
                                                              jnp.float32),
        max_abs_grad=max_abs_grad)
    tbase = tdist.DiagGaussian(DIM, trainable=False)
    ttarget = tdist.LinearInterpolation(tdist.TwoModes(), tbase, alpha=0.7)
    tlayer = tflows.HamiltonianMonteCarlo(ttarget, LEAPFROG, log_step,
                                          np.asarray(log_mass, np.float32),
                                          max_abs_grad=max_abs_grad)
    return jlayer, tlayer


def hmc_ties(tlayer, z, draws):
    """Chains whose uniform lies within ``TIE`` of the acceptance
    probability, the probability from the port in float64."""
    layer64 = copy.deepcopy(tlayer).double()
    with torch.no_grad():
        _, prob = layer64.trajectory(_t(z).double(), _t(draws[0]).double())
    return np.abs(draws[1].astype(np.float64) - prob.numpy()) < TIE


def assert_masks(moved_j, moved_t, ties, record_property):
    """The accept masks agree except on threshold ties; records the ties'
    count. Returns the chains to compare values on."""
    record_property("threshold_ties", int(ties.sum()))
    differ = moved_j != moved_t
    assert not np.any(differ & ~ties), np.flatnonzero(differ & ~ties)
    return ~differ


_HMC_OUT = {}


def _jax_hmc(max_abs_grad, z, key):
    """The JAX layer's ``forward_with_stats`` (its ``forward`` and
    ``inverse`` are its first two outputs), jitted once per setting."""
    if max_abs_grad not in _HMC_OUT:
        jlayer, _ = _hmc_pair(max_abs_grad)
        _HMC_OUT[max_abs_grad] = jax.jit(
            lambda z: jlayer.forward_with_stats(z, key=key))(jnp.asarray(z))
    return _HMC_OUT[max_abs_grad]


@pytest.mark.parametrize("max_abs_grad", [None, 1.0])
@pytest.mark.parametrize("method", ["forward", "inverse",
                                    "forward_with_stats"])
def test_hmc_layer_matches_jax_on_its_draws(method, max_abs_grad,
                                            record_property):
    _, tlayer = _hmc_pair(max_abs_grad)
    z = _z(0)
    key = jax.random.PRNGKey(7)
    draws = hmc_draws(key, z.shape)
    feed = DrawFeed([(tlayer, draws)])
    want = _jax_hmc(max_abs_grad, z, key)
    with torch.no_grad():
        got = getattr(tlayer, method)(_t(z))
    assert feed.calls == 1
    moved_j = np.any(np.asarray(want[0]) != z, axis=1)
    moved_t = np.any(_np(got[0]) != z, axis=1)
    assert moved_j.any() and not moved_j.all()
    same = assert_masks(moved_j, moved_t, hmc_ties(tlayer, z, draws),
                        record_property)
    np.testing.assert_allclose(_np(got[0])[same], np.asarray(want[0])[same],
                               atol=Z_TOL, rtol=0)
    np.testing.assert_allclose(_np(got[1])[same], np.asarray(want[1])[same],
                               atol=LD_TOL, rtol=0)
    if method == "forward_with_stats":
        assert tuple(got[2].shape) == (1,)
        np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]),
                                   atol=1.0 / BATCH * (~same).sum(), rtol=0)


def test_hmc_clip_changes_the_trajectory():
    """``max_abs_grad`` clips: a tight bound moves the chains elsewhere."""
    _, free = _hmc_pair()
    _, clipped = _hmc_pair(max_abs_grad=0.05)
    z = _t(_z(1))
    p = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        z_free, _ = free.trajectory(z, p)
        z_clip, _ = clipped.trajectory(z, p)
        g = clipped.grad_log_p(z)
    assert float(g.abs().max()) <= float(np.float32(0.05))
    assert float((z_free - z_clip).abs().max()) > 1e-2


def test_mh_layer_matches_jax_on_its_draws(record_property):
    jlayer = jflows.MetropolisHastings.create(
        JTwoModes(), JProposal.create((DIM,), 0.5), steps=3)
    tlayer = tflows.MetropolisHastings(
        tdist.TwoModes(), tdist.DiagGaussianProposal((DIM,), 0.5), steps=3)
    z = _z(2)
    key = jax.random.PRNGKey(8)
    draws = mh_draws(key, 3, z.shape)
    DrawFeed([(tlayer, draws)])
    want = jax.jit(lambda z: jlayer.forward_with_stats(z, key=key))(
        jnp.asarray(z))
    with torch.no_grad():
        got = tlayer.forward_with_stats(_t(z))
        inv = tlayer.inverse(_t(z))
    # ties: |w - w_accept| < TIE at any step, w_accept in float64
    z64 = _t(z).double()
    target = tdist.TwoModes()
    ties = np.zeros(BATCH, bool)
    for noise, w in draws:
        z_ = z64 + 0.5 * _t(noise).double()
        w_acc = torch.clamp(torch.exp(target.log_prob(z_)
                                      - target.log_prob(z64)), max=1.0)
        ties |= np.abs(w.astype(np.float64) - w_acc.numpy()) < TIE
        z64 = torch.where((_t(w).double() <= w_acc)[:, None], z_, z64)
    record_property("threshold_ties", int(ties.sum()))
    ok = ~ties
    np.testing.assert_allclose(_np(got[0])[ok], np.asarray(want[0])[ok],
                               atol=Z_TOL, rtol=0)
    np.testing.assert_allclose(_np(got[1])[ok], np.asarray(want[1])[ok],
                               atol=LD_TOL, rtol=0)
    assert tuple(got[2].shape) == (3,)
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]),
                               atol=ties.sum() / BATCH, rtol=0)
    np.testing.assert_array_equal(_np(inv[0]), _np(got[0]))


def test_mcmc_layers_hold_only_their_own_state():
    """The target is held, not registered: the state dicts carry the
    reference's names only, and ``.to`` / ``deepcopy`` keep the bridge on
    the owner's base."""
    _, tlayer = _hmc_pair()
    assert sorted(tlayer.state_dict()) == ["log_mass", "log_step_size"]
    mh = tflows.MetropolisHastings(
        tdist.TwoModes(), tdist.DiagGaussianProposal((DIM,), 0.5))
    assert list(mh.state_dict()) == ["proposal.scale"]
    assert tuple(mh.proposal.scale.shape) == (1,)
    _, model = snf_pair("affine")
    assert not any("target" in k for k in model.state_dict())
    copied = copy.deepcopy(model)
    assert copied.flows[4].target.dist2 is copied.q0
    assert copied.flows[4].target.dist1 is not model.p


def test_snf_state_dict_loads_a_held_base_under_the_layer_too():
    """A reference state dict may carry an MCMC layer's target (the
    reference's ``Target`` registers proposal buffers): the loader takes
    those entries without loading them, and still raises on any other
    unknown key."""
    jmodel, _ = snf_pair("affine")
    sd = snf_state_dict(jmodel)
    sd["flows.4.target.dist2.loc"] = np.ones((1, DIM), np.float32)
    model = nt.load_reference_state_dict(torch_snf("affine"), sd)
    assert float(model.q0.loc.abs().max()) == 0.0
    sd["flows.3.target.loc"] = np.ones((1, DIM), np.float32)
    with pytest.raises(KeyError):
        nt.load_reference_state_dict(torch_snf("affine"), sd)


# --- the SNF: sampling with stats, the reverse KLD ---------------------------

MODEL_KEY = 12
BETA = 0.6
_SAMPLES = {}
_LOSSES = {}


def _jax_sample(kind):
    """The JAX SNF's ``sample_with_mcmc_stats`` on ``MODEL_KEY``."""
    if kind not in _SAMPLES:
        jmodel, _ = snf_pair(kind)
        _SAMPLES[kind] = jax.jit(lambda k: jmodel.sample_with_mcmc_stats(
            k, BATCH))(jax.random.PRNGKey(MODEL_KEY))
    return _SAMPLES[kind]


def _jax_loss(kind, score_fn):
    """The JAX SNF's reverse KLD on ``MODEL_KEY`` and its gradients,
    reference-named."""
    if (kind, score_fn) not in _LOSSES:
        jmodel, _ = snf_pair(kind)
        params, static = partition(jmodel)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: combine(p, static).reverse_kld(
                jax.random.PRNGKey(MODEL_KEY), BATCH, beta=BETA,
                score_fn=score_fn)))(params)
        _LOSSES[kind, score_fn] = (float(loss),
                                   snf_state_dict(combine(grads, static)))
    return _LOSSES[kind, score_fn]


@pytest.mark.parametrize("kind", ["affine", "nsf"])
def test_sample_with_mcmc_stats_matches_jax(kind):
    jmodel, tmodel = snf_pair(kind)
    feed = model_draws(jmodel, tmodel, jax.random.PRNGKey(MODEL_KEY), BATCH)
    z, log_q, acc = _jax_sample(kind)
    with torch.no_grad():
        tz, tlog_q, tacc = tmodel.sample_with_mcmc_stats(BATCH)
    assert feed.calls == 1 and len(tacc) == len(acc) == 1
    np.testing.assert_allclose(_np(tz), np.asarray(z), atol=MODEL_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(tlog_q), np.asarray(log_q), atol=MODEL_TOL,
                               rtol=0)
    np.testing.assert_array_equal(_np(tacc[0]), np.asarray(acc[0]))
    assert 0.0 < float(tacc[0][0]) <= 1.0


@pytest.mark.parametrize("kind,score_fn", [("affine", True),
                                           ("affine", False),
                                           ("nsf", True)])
def test_reverse_kld_loss_and_gradients_match_jax(kind, score_fn):
    """The reverse KLD through the HMC layer, its gradient second-order
    through ``grad log p`` into the couplings, ``log_step_size`` and
    ``log_mass``; with ``score_fn=False`` the sticking-the-landing re-pass
    runs the HMC layer's inverse on the sampling pass's draws: the layer
    draws once, as the JAX re-pass reuses the flow's key."""
    jmodel, tmodel = snf_pair(kind)
    feed = model_draws(jmodel, tmodel, jax.random.PRNGKey(MODEL_KEY), BATCH)
    want_loss, want = _jax_loss(kind, score_fn)
    loss = tmodel.reverse_kld(BATCH, beta=BETA, score_fn=score_fn,
                              generator=torch.Generator())
    loss.backward()
    assert feed.calls == 1
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * max(
        abs(want_loss), 1.0)
    want = _port_layout(tmodel, want)
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        w = want[name]
        scale = max(float(np.max(np.abs(w))), 1.0)
        np.testing.assert_allclose(_np(p.grad) / scale, w / scale,
                                   atol=GRAD_TOL, rtol=0, err_msg=name)
    hmc = tmodel.flows[-1]
    assert float(hmc.log_step_size.grad.abs().max()) > 0


def test_stl_re_pass_without_shared_draws_differs():
    """Outside ``shared_masks`` the HMC layer draws afresh: the re-pass
    of ``reverse_kld(score_fn=False)`` runs inside it, so it reuses the
    draws; here the layer is called twice outside it and draws twice."""
    _, tmodel = snf_pair("affine")
    hmc = tmodel.flows[-1]
    calls = []
    real = hmc.draw

    def counted(z, generator=None):
        calls.append(1)
        return real(z, generator)

    hmc.draw = counted
    gen = torch.Generator().manual_seed(0)
    z = _t(_z(5))
    with torch.no_grad():
        a = hmc.forward(z, generator=gen)
        b = hmc.inverse(z, generator=gen)
        with _dropout.shared_masks():
            c = hmc.forward(z, generator=gen)
            d = hmc.inverse(z, generator=gen)
    assert len(calls) == 3
    assert not torch.equal(a[0], b[0])
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])


def test_init_from_samples_and_serving_run_hmc_without_autograd():
    """``init_from_samples`` (under ``no_grad``) and a served sampler (a
    compiled function, eager on the CPU, under ``no_grad``) run the HMC
    layer's gradient with autograd switched on for it alone."""
    _, tmodel = snf_pair("affine")
    for f in tmodel.flows:
        if isinstance(f, tflows.ActNorm):
            f.data_dep_init_done.zero_()
    gen = torch.Generator().manual_seed(1)
    tmodel.init_from_samples(128, generator=gen)
    assert all(float(f.data_dep_init_done) == 1.0 for f in tmodel.flows
               if isinstance(f, tflows.ActNorm))
    sampler = nt.compile_sampler(tmodel, 32)
    z, log_q = sampler(3)
    with torch.inference_mode():
        z2, log_q2 = tmodel.sample(32, generator=torch.Generator()
                                   .manual_seed(3))
    assert torch.equal(z, z2) and torch.equal(log_q, log_q2)
    assert not z.requires_grad and bool(torch.isfinite(log_q).all())
