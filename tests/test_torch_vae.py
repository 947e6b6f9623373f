"""The port's VAE pieces (the encoders ``Dirac``, ``UniformEncoder``,
``ConstDiagGaussian``, ``NNDiagGaussian``, the decoders
``NNDiagGaussianDecoder`` and ``NNBernoulliDecoder``, and
``NormalizingFlowVAE``) against the JAX package, on the CPU.

The frameworks draw different numbers, so each drawing encoder's
``draw`` hands the port the JAX encoder's own draw (``normal(key, (B, S,
d))``; the uniform encoder's ``uniform(key, shape, zmin, zmax)``, which is
its ``z``), the VAE's key split as ``nf_tpu.core._split_keys`` splits it.
Small sizes: observations of 12, latent 4, MLPs [12, 16, 8] (encoder) and
[4, 16, 12] (decoder), 2 ``MaskedAffineFlow`` posterior layers on MLPs
[4, 8, 4], 5 rows, 3 posterior samples each. The JAX modules' weights are
perturbed with numpy noise and cross to the port under the reference's
names (:func:`vae_state_dict`: the JAX exporter has no entry for an
encoder, a decoder or the VAE). Tolerances: outputs and log-densities
1e-5 abs (1e-4 on the decoders' sums over 12 pixels and the VAE's
log-densities), the negative ELBO 1e-5 relative, gradients 1e-4 after
dividing each tensor by max(max |gradient|, 1).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu_torch as nt
from nf_tpu import core as jcore
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import _split_keys
from nf_tpu.distributions import ConstDiagGaussian as JConst
from nf_tpu.distributions import DiagGaussian as JDiagGaussian
from nf_tpu.distributions import Dirac as JDirac
from nf_tpu.distributions import NNBernoulliDecoder as JBernoulli
from nf_tpu.distributions import NNDiagGaussian as JNNDiag
from nf_tpu.distributions import NNDiagGaussianDecoder as JGaussDec
from nf_tpu.distributions import UniformEncoder as JUniform
from nf_tpu.nets import MLP as JMLP
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.nets import MLP

TOL = 1e-5
SUM_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OBS, LATENT, ROWS, SAMPLES = 12, 4, 5, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol, rtol=0)


def _perturbed(sd, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + scale * rng.standard_normal(np.shape(v)))
            .astype(np.float32) if not k.endswith((".b", "prior.loc",
                                                   "prior.log_scale"))
            else np.asarray(v) for k, v in sd.items()}


def _net_pair(key, widths, seed):
    """A JAX MLP and the port's, the same perturbed weights."""
    jnet = JMLP.create(key, widths)
    sd = _perturbed(export_state_dict(jnet), seed)
    return (import_state_dict(jnet, sd),
            nt.load_reference_state_dict(MLP(widths), sd))


def _x(seed, rows=ROWS, d=OBS):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (rows, d)).astype(np.float32)


def _fed(encoder, draw):
    """``encoder`` handing out ``draw`` (numpy) as its noise."""
    encoder.draw = lambda shape, generator, like: _t(draw)
    return encoder


# --- the encoders ------------------------------------------------------------

def test_dirac_matches_jax():
    x = _x(0)
    z, log_q = JDirac().forward(None, jnp.asarray(x), num_samples=SAMPLES)
    tz, tlog_q = tdist.Dirac()(_t(x), num_samples=SAMPLES)
    _close(tz, z)
    _close(tlog_q, log_q)
    _close(tdist.Dirac().log_prob(tz, _t(x)), JDirac().log_prob(z, x))


def test_uniform_encoder_matches_jax():
    x = _x(1)
    key = jax.random.PRNGKey(1)
    jenc = JUniform(zmin=-1.0, zmax=2.5)
    z, log_q = jenc.forward(key, jnp.asarray(x), num_samples=SAMPLES)
    tenc = _fed(tdist.UniformEncoder(zmin=-1.0, zmax=2.5), np.asarray(z))
    tz, tlog_q = tenc(_t(x), num_samples=SAMPLES)
    _close(tz, z)
    _close(tlog_q, log_q)
    _close(tenc.log_prob(tz, _t(x)), jenc.log_prob(z, x))
    # the port's own draw lies in [zmin, zmax)
    own = tdist.UniformEncoder(zmin=-1.0, zmax=2.5)(
        _t(x), SAMPLES, torch.Generator().manual_seed(0))[0]
    assert float(own.min()) >= -1.0 and float(own.max()) < 2.5


def test_const_diag_gaussian_matches_jax():
    rng = np.random.default_rng(2)
    loc = rng.standard_normal(LATENT).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, LATENT).astype(np.float32)
    jenc = JConst.create(loc, scale)
    tenc = nt.load_reference_state_dict(
        tdist.ConstDiagGaussian(np.zeros(LATENT), np.ones(LATENT)),
        {"loc": np.asarray(jenc.loc), "scale": np.asarray(jenc.scale)})
    key = jax.random.PRNGKey(2)
    x = _x(2)
    z, log_q = jenc.forward(key, jnp.asarray(x), num_samples=SAMPLES)
    eps = jax.random.normal(key, (ROWS, SAMPLES, LATENT))
    tz, tlog_q = _fed(tenc, np.asarray(eps))(_t(x), num_samples=SAMPLES)
    _close(tz, z)
    _close(tlog_q, log_q)
    _close(tenc.log_prob(tz, _t(x)), jenc.log_prob(z, x))
    # a flat batch of z, as the JAX package takes it
    _close(tenc.log_prob(tz[0], None), jenc.log_prob(z[0], None))


def test_nn_diag_gaussian_matches_jax():
    jnet, tnet = _net_pair(jax.random.PRNGKey(3), [OBS, 16, 2 * LATENT], 3)
    jenc, tenc = JNNDiag(net=jnet), tdist.NNDiagGaussian(tnet)
    key = jax.random.PRNGKey(4)
    x = _x(3)
    z, log_q = jenc.forward(key, jnp.asarray(x), num_samples=SAMPLES)
    eps = jax.random.normal(key, (ROWS, SAMPLES, LATENT))
    tz, tlog_q = _fed(tenc, np.asarray(eps))(_t(x), num_samples=SAMPLES)
    _close(tz, z)
    _close(tlog_q, log_q)
    _close(tenc.log_prob(tz, _t(x)), jenc.log_prob(z, jnp.asarray(x)))
    assert sorted(tenc.state_dict()) == sorted(
        f"net.net.{i}.{n}" for i in (0, 2) for n in ("weight", "bias"))


# --- the decoders ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "bernoulli"])
@pytest.mark.parametrize("rows", [ROWS, ROWS * SAMPLES])
def test_decoders_match_jax(kind, rows):
    """``forward`` and ``log_prob``, with z of the data's rows or of
    ``SAMPLES`` times as many (x tiled along a sample axis)."""
    out = 2 * OBS if kind == "gaussian" else OBS
    jnet, tnet = _net_pair(jax.random.PRNGKey(5), [LATENT, 16, out], 5)
    jdec, tdec = ((JGaussDec(net=jnet), tdist.NNDiagGaussianDecoder(tnet))
                  if kind == "gaussian" else
                  (JBernoulli(net=jnet), tdist.NNBernoulliDecoder(tnet)))
    z = np.random.default_rng(6).standard_normal((rows, LATENT)).astype(
        np.float32)
    x = _x(6)
    with torch.no_grad():
        got = tdec(_t(z))
        got_lp = tdec.log_prob(_t(x), _t(z))
    want = jdec.forward(jnp.asarray(z))
    for g, w in zip(got if kind == "gaussian" else [got],
                    want if kind == "gaussian" else [want]):
        _close(g, w)
    _close(got_lp, jdec.log_prob(jnp.asarray(x), jnp.asarray(z)), SUM_TOL)
    assert tuple(got_lp.shape) == (rows,)


def test_bernoulli_log_sigmoid_is_stable():
    """Logits of +-200: the log-likelihood stays finite (the stable
    log-sigmoid), as the JAX package's."""
    net = MLP([LATENT, OBS])
    with torch.no_grad():
        net.net[0].weight.zero_()
        net.net[0].bias.fill_(200.0)
    dec = tdist.NNBernoulliDecoder(net)
    x = torch.zeros(2, OBS)
    lp = dec.log_prob(x, torch.zeros(2, LATENT))
    assert bool(torch.isfinite(lp).all())
    np.testing.assert_allclose(_np(lp), -200.0 * OBS, rtol=1e-6)


# --- NormalizingFlowVAE ------------------------------------------------------

def vae_state_dict(jvae):
    """The reference-named state dict of a JAX ``NormalizingFlowVAE`` with
    an ``NNDiagGaussian`` encoder and a net decoder: ``prior.``,
    ``q0.net.``, ``flows.{i}.`` and ``decoder.net.`` (the JAX importer's
    names, ``nf_tpu/compat.py:457-465,692-695``), each part through
    ``export_state_dict``."""
    sd = {}
    for prefix, mod in (("prior.", jvae.prior), ("q0.net.", jvae.q0.net),
                        ("decoder.net.", jvae.decoder.net)):
        sd.update({prefix + k: v for k, v in export_state_dict(mod).items()})
    for i, flow in enumerate(jvae.flows):
        sd.update({f"flows.{i}.{k}": v
                   for k, v in export_state_dict(flow).items()})
    return sd


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _vae_pair():
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    flows = []
    tflows_ = []
    for i in range(2):
        b = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
        b = b if i % 2 == 0 else 1.0 - b
        flows.append(jflows.MaskedAffineFlow.create(
            jnp.asarray(b),
            t=JMLP.create(keys[2 * i], [LATENT, 8, LATENT], init_zeros=True),
            s=JMLP.create(keys[2 * i + 1], [LATENT, 8, LATENT],
                          init_zeros=True)))
        tflows_.append(tflows.MaskedAffineFlow(
            b, t=MLP([LATENT, 8, LATENT], init_zeros=True),
            s=MLP([LATENT, 8, LATENT], init_zeros=True)))
    jvae = jcore.NormalizingFlowVAE.create(
        JDiagGaussian.create(LATENT, trainable=False),
        JNNDiag(net=JMLP.create(keys[4], [OBS, 16, 2 * LATENT])),
        flows=flows,
        decoder=JBernoulli(net=JMLP.create(keys[5], [LATENT, 16, OBS])))
    sd = _perturbed(vae_state_dict(jvae), 8)
    jvae = jvae.replace(
        q0=jvae.q0.replace(net=import_state_dict(jvae.q0.net,
                                                 _sub(sd, "q0.net."))),
        flows=tuple(import_state_dict(f, _sub(sd, f"flows.{i}."))
                    for i, f in enumerate(jvae.flows)),
        decoder=jvae.decoder.replace(net=import_state_dict(
            jvae.decoder.net, _sub(sd, "decoder.net."))))
    tvae = nt.NormalizingFlowVAE(
        tdist.DiagGaussian(LATENT, trainable=False),
        tdist.NNDiagGaussian(MLP([OBS, 16, 2 * LATENT])), flows=tflows_,
        decoder=tdist.NNBernoulliDecoder(MLP([LATENT, 16, OBS])))
    return jvae, nt.load_reference_state_dict(tvae, sd)


def _feed_vae(tvae, key):
    """The JAX VAE's encoder draw from ``key``, fed to the port."""
    k0 = _split_keys(key, 3)[0]
    eps = jax.random.normal(k0, (ROWS, SAMPLES, LATENT))
    _fed(tvae.q0, np.asarray(eps))


def test_vae_forward_matches_jax():
    jvae, tvae = _vae_pair()
    key = jax.random.PRNGKey(9)
    x = _x(9)
    z, log_q, log_p = jvae.forward(key, jnp.asarray(x), num_samples=SAMPLES)
    _feed_vae(tvae, key)
    with torch.no_grad():
        tz, tlog_q, tlog_p = tvae(_t(x), num_samples=SAMPLES)
    assert tuple(tz.shape) == (ROWS, SAMPLES, LATENT)
    assert tuple(tlog_q.shape) == tuple(tlog_p.shape) == (ROWS, SAMPLES)
    _close(tz, z)
    _close(tlog_q, log_q, SUM_TOL)
    _close(tlog_p, log_p, SUM_TOL)


def test_negative_elbo_and_gradients_match_jax():
    jvae, tvae = _vae_pair()
    key = jax.random.PRNGKey(10)
    x = _x(10)
    params, static = partition(jvae)

    def neg_elbo(p):
        _, log_q, log_p = combine(p, static).forward(
            key, jnp.asarray(x), num_samples=SAMPLES)
        return jnp.mean(log_q - log_p)

    loss, grads = jax.jit(jax.value_and_grad(neg_elbo))(params)
    want = vae_state_dict(combine(grads, static))
    _feed_vae(tvae, key)
    _, tlog_q, tlog_p = tvae(_t(x), num_samples=SAMPLES)
    tloss = torch.mean(tlog_q - tlog_p)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(loss)) <= LOSS_TOL * max(
        abs(float(loss)), 1.0)
    names = [n for n, _ in tvae.named_parameters()]
    assert names and not any(n.startswith("prior.") for n in names)
    for name, p in tvae.named_parameters():
        w = np.asarray(want[name])
        scale = max(float(np.max(np.abs(w))), 1.0)
        np.testing.assert_allclose(_np(p.grad) / scale, w / scale,
                                   atol=GRAD_TOL, rtol=0, err_msg=name)


def test_vae_trains_through_the_keyed_step_on_the_cpu():
    """``make_forward_kld_step(..., with_key=True)`` with the negative
    ELBO: the step's seed gives its draws (two twins agree), and the
    loss falls over a few steps."""
    _, tvae = _vae_pair()

    def neg_elbo(model, x, generator):
        _, log_q, log_p = model(x, num_samples=1, generator=generator)
        return torch.mean(log_q - log_p)

    x = _t(_x(11, rows=64))
    losses = []
    for _ in range(2):
        m = copy.deepcopy(tvae)
        opt = torch.optim.Adam(m.parameters(), lr=1e-2)
        step = nt.make_forward_kld_step(opt, loss_fn=neg_elbo,
                                        with_key=True)
        state = nt.init_train_state(m, opt)
        losses.append([float(step(state, x, i)) for i in range(30)])
    assert losses[0] == losses[1]
    assert np.mean(losses[0][-5:]) < np.mean(losses[0][:5])
