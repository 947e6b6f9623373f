"""The port's RealNVP pieces (``MLP``, ``MaskedAffineFlow``,
``AffineConstFlow``, ``ActNorm``, ``Scanned``, ``TwoModes``,
``init_from_data`` / ``init_from_samples``, ``reverse_alpha_div`` and
``build_realnvp``) against the JAX package, on the CPU.

A small ``build_realnvp`` (dim 2, K = 4, hidden [8, 8]) is built in JAX,
its export perturbed with numpy noise (N(0, 0.2²); the zero-init nets make
every coupling the identity) with its ActNorms marked not yet set
(``data_dep_init_done`` 0; the exporter writes 1), and loaded into both
frameworks. Inputs come from a numpy seed; where the model draws, both
frameworks get numpy's draws (``test_torch_conditional.jax_fixed`` /
``torch_fixed``). Tolerance: 1e-4 abs on outputs, log-dets, log-densities
and losses, and on gradients (and the alpha divergence, whose importance
weights can make it ~100) divided by ``max(max |value|, 1)``; bf16
against the JAX package's bf16 within 0.05 abs + 0.05 relative, its own
bar. ``scan=True`` loads the same export and agrees with ``scan=False``
bitwise.
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
from nf_tpu.distributions import TwoModes as JTwoModes
from nf_tpu.flows import AffineConstFlow as JAffineConst
from nf_tpu.flows import MaskedAffineFlow as JMaskedAffine
from nf_tpu.nets import MLP as JMLP
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.nets import MLP
from test_torch_conditional import jax_fixed, torch_fixed

TOL = 1e-4
MIXED_TOL = 0.05
SMALL = dict(dim=2, K=4, hidden=[8, 8])
BATCH = 256
_PAIRS = {}


def _perturbed(sd, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.endswith("data_dep_init_done"):
            v = np.zeros_like(v)
        elif v.dtype.kind == "f" and not k.endswith(".b"):
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _pair(seed=0):
    """(JAX model, port model, state dict): the same perturbed weights,
    ActNorms not yet set; fresh copies each call."""
    if seed not in _PAIRS:
        jmodel = jmodels.build_realnvp(jax.random.PRNGKey(seed), **SMALL)
        sd = _perturbed(export_state_dict(jmodel), seed)
        _PAIRS[seed] = (import_state_dict(jmodel, sd),
                        nt.load_reference_state_dict(
                            nt.build_realnvp(device="cpu", **SMALL), sd), sd)
    jmodel, tmodel, sd = _PAIRS[seed]
    return jmodel, copy.deepcopy(tmodel), sd


def _inputs(n=BATCH, seed=0, dim=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * 1.5 + 0.3).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _grad_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


# --- MLP, the affine layers, the prior --------------------------------------

@pytest.mark.parametrize("output_fn", [None, "sigmoid", "relu", "tanh",
                                       "clampexp"])
def test_mlp_output_maps_match_jax(output_fn):
    kw = dict(leaky=0.1, output_fn=output_fn)
    if output_fn is not None:
        kw.update(score_scale=0.7, output_scale=1.3)
    jmlp = JMLP.create(jax.random.PRNGKey(1), [3, 8, 8, 2], **kw)
    tmlp = nt.load_reference_state_dict(MLP([3, 8, 8, 2], **kw),
                                        export_state_dict(jmlp))
    x = _inputs(seed=1, dim=3)
    with torch.no_grad():
        got = tmlp(torch.from_numpy(x))
    _close(got, jmlp(jnp.asarray(x)))


def test_mlp_dropout_keeps_the_reference_indices_and_applies_none():
    """With ``dropout`` the last Linear sits at an odd index, as the
    reference's ``nn.Dropout`` shifts it; the JAX package's keyless call
    drops nothing, and neither does the port."""
    jmlp = JMLP.create(jax.random.PRNGKey(2), [2, 8, 8, 2], dropout=0.5)
    sd = export_state_dict(jmlp)
    assert "net.5.weight" in sd
    tmlp = nt.load_reference_state_dict(MLP([2, 8, 8, 2], dropout=0.5), sd)
    x = _inputs(seed=2)
    tmlp.train()
    with torch.no_grad():
        got = tmlp(torch.from_numpy(x))
    _close(got, jmlp(jnp.asarray(x)))


def test_mlp_init_zeros_zeroes_only_the_last_layer():
    mlp = MLP([2, 8, 2], init_zeros=True, generator=torch.Generator()
              .manual_seed(0))
    assert not mlp.net[2].weight.any() and not mlp.net[2].bias.any()
    assert mlp.net[0].weight.all()


def _masked_affine_pair(seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    b = np.array([1.0, 0.0], np.float32)
    s = JMLP.create(keys[0], [2, 8, 2])
    t = JMLP.create(keys[1], [2, 8, 2])
    jflow = JMaskedAffine.create(jnp.asarray(b), t=t, s=s)
    tflow = tflows.MaskedAffineFlow(torch.from_numpy(b), t=MLP([2, 8, 2]),
                                    s=MLP([2, 8, 2]))
    sd = export_state_dict(jflow)
    return jflow, nt.load_reference_state_dict(tflow, sd), sd


@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_masked_affine_flow_matches_jax(method):
    jflow, tflow, _ = _masked_affine_pair()
    x = _inputs(seed=4)
    zj, lj = getattr(jflow, method)(jnp.asarray(x))
    with torch.no_grad():
        zt, lt = getattr(tflow, method)(torch.from_numpy(x))
    _close(zt, zj)
    _close(lt, lj)


@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_masked_affine_nan_guard_matches_jax(method):
    """A scale net whose output overflows to inf: the guard turns it into
    NaN, in the same places in both frameworks."""
    _, _, sd = _masked_affine_pair()
    sd = dict(sd)
    bias = np.array(sd["s.net.2.bias"])
    bias[1] = np.inf
    sd["s.net.2.bias"] = bias
    jflow = import_state_dict(_masked_affine_pair()[0], sd)
    tflow = nt.load_reference_state_dict(_masked_affine_pair()[1], sd)
    x = _inputs(seed=5)
    zj, lj = getattr(jflow, method)(jnp.asarray(x))
    with torch.no_grad():
        zt, lt = getattr(tflow, method)(torch.from_numpy(x))
    assert np.isnan(np.asarray(zj)).any() and np.isnan(np.asarray(lj)).all()
    np.testing.assert_array_equal(np.isnan(zt.numpy()),
                                  np.isnan(np.asarray(zj)))
    np.testing.assert_array_equal(np.isnan(lt.numpy()),
                                  np.isnan(np.asarray(lj)))
    _close(np.nan_to_num(zt.numpy()), np.nan_to_num(np.asarray(zj)))


@pytest.mark.parametrize("method", ["forward", "inverse"])
@pytest.mark.parametrize("shape", [(3,), (2, 4, 1)])
def test_affine_const_flow_matches_jax(shape, method):
    rng = np.random.default_rng(6)
    jflow = JAffineConst.create(shape)
    jflow = jflow.replace(
        s=jnp.asarray(rng.standard_normal((1,) + shape), jnp.float32) * 0.3,
        t=jnp.asarray(rng.standard_normal((1,) + shape), jnp.float32))
    tflow = nt.load_reference_state_dict(tflows.AffineConstFlow(shape),
                                         export_state_dict(jflow))
    # (2, 4, 1): the last axis broadcasts over 5 positions
    x_shape = (16, 3) if shape == (3,) else (16, 2, 4, 5)
    x = rng.standard_normal(x_shape).astype(np.float32)
    zj, lj = getattr(jflow, method)(jnp.asarray(x))
    with torch.no_grad():
        zt, lt = getattr(tflow, method)(torch.from_numpy(x))
    _close(zt, zj)
    _close(lt, lj)


def test_two_modes_matches_jax():
    z = _inputs(seed=7)
    _close(nt.TwoModes().log_prob(torch.from_numpy(z)),
           JTwoModes().log_prob(jnp.asarray(z)))
    _close(nt.TwoModes(loc=1.5, scale=0.3).log_prob(torch.from_numpy(z)),
           JTwoModes(loc=1.5, scale=0.3).log_prob(jnp.asarray(z)))


# --- the model, ActNorm and its data-dependent initialisation ---------------

@pytest.mark.parametrize("method", ["inverse_and_log_det",
                                    "forward_and_log_det"])
def test_model_matches_jax(method):
    jmodel, tmodel, _ = _pair()
    x = _inputs(seed=8)
    zj, lj = getattr(jmodel, method)(jnp.asarray(x))
    with torch.no_grad():
        zt, lt = getattr(tmodel, method)(torch.from_numpy(x))
    _close(zt, zj)
    _close(lt, lj)
    assert float(np.abs(np.asarray(zj) - x).max()) > 0.1


def _actnorm_state(tmodel):
    return {k: v for k, v in tmodel.state_dict().items()
            if k.endswith((".s", ".t", "data_dep_init_done"))
            and "net" not in k}


def _jax_actnorm_state(jmodel, tmodel):
    sd = export_state_dict(jmodel)
    return {k: sd[k] for k in _actnorm_state(tmodel)}


def test_init_from_data_matches_jax():
    """ActNorm set from the same numpy batch along the inverse direction:
    the parameters and the log-density after it."""
    jmodel, tmodel, _ = _pair()
    x = _inputs(seed=9)
    jinit = jmodel.init_from_data(jnp.asarray(x))
    params = [p for p in tmodel.parameters()]
    assert tmodel.init_from_data(torch.from_numpy(x)) is tmodel
    assert all(a is b for a, b in zip(params, tmodel.parameters()))
    want = _jax_actnorm_state(jinit, tmodel)
    got = _actnorm_state(tmodel)
    assert len(got) == 3 * SMALL["K"]
    for k, v in got.items():
        _close(v, want[k])
        if k.endswith("data_dep_init_done"):
            assert float(v) == 1.0
    x2 = _inputs(seed=10)
    with torch.no_grad():
        _close(tmodel.log_prob(torch.from_numpy(x2)),
               jinit.log_prob(jnp.asarray(x2)))
    # a second pass leaves set layers as they are
    before = {k: v.clone() for k, v in _actnorm_state(tmodel).items()}
    tmodel.init_from_data(torch.from_numpy(x2))
    for k, v in _actnorm_state(tmodel).items():
        assert torch.equal(v, before[k])


def test_init_from_samples_matches_jax():
    """ActNorm set along the sampling direction from the same base
    draws."""
    jmodel, tmodel, _ = _pair()
    eps = np.random.default_rng(11).standard_normal((512, 2)).astype(
        np.float32)
    jinit = jax_fixed(jmodel, eps, JTwoModes()).init_from_samples(
        jax.random.PRNGKey(0), 512)
    tinit = torch_fixed(tmodel, eps, nt.TwoModes()).init_from_samples(512)
    want = _jax_actnorm_state(jinit, tinit)
    for k, v in _actnorm_state(tinit).items():
        _close(v, want[k])
    with torch.no_grad():
        z, log_q = tinit.sample(512)
    zj, lqj = jinit.sample(jax.random.PRNGKey(0), 512)
    _close(z, zj)
    _close(log_q, lqj)
    # the sampling direction is now standardised layer by layer
    assert float(z.std(0).max()) < 5.0


def test_actnorm_forward_reads_no_flag():
    """``forward`` and ``inverse`` run the same whatever the flag says:
    it is read only by the initialisation pass."""
    layer = tflows.ActNorm(2)
    with torch.no_grad():
        layer.s.copy_(torch.tensor([[0.3, -0.2]]))
        layer.t.copy_(torch.tensor([[1.0, 2.0]]))
    x = torch.from_numpy(_inputs(seed=12))
    with torch.no_grad():
        a = layer.forward(x)
        layer.data_dep_init_done.fill_(1.0)
        b = layer.forward(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --- Scanned -----------------------------------------------------------------

def test_scan_loads_the_same_export_and_is_bitwise_unrolled():
    jmodel, tmodel, sd = _pair()
    scanned = nt.load_reference_state_dict(
        nt.build_realnvp(device="cpu", scan=True, **SMALL), sd)
    assert isinstance(scanned.flows[0], tflows.Scanned)
    assert len(scanned.flows[0].units) == SMALL["K"] // 2
    x = torch.from_numpy(_inputs(seed=13))
    with torch.no_grad():
        for method in ("log_prob", "forward_and_log_det",
                       "inverse_and_log_det"):
            a, b = getattr(tmodel, method)(x), getattr(scanned, method)(x)
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(u, v), method
        a = tmodel.sample(64, generator=torch.Generator().manual_seed(0))
        b = scanned.sample(64, generator=torch.Generator().manual_seed(0))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        # Scanned alone runs its units' layers in order
        z, ld = scanned.flows[0].inverse(x)
        zu, ldu = tmodel.inverse_and_log_det(x)
        assert torch.equal(z, zu) and torch.equal(ld, ldu)
    jscan = import_state_dict(jmodels.build_realnvp(
        jax.random.PRNGKey(0), scan=True, **SMALL), sd)
    _close(scanned.log_prob(x).detach(), jscan.log_prob(jnp.asarray(
        x.numpy())))
    # the data-dependent pass opens the scan too
    xs = _inputs(seed=14)
    tmodel.init_from_data(torch.from_numpy(xs))
    scanned.init_from_data(torch.from_numpy(xs))
    with torch.no_grad():
        assert torch.equal(tmodel.log_prob(x), scanned.log_prob(x))


def test_scanned_refuses_what_it_cannot_run():
    mlp = lambda: MLP([2, 4, 2])  # noqa: E731
    b = torch.tensor([1.0, 0.0])
    with pytest.raises(ValueError, match="identical"):
        tflows.Scanned([tflows.MaskedAffineFlow(b, t=mlp(), s=mlp()),
                        tflows.ActNorm(2)])
    # remat=True arrived with Glow: it runs, its units checkpointed
    assert tflows.Scanned([tflows.ActNorm(2)], remat=True).remat
    with pytest.raises(ValueError, match="even K"):
        nt.build_realnvp(device="cpu", K=3, scan=True)


# --- the variational losses and step ----------------------------------------

@pytest.mark.parametrize("dreg", [False, True])
@pytest.mark.parametrize("alpha", [0.5, 2.0])
def test_reverse_alpha_div_matches_jax(alpha, dreg):
    jmodel, tmodel, _ = _pair()
    eps = np.random.default_rng(15).standard_normal((BATCH, 2)).astype(
        np.float32) * 0.5
    params, static = partition(jax_fixed(jmodel, eps, JTwoModes()))
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).reverse_alpha_div(
            jax.random.PRNGKey(0), BATCH, alpha=alpha, dreg=dreg)))(params)
    want = export_state_dict(combine(grads, static))
    m = torch_fixed(tmodel, eps, nt.TwoModes())
    loss_t = m.reverse_alpha_div(BATCH, alpha=alpha, dreg=dreg)
    loss_t.backward()
    # the importance weights put most of the loss on a few draws (|loss|
    # reaches ~100 at alpha = 2): held like a gradient, relative to
    # max(|loss|, 1)
    _grad_close(float(loss_t.detach()), float(loss_j))
    named = dict(m.named_parameters())
    assert named
    for name, p in named.items():
        assert p.grad is not None, name
        _grad_close(p.grad, want[name])


@pytest.mark.parametrize("score_fn", [True, False])
def test_reverse_kld_matches_jax(score_fn):
    jmodel, tmodel, _ = _pair()
    eps = np.random.default_rng(16).standard_normal((BATCH, 2)).astype(
        np.float32)
    params, static = partition(jax_fixed(jmodel, eps, JTwoModes()))
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).reverse_kld(
            jax.random.PRNGKey(0), BATCH, beta=0.3,
            score_fn=score_fn)))(params)
    want = export_state_dict(combine(grads, static))
    m = torch_fixed(tmodel, eps, nt.TwoModes())
    loss_t = m.reverse_kld(BATCH, beta=0.3, score_fn=score_fn)
    loss_t.backward()
    _close(float(loss_t.detach()), float(loss_j))
    for name, p in m.named_parameters():
        _grad_close(p.grad, want[name])


def test_annealed_reverse_kld_steps_match_jax():
    """Three SGD steps of the annealed reverse-KLD step
    (``examples/real_nvp.py``: ``beta = min(1, 0.01 + step / anneal)``)
    against the JAX step with ``optax.sgd`` on a one-device mesh, after
    ``init_from_samples`` on both."""
    lr, anneal = 0.05, 2
    jmodel, tmodel, _ = _pair()
    eps = np.random.default_rng(17).standard_normal((BATCH, 2)).astype(
        np.float32)
    jm = jax_fixed(jmodel, eps, JTwoModes()).init_from_samples(
        jax.random.PRNGKey(0), BATCH)
    tm = torch_fixed(tmodel, eps, nt.TwoModes()).init_from_samples(BATCH)
    jopt = optax.sgd(lr)
    jstate, static = jpar.init_train_state(jm, jopt)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstep = jpar.make_reverse_kld_step(
        static, jopt, mesh, num_samples=BATCH,
        beta_schedule=lambda s: jnp.minimum(1.0, 0.01 + s / anneal))
    topt = torch.optim.SGD(tm.parameters(), lr=lr)
    tstate = nt.init_train_state(tm, topt)
    tstep = nt.make_reverse_kld_step(
        topt, num_samples=BATCH,
        beta_schedule=lambda s: min(1.0, 0.01 + s / anneal))
    for _ in range(3):
        jstate, loss_j = jstep(jstate, jax.random.PRNGKey(0))
        loss_t = tstep(tstate, None)
        _close(float(loss_t), float(loss_j))
    assert tstate.step == int(jstate.step) == 3
    want = export_state_dict(jpar.model_of_state(jstate, static))
    for name, p in tm.named_parameters():
        _close(p.detach().numpy(), want[name])


# --- the builder -------------------------------------------------------------

def test_builder_defaults():
    m = nt.build_realnvp(device="cpu")
    assert len(m.flows) == 128 and isinstance(m.p, nt.TwoModes)
    assert isinstance(m.flows[0], tflows.MaskedAffineFlow)
    assert isinstance(m.flows[1], tflows.ActNorm)
    assert [lin.weight.shape[0] for lin in m.flows[0].s.net
            if hasattr(lin, "weight")] == [64, 64, 2]
    x = torch.from_numpy(_inputs(seed=18))
    with torch.no_grad():
        z, ld = m.inverse_and_log_det(x)
    assert torch.equal(z, x) and float(ld.abs().max()) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nt.build_realnvp()


def test_mixed_precision_matches_jax_bf16():
    """``mixed_precision=True`` wraps ``s`` and ``t``: the export loads,
    and the log-density agrees with the JAX package's bf16 model within
    its bar."""
    jmodel = jmodels.build_realnvp(jax.random.PRNGKey(0),
                                   mixed_precision=True, **SMALL)
    _, _, sd = _pair()
    jmodel = import_state_dict(jmodel, sd)
    tmodel = nt.load_reference_state_dict(
        nt.build_realnvp(device="cpu", mixed_precision=True, **SMALL), sd)
    assert isinstance(tmodel.flows[0].s, nt.MixedPrecision)
    x = _inputs(seed=19)
    with torch.no_grad():
        got = tmodel.log_prob(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.log_prob(jnp.asarray(x)))
    assert np.all(np.abs(got - want) <= MIXED_TOL + MIXED_TOL * np.abs(want))
