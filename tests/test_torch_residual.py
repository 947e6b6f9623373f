"""The port's residual flows (``nf_tpu_torch.build_residual``, ``Residual``,
``iResBlock``, the Lipschitz nets and ``update_lipschitz``) against the
JAX package, on the CPU.

Small sizes: nets [d, 16, 16, d] (convolutions 2 -> 4 -> 2 channels on
4 x 4 images), K = 2 blocks, B = 64. The JAX modules' trainable arrays are
moved off their init with numpy noise, their power iterations advanced
200 steps on the new weights (so the Lipschitz bound holds), and the
result crosses to the port through the reference-named state dict of
:func:`residual_state_dict` (the JAX exporter has no entry for an
iResBlock or an induced-norm layer). The two frameworks draw different
numbers, so no draw is compared: the stochastic estimators get the JAX
block's own probe and coefficients (``k_eps, k_n = split(key)``,
``normal(k_eps, x.shape)``, ``block._sample_coeffs(k_n)``) on both sides,
and the sampled-length estimator's unbiasedness is held statistically
against the exact 2D log-det, as ``tests/test_residual.py`` holds JAX's.
Tolerances: 1e-4 abs on outputs and log-dets; gradients 1e-4 after
dividing by max(max |gradient|, 1); the forward-KLD step's loss 1e-5.
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
from nf_tpu.core import _split_keys
from nf_tpu.nets import InducedNormConv2d as JConv
from nf_tpu.nets import InducedNormLinear as JLinear
from nf_tpu.nets import LipschitzCNN as JLipschitzCNN
from nf_tpu.nets import LipschitzMLP as JLipschitzMLP
from nf_tpu.nets.lipschitz import Swish as JSwish
from nf_tpu.utils import update_lipschitz as jupdate_lipschitz
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.nets import InducedNormConv2d, InducedNormLinear
from nf_tpu_torch.nets import LipschitzCNN, LipschitzMLP
from nf_tpu_torch.utils import lipschitz_scales, update_lipschitz

TOL = 1e-4
LOSS_TOL = 1e-5
BATCH = 64
SMALL = dict(K=2, hidden=16, n_hidden_layers=2)
ORDERS = [(2.0, 2.0), (1.5, 3.0), (1.0, float("inf"))]


def _np(a):
    return np.asarray(a, dtype=np.asarray(a).dtype)


def induced_state_dict(layer, prefix=""):
    sd = {prefix + "weight": _np(layer.weight), prefix + "u": _np(layer.u),
          prefix + "v": _np(layer.v)}
    if layer.bias is not None:
        sd[prefix + "bias"] = _np(layer.bias)
    return sd


def lipschitz_state_dict(net, prefix=""):
    """A JAX ``LipschitzMLP`` / ``LipschitzCNN`` under the reference's
    names: ``net.{i}.`` (Swish ``beta``; the induced-norm layers)."""
    sd = {}
    for i, layer in enumerate(net.layers):
        p = f"{prefix}net.{i}."
        if isinstance(layer, JSwish):
            sd[p + "beta"] = _np(layer.beta)
        else:
            sd.update(induced_state_dict(layer, p))
    return sd


def residual_state_dict(flow, prefix=""):
    """A JAX ``Residual`` under the reference's names."""
    block = flow.iresblock
    p = prefix + "iresblock."
    sd = {p + "geom_p": _np(block.geom_p_logit), p + "lamb": _np(block.lamb)}
    sd.update(lipschitz_state_dict(block.nnet, p + "nnet."))
    return sd


def model_state_dict(jmodel, actnorm_set=True):
    """A JAX ``build_residual`` model: each Residual, each ActNorm (the
    exporter; ``actnorm_set=False`` marks them unset) and the base."""
    sd = {}
    for i, flow in enumerate(jmodel.flows):
        if isinstance(flow, jflows.Residual):
            sd.update(residual_state_dict(flow, f"flows.{i}."))
        else:
            for k, v in export_state_dict(flow).items():
                sd[f"flows.{i}.{k}"] = np.asarray(v)
            if not actnorm_set:
                sd[f"flows.{i}.data_dep_init_done"] = np.float32(0.0)
    for k, v in export_state_dict(jmodel.q0).items():
        sd["q0." + k] = np.asarray(v)
    return sd


def perturb(jmodule, seed, scale=0.3):
    """Every trainable array plus N(0, scale²) numpy noise, then 200 power
    iteration steps on the new weights."""
    rng = np.random.default_rng(seed)
    params, static = partition(jmodule)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(scale * rng.standard_normal(a.shape),
                                  a.dtype), params)
    return jupdate_lipschitz(combine(params, static), 200)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a),
                               np.asarray(b), atol=tol, rtol=0)


def _rel_close(got, want, tol=TOL):
    """``got`` None is a gradient autograd never reached: zero."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else np.asarray(
        got.detach() if torch.is_tensor(got) else got)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert float(np.max(np.abs(got - want))) / scale <= tol


def _inputs(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


# --- the Lipschitz layers -------------------------------------------------

@pytest.mark.parametrize("order", ORDERS, ids=str)
def test_induced_norm_linear_matches_jax(order):
    domain, codomain = order
    jl = JLinear.create(jax.random.PRNGKey(1), 6, 5, coeff=0.9,
                        domain=domain, codomain=codomain)
    jl = perturb(jl, 1)
    tl = _load(InducedNormLinear(6, 5, coeff=0.9, domain=domain,
                                 codomain=codomain), induced_state_dict(jl))
    x = _inputs((BATCH, 6))
    _close(tl(_t(x)), jl(jnp.asarray(x)))
    _close(tl.scale, jl.scale)
    jl = jl.update_power_iteration(7)
    tl.update_power_iteration(7)
    _close(tl.u, jl.u)
    _close(tl.v, jl.v)
    _close(tl(_t(x)), jl(jnp.asarray(x)))


@pytest.mark.parametrize("kernel", [3, 1])
@pytest.mark.parametrize("order", ORDERS[:2], ids=str)
def test_induced_norm_conv2d_matches_jax(order, kernel):
    domain, codomain = order
    jl = JConv.create(jax.random.PRNGKey(2), 2, 3, kernel, (4, 4),
                      coeff=0.9, domain=domain, codomain=codomain)
    jl = perturb(jl, 2)
    tl = _load(InducedNormConv2d(2, 3, kernel, (4, 4), coeff=0.9,
                                 domain=domain, codomain=codomain),
               induced_state_dict(jl))
    x = _inputs((3, 2, 4, 4))
    _close(tl(_t(x)), jl(jnp.asarray(x)))
    jl = jl.update_power_iteration(5)
    tl.update_power_iteration(5)
    _close(tl.u, jl.u)
    _close(tl.v, jl.v)
    _close(tl(_t(x)), jl(jnp.asarray(x)))


def test_norm_helpers_match_jax():
    """The (p, q) projections, ``vector_norm``, ``projmax``, ``leaky_elu``
    and ``asym_squash`` on the same vector."""
    from nf_tpu.nets import lipschitz as jl
    from nf_tpu_torch.nets import lipschitz as tl

    v = _inputs((9,), seed=40)
    v[3] = 0.0  # a zero entry: its phase is 1
    for order in (1.0, 1.5, 2.0, 3.0, float("inf")):
        if order != float("inf"):
            _close(tl.normalize_v(_t(v), order),
                   jl.normalize_v(jnp.asarray(v), order))
        _close(tl.normalize_u(_t(v), order),
               jl.normalize_u(jnp.asarray(v), order))
    _close(tl.vector_norm(_t(v), 1.5), jl.vector_norm(jnp.asarray(v), 1.5))
    _close(tl.projmax(_t(v)), jl.projmax(jnp.asarray(v)))
    _close(tl.leaky_elu(_t(v)), jl.leaky_elu(jnp.asarray(v)))
    _close(tl.asym_squash(_t(v)), jl.asym_squash(jnp.asarray(v)))


def test_induced_norm_linear_bound_and_buffers_in_place():
    """sigma of the effective weight stays at the bound, and the power
    iteration writes ``u`` and ``v`` at their addresses."""
    layer = InducedNormLinear(8, 8, coeff=0.9,
                              generator=torch.Generator().manual_seed(0))
    sigma = torch.linalg.matrix_norm(layer._effective_weight().detach(),
                                     ord=2)
    assert float(sigma) <= 0.9 * 1.05
    ptrs = (layer.u.data_ptr(), layer.v.data_ptr())
    with torch.no_grad():
        layer.weight.mul_(3.0)
    update_lipschitz(layer, 50)
    assert (layer.u.data_ptr(), layer.v.data_ptr()) == ptrs
    sigma = torch.linalg.matrix_norm(layer._effective_weight().detach(),
                                     ord=2)
    assert float(sigma) <= 0.9 * 1.05


def test_lipschitz_cnn_matches_jax():
    jn = perturb(JLipschitzCNN.create(jax.random.PRNGKey(3), [2, 4, 2],
                                      kernel_size=[3, 1],
                                      spatial_dims=(4, 4)), 3)
    tn = _load(LipschitzCNN([2, 4, 2], kernel_size=[3, 1],
                            spatial_dims=(4, 4)), lipschitz_state_dict(jn))
    x = _inputs((3, 2, 4, 4))
    _close(tn(_t(x)), jn(jnp.asarray(x)))


def _model_pair(seed=0, **kw):
    kw = {**SMALL, **kw}
    jmodel = perturb(jmodels.build_residual(jax.random.PRNGKey(seed), **kw),
                     seed)
    tmodel = nt.load_reference_state_dict(
        nt.build_residual(device="cpu", **kw), model_state_dict(jmodel))
    return jmodel, tmodel


def test_update_lipschitz_matches_jax():
    jmodel, tmodel = _model_pair(seed=4)
    rng = np.random.default_rng(5)
    with torch.no_grad():  # the same weight change on both sides
        params, static = partition(jmodel)
        noise = jax.tree_util.tree_map(
            lambda a: np.asarray(0.2 * rng.standard_normal(a.shape),
                                 np.float32), params)
        jmodel = combine(jax.tree_util.tree_map(jnp.add, params, noise),
                         static)
        tmodel2 = nt.load_reference_state_dict(
            nt.build_residual(device="cpu", **SMALL),
            model_state_dict(jmodel))
    jmodel = jupdate_lipschitz(jmodel, 10)
    assert update_lipschitz(tmodel2, 10) is tmodel2
    want = model_state_dict(jmodel)
    got = tmodel2.state_dict()
    for k, v in want.items():
        _close(got[k], v)
    assert len(lipschitz_scales(tmodel2)) == 2 * 3
    del tmodel


# --- the block: estimators, exact log-dets, the fixed point ---------------

def _block_pair(dim=2, seed=6, conv=False, **kw):
    key = jax.random.PRNGKey(seed)
    if conv:
        jnet = JLipschitzCNN.create(key, [2, 4, 2], kernel_size=[3, 1],
                                    spatial_dims=(4, 4), lipschitz_const=0.9)
        tnet = LipschitzCNN([2, 4, 2], kernel_size=[3, 1],
                            spatial_dims=(4, 4), lipschitz_const=0.9)
    else:
        jnet = JLipschitzMLP.create(key, [dim, 16, 16, dim],
                                    lipschitz_const=0.9)
        tnet = LipschitzMLP([dim, 16, 16, dim], lipschitz_const=0.9)
    jflow = perturb(jflows.Residual.create(jnet, **kw), seed)
    tflow = _load(tflows.Residual(tnet, **kw), residual_state_dict(jflow))
    return jflow.iresblock, tflow.iresblock


def _probes(jblock, key, shape):
    k_eps, k_n = jax.random.split(key)
    vareps = jax.random.normal(k_eps, shape, jnp.float32)
    return vareps, jblock._sample_coeffs(k_n)


def _param_grads(jgrads, tblock):
    """(JAX gradient, port gradient) pairs of the net's parameters."""
    jnet = jgrads.nnet
    pairs = []
    for i, layer in enumerate(jnet.layers):
        tl = tblock.nnet.net[i]
        names = ("beta",) if isinstance(layer, JSwish) else ("weight",
                                                              "bias")
        for n in names:
            pairs.append((getattr(layer, n), getattr(tl, n).grad))
    return pairs


@pytest.mark.parametrize("n_dist", ["geometric", "poisson"])
@pytest.mark.parametrize("estimator", ["basic", "neumann", "neumann_remat",
                                       "conv_basic"])
def test_hutchinson_series_matches_jax_on_injected_probes(estimator,
                                                          n_dist):
    conv = estimator == "conv_basic"
    jblock, tblock = _block_pair(conv=conv, n_dist=n_dist,
                                 reduce_memory=estimator != "basic"
                                 and not conv)
    if estimator == "neumann":  # the Neumann gradient, not checkpointed
        jblock = jblock.replace(grad_in_forward=False)
        tblock.grad_in_forward = False
    shape = (8, 2, 4, 4) if conv else (BATCH, 2)
    x = _inputs(shape, seed=7, scale=0.8)
    # the first key whose sampled series runs past its exact terms
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(8, 40))
               if float(jnp.sum(_probes(jblock, k, shape)[1][3:])) > 0)
    vareps, coeffs = _probes(jblock, key, shape)

    def jloss(b, xx):
        g, ld = b._logdetgrad(xx, key)
        return jnp.sum(ld) + jnp.sum(jnp.sin(g)), (g, ld)

    (_, (g, ld)), (jg_block, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jblock, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    tg, tld = tblock.hutchinson(xt, _t(vareps), _t(coeffs))
    (torch.sum(tld) + torch.sum(torch.sin(tg))).backward()
    _close(tg, g)
    _close(tld, ld)
    _rel_close(xt.grad, jg_x)
    for want, got in _param_grads(jg_block, tblock):
        _rel_close(got, want)


def test_series_coefficients_match_jax_for_given_lengths():
    """The russian-roulette coefficients from the same series lengths, and
    the tail probabilities, against JAX's formulas."""
    from nf_tpu.flows.residual import geometric_1mcdf as jgeo
    from nf_tpu.flows.residual import poisson_1mcdf as jpoi
    from nf_tpu_torch.flows.residual import geometric_1mcdf, poisson_1mcdf

    ks = np.arange(1, 25)
    _close(geometric_1mcdf(torch.tensor(0.3), _t(ks), 2),
           jgeo(0.3, jnp.asarray(ks), 2))
    _close(poisson_1mcdf(torch.tensor(2.0), _t(ks), 2, 24),
           jpoi(jnp.asarray(2.0), jnp.asarray(ks), 2, 24))
    # the geometric lengths by inversion: support from 1, mean 1/p
    block = tflows.iResBlock(LipschitzMLP([2, 4, 2]), n_samples=200000)
    gen = torch.Generator().manual_seed(0)
    p = float(torch.sigmoid(block.geom_p.detach()))
    u = torch.rand((200000,), generator=gen)
    n = torch.floor(torch.log1p(-u) / torch.log1p(torch.tensor(-p))) + 1
    assert float(n.min()) >= 1
    assert abs(float(n.mean()) - 1 / p) < 0.02


@pytest.mark.parametrize("mode", ["brute_force", "exact_trace"])
def test_exact_log_dets_match_jax(mode):
    dim = 2 if mode == "brute_force" else 3
    jblock, tblock = _block_pair(dim=dim, seed=9, **{mode: True})
    x = _inputs((BATCH, dim), seed=10, scale=0.8)
    g, ld = jblock._logdetgrad(jnp.asarray(x), None)

    def jloss(b):
        return jnp.sum(b._logdetgrad(jnp.asarray(x), None)[1])

    jg = jax.grad(jloss)(jblock)
    tg, tld = tblock._logdetgrad(_t(x), None)
    torch.sum(tld).backward()
    _close(tg, g)
    _close(tld, ld)
    for want, got in _param_grads(jg, tblock):
        _rel_close(got, want)


def test_brute_force_is_the_jacobian_log_det():
    _, tblock = _block_pair(seed=11, brute_force=True)
    x = _t(_inputs((16, 2), seed=12))
    _, ld = tblock._logdetgrad(x, None)
    for i in range(16):
        jac = torch.autograd.functional.jacobian(
            lambda v: v + tblock.nnet(v[None])[0], x[i])
        assert abs(float(torch.linalg.slogdet(jac)[1] - ld[i].detach())) \
            < 1e-5


def test_fixed_point_inverse_and_implicit_vjp_match_jax():
    from nf_tpu.flows.residual import _fp_inverse

    jblock, tblock = _block_pair(seed=13, reduce_memory=False)
    y = _inputs((BATCH, 2), seed=14, scale=1.5)

    def jloss(b, yy):
        x = _fp_inverse(b, yy)
        return jnp.sum(jnp.sin(x) * x), x

    (_, x), (jg_block, jg_y) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jblock, jnp.asarray(y))
    yt = _t(y).requires_grad_(True)
    xt = tblock.inverse(yt)
    torch.sum(torch.sin(xt) * xt).backward()
    _close(xt, x)
    _close(xt + tblock.nnet(xt), y)  # x = y - g(x)
    _rel_close(yt.grad, jg_y)
    for want, got in _param_grads(jg_block, tblock):
        _rel_close(got, want)
    (it, vjp_it, unconverged), = tflows.fixed_point_stats(tblock)
    assert it > 1 and vjp_it > 1 and not unconverged


def test_fixed_point_checks_every_chunk_and_stops_at_jax_count(monkeypatch):
    """The eager loop's result does not depend on how often the host
    reads the test: a frozen state stays frozen."""
    from nf_tpu_torch.flows import residual

    _, tblock = _block_pair(seed=15)
    y = _t(_inputs((BATCH, 2), seed=16, scale=1.5))
    x1 = tblock.inverse(y)
    it1 = int(tblock.fixed_point_iterations)
    monkeypatch.setattr(residual, "FIXED_POINT_CHECK_EVERY", 1)
    x2 = tblock.inverse(y)
    assert torch.equal(x1, x2)
    assert int(tblock.fixed_point_iterations) == it1


# --- whole models ------------------------------------------------------------

def test_build_residual_log_prob_and_sample_match_jax():
    jmodel, tmodel = _model_pair(seed=17)
    jexact = jflows.set_exact_logdet(jmodel)
    assert tflows.set_exact_logdet(tmodel) is tmodel
    x = _inputs((BATCH, 2), seed=18, scale=1.5)
    _close(tmodel.log_prob(_t(x)), jexact.log_prob(jnp.asarray(x)))
    z0 = _inputs((BATCH, 2), seed=19)
    zj, ldj = jexact.forward_and_log_det(jnp.asarray(z0))
    zt, ldt = tmodel.forward_and_log_det(_t(z0))
    _close(zt, zj)
    _close(ldt, ldj)
    # the round trip, and the stochastic log-density needs a generator
    _close(tmodel.inverse(zt), z0)
    tflows.set_exact_logdet(tmodel, False)
    with pytest.raises(ValueError, match="generator"):
        tmodel.log_prob(_t(x))


def test_init_from_data_matches_jax():
    jmodel = perturb(jmodels.build_residual(jax.random.PRNGKey(20),
                                            **SMALL), 20)
    tmodel = nt.load_reference_state_dict(
        nt.build_residual(device="cpu", **SMALL),
        model_state_dict(jmodel, actnorm_set=False))
    x = _inputs((256, 2), seed=21, scale=1.5)
    jexact = jflows.set_exact_logdet(jmodel).init_from_data(jnp.asarray(x))
    tflows.set_exact_logdet(tmodel).init_from_data(_t(x))
    _close(tmodel.log_prob(_t(x)), jexact.log_prob(jnp.asarray(x)))


def _inject(tmodel, jmodel, key, batch):
    """Give each port block the probe and coefficients the JAX model's
    ``log_prob(x, key=key)`` draws for it."""
    keys = _split_keys(key, len(jmodel.flows))
    for i, (jf, tf) in enumerate(zip(jmodel.flows, tmodel.flows)):
        if isinstance(jf, jflows.Residual):
            v, c = _probes(jf.iresblock, keys[i], (batch, 2))
            tf.iresblock.draw = (lambda xx, gen, v=_t(v), c=_t(c): (v, c))


def test_forward_kld_step_with_key_and_post_update_matches_jax():
    jmodel, tmodel = _model_pair(seed=22)
    x = _inputs((BATCH, 2), seed=23, scale=1.5)
    key = jax.random.PRNGKey(24)
    _inject(tmodel, jmodel, key, BATCH)
    lr = 0.05

    params, static = partition(jmodel)
    jloss, jgrads = jax.value_and_grad(
        lambda p: combine(p, static).forward_kld(jnp.asarray(x),
                                                 key=key))(params)
    jnew = jupdate_lipschitz(combine(jax.tree_util.tree_map(
        lambda p, g: p - lr * g, params, jgrads), static), 5)

    opt = torch.optim.SGD(tmodel.parameters(), lr=lr)
    state = nt.init_train_state(tmodel, opt, carry_buffers=True)
    step = nt.make_forward_kld_step(
        opt, with_key=True, post_update=lambda m: update_lipschitz(m, 5))
    loss = step(state, _t(x), 0)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    jsd = model_state_dict(combine(jgrads, static))
    for name, p in tmodel.named_parameters():
        if p.grad is None:  # geom_p and lamb are used detached
            assert name.endswith(("geom_p", "lamb"))
            _close(jsd[name], np.zeros_like(jsd[name]))
            continue
        _rel_close(p.grad, jsd[name])
    got = tmodel.state_dict()
    for k, v in model_state_dict(jnew).items():
        _close(got[k], v)


def test_keyed_step_draws_from_its_seed():
    """The step's own generator is reseeded per call: one seed, one loss;
    another seed, another (eager, on twin models)."""
    _, base = _model_pair(seed=25)
    x = _t(_inputs((BATCH, 2), seed=26))
    losses = []
    for seed in (3, 3, 4):
        m = nt.build_residual(device="cpu", **SMALL)
        m.load_state_dict(base.state_dict())
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        step = nt.make_forward_kld_step(opt, with_key=True)
        losses.append(float(step(nt.init_train_state(m, opt), x, seed)))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(TypeError, match="integer seed"):
        step(nt.init_train_state(m, opt), x, 1.5)


def test_post_update_in_reverse_step_and_guard_restores_buffers():
    """``post_update`` runs after the update in the reverse step, and a
    discarded (non-finite) update discards its buffer changes too."""
    _, tmodel = _model_pair(seed=27)
    tmodel.p = nt.TwoModes()
    tflows.set_exact_logdet(tmodel)
    calls = []

    def post(m):
        calls.append(1)
        update_lipschitz(m, 3)

    opt = torch.optim.Adam(tmodel.parameters(), lr=1e-3)
    state = nt.init_train_state(tmodel, opt)
    step = nt.make_reverse_kld_step(opt, 64, post_update=post,
                                    skip_nonfinite=True)
    gen = torch.Generator().manual_seed(0)
    assert np.isfinite(float(step(state, gen)))
    assert calls == [1]
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tmodel.p = _NaNTarget()
    step(state, gen)
    assert calls == [1, 1]
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


class _NaNTarget(torch.nn.Module):
    def log_prob(self, z):
        return torch.full(z.shape[:1], float("nan"))


def test_reverse_kld_gradient_through_the_implicit_vjp_matches_jax():
    """One reverse-KLD loss on the same base draws (under the exact 2D
    log-det): samples by the fixed point, gradients through its implicit
    VJP."""
    from nf_tpu.distributions import TwoModes as JTwoModes

    jmodel, tmodel = _model_pair(seed=28)
    jmodel = jflows.set_exact_logdet(jmodel.replace(p=JTwoModes()))
    tmodel.p = nt.TwoModes()
    tflows.set_exact_logdet(tmodel)
    z0 = _inputs((BATCH, 2), seed=29)

    def jloss(p):
        m = combine(p, static)
        z, ld = m.forward_and_log_det(jnp.asarray(z0))
        log_q = m.q0.log_prob(jnp.asarray(z0)) - ld
        return jnp.mean(log_q) - jnp.mean(m.p.log_prob(z))

    params, static = partition(jmodel)
    jl, jg = jax.value_and_grad(jloss)(params)
    tmodel.q0.forward = lambda n, generator=None: (
        _t(z0), tmodel.q0.log_prob(_t(z0)))
    tl = tmodel.reverse_kld(BATCH)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= TOL
    jsd = model_state_dict(combine(jg, static))
    for name, p in tmodel.named_parameters():
        if p.grad is not None:
            _rel_close(p.grad, jsd[name])


def test_stochastic_estimator_is_unbiased_against_brute_force():
    """The sampled-length Hutchinson estimate's mean over points is close
    to the exact 2D log-det's (``tests/test_residual.py:166``)."""
    _, tmodel = _model_pair(seed=30)
    x = _t(_inputs((512, 2), seed=31))
    gen = torch.Generator().manual_seed(32)
    with torch.no_grad():
        _, ld_est = tmodel.inverse_and_log_det(x, generator=gen)
        tflows.set_exact_logdet(tmodel)
        _, ld_exact = tmodel.inverse_and_log_det(x)
    assert abs(float(ld_est.mean() - ld_exact.mean())) < 0.15


def test_re_pass_reuses_the_sampling_pass_probe_and_series_length():
    """Inside ``shared_masks()`` (the sticking-the-landing and DReG re-pass
    through the inverse chain) an iResBlock reuses the sampling pass's
    Hutchinson probe and series length, as the JAX block gets the flow's
    same key in both passes (``nf_tpu/core.py:130-140``): the block draws
    once, and the re-pass's log-det estimate at the point the sampling
    pass reached is that pass's, its sign flipped."""
    from nf_tpu_torch.nets._dropout import shared_masks

    _, tmodel = _model_pair(seed=33)
    flow = next(f for f in tmodel.flows if isinstance(f, tflows.Residual))
    z = _t(_inputs((BATCH, 2), seed=34))
    gen = torch.Generator().manual_seed(35)
    block, draws = flow.iresblock, []
    real = block.draw
    block.draw = lambda x, g: draws.append(x.shape) or real(x, g)
    with torch.no_grad(), shared_masks():
        x, ld_sampling = flow.forward(z, generator=gen)
        _, ld_re_pass = flow.inverse(x, generator=gen)
    assert len(draws) == 1
    assert torch.equal(ld_re_pass, -ld_sampling)


def test_reference_bookkeeping_buffers_load():
    jmodel, _ = _model_pair(seed=33)
    sd = model_state_dict(jmodel)
    sd["flows.0.iresblock.last_n_samples"] = np.zeros(1, np.float32)
    sd["flows.0.iresblock.nnet.net.1.scale"] = np.float32(0.5)
    nt.load_reference_state_dict(nt.build_residual(device="cpu", **SMALL),
                                 sd)
    sd["flows.0.iresblock.unknown"] = np.float32(0.0)
    with pytest.raises(KeyError):
        nt.load_reference_state_dict(
            nt.build_residual(device="cpu", **SMALL), sd)
