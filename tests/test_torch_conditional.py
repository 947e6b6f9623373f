"""The port's conditional NSF (``nf_tpu_torch.build_conditional_nsf``,
``ConditionalNormalizingFlow``, both ``ConditionalDiagGaussian``s and
serving with ``context_shape``) against the JAX package, on the CPU.

A small ``build_conditional_nsf`` (dim 2, context 3, K = 2, hidden 16, 4
bins) is built in JAX, its exported state dict perturbed with numpy noise
(N(0, 0.2²); with the identity init every spline is the identity), and
loaded into both the JAX model and the port's. Inputs and contexts come
from a numpy seed. Tolerance: 1e-4 abs on outputs, log-dets and
log-densities, and on gradients divided by ``max(max |gradient|, 1)``
(the JAX package's bar). The reverse KLD feeds both frameworks the same
base draws: each side's ``DiagGaussian`` is made to return numpy's
``eps`` in place of its own draw. The JAX side runs its default CPU
dispatch, and, where marked, its fused head+spline Pallas kernel in
interpret mode; the port on the CPU runs its plain path either way.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.models as jmodels
import nf_tpu.serving as jserving
import nf_tpu_torch as nt
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import ConditionalNormalizingFlow as JConditionalFlow
from nf_tpu.distributions import ConditionalDiagGaussian as JCondBase
from nf_tpu.distributions import ConditionalDiagGaussianTarget as JCondTarget
from nf_tpu.distributions.base import DiagGaussian as JDiagGaussian
from nf_tpu.nets import MLP as JMLP
from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu.utils.module import Module, combine, partition
from nf_tpu_torch.compat import _head_to_bin_major
from nf_tpu_torch.distributions import ConditionalDiagGaussian
from nf_tpu_torch.distributions.base import _gaussian_sample
from nf_tpu_torch.nets import MLP
from nf_tpu_torch.nets.resnet import ResidualNet

TOL = 1e-4
CTX = 3
SMALL = dict(dim=2, context_size=CTX, K=2, hidden=16, num_bins=4)
BATCH = 300
_PAIR = {}


def _perturbed(sd, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _pair():
    """(JAX model, port model on the CPU, state dict), the same perturbed
    weights; built once."""
    if not _PAIR:
        jmodel = jmodels.build_conditional_nsf(jax.random.PRNGKey(0),
                                               **SMALL)
        sd = _perturbed(export_state_dict(jmodel), 0)
        _PAIR["pair"] = (import_state_dict(jmodel, sd),
                         nt.load_reference_state_dict(
                             nt.build_conditional_nsf(device="cpu", **SMALL),
                             sd), sd)
    return _PAIR["pair"]


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 2)) * 1.5).astype(np.float32)
    ctx = rng.standard_normal((n, CTX)).astype(np.float32)
    return x, ctx


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _grad_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _port_layout(tmodel, sd):
    """Reference-named arrays -> the port's layout (bin-major head rows)."""
    heads = {f"{name}.final_layer.": mod.bin_major_head
             for name, mod in tmodel.named_modules()
             if isinstance(mod, ResidualNet)
             and mod.bin_major_head is not None}
    out = {}
    for name, v in sd.items():
        head = heads.get(name[:name.rfind(".") + 1])
        out[name] = _head_to_bin_major(np.asarray(v), head) if head else \
            np.asarray(v)
    return out


def _with_dispatch(dispatch, fn):
    if dispatch == "fused_head_on":
        jshf.set_fused_head_mode("on")
    try:
        return fn()
    finally:
        jshf.set_fused_head_mode("auto")


@pytest.mark.parametrize("method", ["inverse_and_log_det",
                                    "forward_and_log_det", "log_prob"])
@pytest.mark.parametrize("jax_dispatch", ["default", "fused_head_on"])
def test_model_with_context_matches_jax(jax_dispatch, method):
    jmodel, tmodel, _ = _pair()
    x, ctx = _inputs(BATCH)
    want = _with_dispatch(jax_dispatch, lambda: getattr(jmodel, method)(
        jnp.asarray(x), context=jnp.asarray(ctx)))
    with torch.no_grad():
        got = getattr(tmodel, method)(torch.from_numpy(x),
                                      context=torch.from_numpy(ctx))
    if method == "log_prob":
        got, want = (None, got), (None, want)
    else:
        _close(got[0], want[0])
    _close(got[1], want[1])


def test_context_moves_the_density():
    """The context reaches the conditioners: two contexts give two
    densities, and the perturbed model is off the identity."""
    _, tmodel, _ = _pair()
    x, ctx = _inputs(BATCH)
    x, ctx = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        a = tmodel.log_prob(x, context=ctx)
        b = tmodel.log_prob(x, context=ctx + 1.0)
        z, _ = tmodel.inverse_and_log_det(x, context=ctx)
    assert float((a - b).abs().max()) > 0.1
    assert float((z - x).abs().max()) > 0.1


@pytest.mark.parametrize("jax_dispatch", ["default", "fused_head_on"])
def test_forward_kld_gradients_with_context_match_jax(jax_dispatch):
    jmodel, tmodel, _ = _pair()
    tmodel = copy.deepcopy(tmodel)
    x, ctx = _inputs(BATCH, seed=1)
    params, static = partition(jmodel)
    loss_j, grads = _with_dispatch(jax_dispatch, lambda: jax.jit(
        jax.value_and_grad(lambda p: combine(p, static).forward_kld(
            jnp.asarray(x), context=jnp.asarray(ctx))))(params))
    want = _port_layout(tmodel, export_state_dict(combine(grads, static)))
    loss_t = tmodel.forward_kld(torch.from_numpy(x),
                                context=torch.from_numpy(ctx))
    loss_t.backward()
    _close(float(loss_t.detach()), float(loss_j))
    named = dict(tmodel.named_parameters())
    assert named and set(named) <= set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _grad_close(p.grad, want[name])


def test_round_trip_and_sample_with_context():
    _, tmodel, _ = _pair()
    x, ctx = _inputs(BATCH, seed=2)
    x, ctx = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        z, ld_inv = tmodel.inverse_and_log_det(x, context=ctx)
        x2, ld_fwd = tmodel.forward_and_log_det(z, context=ctx)
        s, log_q = tmodel.sample(BATCH, generator=torch.Generator()
                                 .manual_seed(0), context=ctx)
        lp = tmodel.log_prob(s, context=ctx)
    _close(x2, x)
    _close(ld_fwd, -ld_inv)
    assert s.shape == (BATCH, 2) and torch.isfinite(s).all()
    _close(lp, log_q)


def test_sample_log_q_matches_jax_log_prob():
    """The port's samples' log q against the JAX model's density there."""
    jmodel, tmodel, _ = _pair()
    _, ctx = _inputs(BATCH, seed=3)
    with torch.no_grad():
        s, log_q = tmodel.sample(BATCH, generator=torch.Generator()
                                 .manual_seed(1),
                                 context=torch.from_numpy(ctx))
    _close(log_q, jmodel.log_prob(jnp.asarray(s.numpy()),
                                  context=jnp.asarray(ctx)))


# --- the base and the target of the name ConditionalDiagGaussian -----------

def _encoder_pair(seed=5):
    """A context encoder [3, 16, 4] with a zero-init last layer, perturbed
    by N(0, 0.05²): log-scales of order 1, so log-densities stay of order
    10, where float32 carries the 1e-4 bar."""
    jenc = JMLP.create(jax.random.PRNGKey(seed), [CTX, 16, 4],
                       init_zeros=True)
    sd = _perturbed(export_state_dict(jenc), seed, scale=0.05)
    jenc = import_state_dict(jenc, sd)
    tenc = nt.load_reference_state_dict(MLP([CTX, 16, 4]), sd)
    return jenc, tenc, sd


def test_conditional_base_log_prob_and_draws_match_jax():
    jenc, tenc, _ = _encoder_pair()
    jq = JCondBase.create(2, jenc)
    tq = ConditionalDiagGaussian(2, tenc)
    z, ctx = _inputs(BATCH, seed=6)
    with torch.no_grad():
        _close(tq.log_prob(torch.from_numpy(z), context=torch.from_numpy(ctx)),
               jq.log_prob(jnp.asarray(z), context=jnp.asarray(ctx)))
        s, log_p = tq.forward(BATCH, generator=torch.Generator()
                              .manual_seed(2), context=torch.from_numpy(ctx))
    _close(log_p, jq.log_prob(jnp.asarray(s.numpy()),
                              context=jnp.asarray(ctx)))


def test_flow_over_a_conditional_base_matches_jax():
    """A ConditionalNormalizingFlow whose base is a ConditionalDiagGaussian:
    the context reaches the base and every coupling. The JAX exporter has
    no rule for that base, so its encoder's names are joined by hand."""
    jmodel, tmodel, sd = _pair()
    jenc, tenc, enc_sd = _encoder_pair(7)
    jflow = JConditionalFlow.create(JCondBase.create(2, jenc), jmodel.flows)
    tflow = nt.ConditionalNormalizingFlow(
        ConditionalDiagGaussian(2, copy.deepcopy(tenc)),
        copy.deepcopy(list(tmodel.flows)))
    full = {k: v for k, v in sd.items() if not k.startswith("q0.")}
    full.update({f"q0.context_encoder.{k}": v for k, v in enc_sd.items()})
    nt.load_reference_state_dict(tflow, full)
    x, ctx = _inputs(BATCH, seed=8)
    with torch.no_grad():
        got = tflow.log_prob(torch.from_numpy(x),
                             context=torch.from_numpy(ctx))
    _close(got, jflow.log_prob(jnp.asarray(x), context=jnp.asarray(ctx)))


def test_conditional_target_matches_jax():
    rng = np.random.default_rng(9)
    z = rng.standard_normal((BATCH, 2)).astype(np.float32)
    ctx = np.concatenate([rng.uniform(-1, 1, (BATCH, 2)),
                          rng.uniform(0.5, 1.5, (BATCH, 2))],
                         axis=1).astype(np.float32)
    target = nt.ConditionalDiagGaussianTarget()
    _close(target.log_prob(torch.from_numpy(z), context=torch.from_numpy(ctx)),
           JCondTarget().log_prob(jnp.asarray(z), context=jnp.asarray(ctx)))
    s = target.sample(20000, generator=torch.Generator().manual_seed(3),
                      context=torch.from_numpy(np.tile(ctx[:1], (20000, 1))))
    # 20000 draws: the sample mean within ~4 standard errors of the mean
    np.testing.assert_allclose(s.mean(0).numpy(), ctx[0, :2],
                               atol=4 * 1.5 / np.sqrt(20000))
    np.testing.assert_allclose(s.std(0).numpy(), ctx[0, 2:], rtol=0.05)


# --- reverse KLD with a context, on shared base draws -----------------------

class JCtxTarget(Module):
    """A Gaussian whose mean is the context's first two columns and whose
    log-scale is its third (a context of 3 feeds the model and this)."""

    def log_prob(self, z, context=None):
        ls = context[:, 2:3]
        return -jnp.sum(ls + 0.5 * ((z - context[:, :2]) / jnp.exp(ls)) ** 2,
                        axis=-1)


class CtxTarget:
    def log_prob(self, z, context=None):
        ls = context[:, 2:3]
        return -torch.sum(ls + 0.5 * ((z - context[:, :2])
                                      / torch.exp(ls)) ** 2, dim=-1)


def jax_fixed(jmodel, eps, target):
    """``jmodel`` with ``target`` and a ``DiagGaussian`` base that draws
    ``eps`` (numpy) in place of its own draw."""
    class Fixed(JDiagGaussian):
        def forward(self, key, num_samples=1, context=None):
            e = jnp.asarray(eps)
            log_scale = self._log_scale()
            z = self._loc() + jnp.exp(log_scale) * e
            log_p = -0.5 * self.d * np.log(2 * np.pi) - jnp.sum(
                log_scale + 0.5 * e ** 2, axis=1)
            return z, log_p

    q = jmodel.q0
    fixed = Fixed(loc=q.loc, log_scale=q.log_scale, shape=q.shape,
                  trainable=q.trainable)
    return jmodel.replace(q0=fixed, p=target)


def torch_fixed(tmodel, eps, target):
    """A copy of ``tmodel`` with ``target`` and a ``DiagGaussian`` base
    that draws ``eps``."""
    m = copy.deepcopy(tmodel)
    m.p = target
    q = m.q0

    def forward(num_samples=1, generator=None, context=None):
        assert num_samples == eps.shape[0]
        return _gaussian_sample(q.loc, q.log_scale, torch.from_numpy(eps))

    q.forward = forward
    return m


@pytest.mark.parametrize("beta,score_fn", [(1.0, True), (0.4, True),
                                           (1.0, False)])
def test_reverse_kld_with_context_matches_jax(beta, score_fn):
    jmodel, tmodel, _ = _pair()
    rng = np.random.default_rng(10)
    eps = rng.standard_normal((BATCH, 2)).astype(np.float32)
    ctx = np.concatenate([rng.standard_normal((BATCH, 2)),
                          rng.uniform(-0.5, 0.5, (BATCH, 1))],
                         axis=1).astype(np.float32)
    params, static = partition(jax_fixed(jmodel, eps, JCtxTarget()))
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).reverse_kld(
            jax.random.PRNGKey(0), BATCH, beta=beta, score_fn=score_fn,
            context=jnp.asarray(ctx))))(params)
    want = _port_layout(tmodel, export_state_dict(combine(grads, static)))
    m = torch_fixed(tmodel, eps, CtxTarget())
    loss_t = m.reverse_kld(BATCH, beta=beta, score_fn=score_fn,
                           context=torch.from_numpy(ctx))
    loss_t.backward()
    _close(float(loss_t.detach()), float(loss_j))
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        _grad_close(p.grad, want[name])


# --- serving with a context --------------------------------------------------

@pytest.mark.parametrize("n", [1, 17, 100])
def test_compile_log_prob_with_context_matches_jax(n):
    jmodel, tmodel, _ = _pair()
    x, ctx = _inputs(n, seed=n)
    want = jserving.compile_log_prob(jmodel, (n, 2), context_shape=(n, CTX))(
        jnp.asarray(x), jnp.asarray(ctx))
    fn = nt.compile_log_prob(tmodel, (n, 2), context_shape=(n, CTX))
    got = fn(torch.from_numpy(x), torch.from_numpy(ctx))
    assert got.shape == (n,)
    _close(got, want)
    with pytest.raises(TypeError, match="inputs"):
        fn(torch.from_numpy(x))


def test_compiled_sampler_with_context_is_the_eager_sampler():
    """Bitwise the eager draws for a seed and context; the log q against
    the JAX model's density of the draws."""
    jmodel, tmodel, _ = _pair()
    _, ctx = _inputs(64, seed=11)
    fn = nt.compile_sampler(tmodel, 64, context_shape=(64, CTX))
    for seed, c in ((0, ctx), (7, ctx[::-1].copy()), (0, ctx)):
        z, log_q = fn(seed, torch.from_numpy(c))
        with torch.no_grad():
            ze, lqe = tmodel.sample(64, generator=torch.Generator()
                                    .manual_seed(seed),
                                    context=torch.from_numpy(c))
        assert torch.equal(z, ze) and torch.equal(log_q, lqe)
        _close(log_q, jmodel.log_prob(jnp.asarray(z.numpy()),
                                      context=jnp.asarray(c)))
    with pytest.raises(ValueError, match="temperature"):
        nt.compile_sampler(tmodel, 4, temperature=0.7, context_shape=(4, CTX))


@pytest.mark.parametrize("n", [1, 3, 17, 100])
def test_buckets_with_context_match_jax(n):
    jmodel, tmodel, _ = _pair()
    x, ctx = _inputs(n, seed=20 + n)
    jfn = jserving.compile_log_prob_buckets(jmodel, 100, (2,),
                                            context_shape=(CTX,))
    fn = nt.compile_log_prob_buckets(tmodel, 100, (2,),
                                     context_shape=(CTX,))
    got = fn(torch.from_numpy(x), torch.from_numpy(ctx))
    assert got.shape == (n,)
    _close(got, jfn(jnp.asarray(x), jnp.asarray(ctx)))


def test_bucket_pads_the_context_with_its_last_row():
    """A request of 3 rows in the bucket of 4: the padded row repeats the
    last row of x and of the context, so the 3 results are the eager
    model's on the request."""
    _, tmodel, _ = _pair()
    x, ctx = _inputs(3, seed=30)
    fn = nt.compile_log_prob_buckets(tmodel, 4, (2,), context_shape=(CTX,))
    got = fn(torch.from_numpy(x), torch.from_numpy(ctx))
    with torch.no_grad():
        want = tmodel.log_prob(torch.from_numpy(x),
                               context=torch.from_numpy(ctx))
    _close(got, want)
    with pytest.raises(ValueError, match="rows"):
        fn(torch.from_numpy(x), torch.from_numpy(ctx[:2]))
    with pytest.raises(TypeError, match="inputs"):
        fn(torch.from_numpy(x))


def test_forward_kld_step_on_a_context_batch_matches_jax():
    """One ``make_forward_kld_step`` with SGD on ``(x, context)`` against
    the JAX step with ``optax.sgd``."""
    import optax

    import nf_tpu.parallel as jpar

    lr = 0.05
    jmodel, tmodel, _ = _pair()
    tmodel = copy.deepcopy(tmodel)
    x, ctx = _inputs(BATCH, seed=12)
    jopt = optax.sgd(lr)
    jstate, static = jpar.init_train_state(jmodel, jopt)
    jstep = jpar.make_forward_kld_step(
        static, jopt, loss_fn=lambda m, b: m.forward_kld(b[0], context=b[1]))
    jstate, loss_j = jstep(jstate, (jnp.asarray(x), jnp.asarray(ctx)))
    topt = torch.optim.SGD(tmodel.parameters(), lr=lr)
    tstate = nt.init_train_state(tmodel, topt)
    loss_t = nt.make_forward_kld_step(topt)(
        tstate, (torch.from_numpy(x), torch.from_numpy(ctx)))
    _close(float(loss_t), float(loss_j))
    want = _port_layout(tmodel, export_state_dict(
        jpar.model_of_state(jstate, static)))
    for name, p in tmodel.named_parameters():
        _close(p.detach().numpy(), want[name])


def test_builder_defaults_and_device():
    m = nt.build_conditional_nsf(device="cpu")
    assert isinstance(m, nt.ConditionalNormalizingFlow)
    assert len(m.flows) == 8
    net = m.flows[0].prqct.transform_net
    assert net.hidden_features == 64 and net.context_features == 4
    assert net.blocks[0].context_layer is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nt.build_conditional_nsf()
