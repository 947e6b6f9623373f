"""The port's variational loss and step (``NormalizingFlow.reverse_kld``,
``make_reverse_kld_step``) on the circular NSF against the JAX package,
on the CPU.

Both frameworks get the same weights (``test_torch_autoregressive.
circular_pair``: K = 2, hidden 16, 4 bins, perturbed off the identity)
and the same base draws: numpy makes them, and each side's
``UniformGaussian`` is made to return them in place of its own draw (JAX
keys and torch generators give different numbers). The target is the
Gauss-von Mises cylinder density of ``examples/paper_example_nsf.py``. The
JAX side runs its default CPU dispatch. Tolerance: the JAX package's
gradient bar, 1e-4 abs on the loss and on every gradient divided by
``max(max |gradient|, 1)``. The training features (EMA, accumulation, the
non-finite guard) are held to what ``tests/test_train_features.py`` asks of
the JAX reverse-KLD step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nf_tpu.parallel as jpar
import nf_tpu_torch as nt
from nf_tpu.distributions.base import UniformGaussian as JUniformGaussian
from nf_tpu.utils.module import Module, combine, partition, static_field
from nf_tpu_torch.compat import _head_to_bin_major
from nf_tpu_torch.nets.made import MADE
from nf_tpu_torch.ops import splines_kernel as tk
from test_torch_autoregressive import base_draws, circular_pair, \
    circular_state_dict

TOL = 1e-4
N = 256
SCALE = [2 * np.pi, 1.0]


class JGaussVonMises(Module):
    """``examples/paper_example_nsf.py:22-36``."""

    conc: float = static_field(default=2.0)
    corr: float = static_field(default=0.8)

    def log_prob(self, x, context=None):
        phi, z = x[..., 0], x[..., 1]
        return (self.conc * jnp.cos(phi)
                - 0.5 * (z - self.corr * jnp.sin(phi)) ** 2)


class GaussVonMises:
    """The same density in PyTorch."""

    def log_prob(self, x):
        phi, z = x[..., 0], x[..., 1]
        return 2.0 * torch.cos(phi) - 0.5 * (z - 0.8 * torch.sin(phi)) ** 2


def _jax_fixed(jmodel, z0):
    """``jmodel`` with the target and a base that returns ``z0``."""
    class Fixed(JUniformGaussian):
        def sample(self, key, num_samples=1, context=None):
            return jnp.asarray(z0)

    q = jmodel.q0
    fixed = Fixed(scale=q.scale, ind=q.ind, ind_=q.ind_,
                  inv_perm=q.inv_perm, ndim=q.ndim)
    return jmodel.replace(q0=fixed, p=JGaussVonMises())


def _torch_fixed(tmodel, draws):
    """A copy of ``tmodel`` with the target and a base that returns the
    arrays of ``draws`` one after the other (cycling)."""
    m = copy.deepcopy(tmodel)
    m.p = GaussVonMises()
    it = {"i": 0}

    def sample(num_samples=1, generator=None):
        z = draws[it["i"] % len(draws)]
        it["i"] += 1
        assert z.shape[0] == num_samples
        return torch.from_numpy(z)

    m.q0.sample = sample
    return m


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


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("beta,score_fn", [(1.0, True), (0.4, True),
                                           (1.0, False)])
def test_reverse_kld_loss_and_gradients_match_jax(beta, score_fn):
    jmodel, tmodel, _ = circular_pair()
    z0 = base_draws(N, 1, scale=SCALE)
    params, static = partition(_jax_fixed(jmodel, z0))
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).reverse_kld(
            jax.random.PRNGKey(0), N, beta=beta, score_fn=score_fn)))(params)
    want = _port_layout(tmodel, circular_state_dict(combine(grads, static)))
    m = _torch_fixed(tmodel, [z0])
    loss_t = m.reverse_kld(N, beta=beta, score_fn=score_fn)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               atol=TOL, rtol=0)
    named = dict(m.named_parameters())
    assert len(named) == 2 * 9  # per layer: 4 masked linears, preprocessing
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad, want[name])


def test_sgd_step_matches_optax():
    """One ``make_reverse_kld_step`` with ``torch.optim.SGD`` against the
    JAX step with ``optax.sgd`` on a one-device mesh."""
    lr = 0.05
    jmodel, tmodel, _ = circular_pair()
    z0 = base_draws(N, 2, scale=SCALE)
    jopt = optax.sgd(lr)
    jstate, static = jpar.init_train_state(_jax_fixed(jmodel, z0), jopt)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstep = jpar.make_reverse_kld_step(static, jopt, mesh, num_samples=N)
    jstate, loss_j = jstep(jstate, jax.random.PRNGKey(0))
    m = _torch_fixed(tmodel, [z0])
    topt = torch.optim.SGD(m.parameters(), lr=lr)
    tstate = nt.init_train_state(m, topt)
    loss_t = nt.make_reverse_kld_step(topt, num_samples=N)(tstate, None)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=TOL,
                               rtol=0)
    assert tstate.step == int(jstate.step) == 1
    want = _port_layout(tmodel, circular_state_dict(
        jpar.model_of_state(jstate, static)))
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=TOL,
                                   rtol=0, err_msg=name)


def test_accumulation_matches_the_full_draw():
    """Two microdraws of N/2 equal one draw of N when they are its halves:
    the loss is a sample mean (``test_train_features.py:161``)."""
    _, tmodel, _ = circular_pair()
    z0 = base_draws(N, 3, scale=SCALE)
    full = _torch_fixed(tmodel, [z0])
    accum = _torch_fixed(tmodel, [z0[:N // 2], z0[N // 2:]])
    losses = []
    for m, k in ((full, 1), (accum, 2)):
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        step = nt.make_reverse_kld_step(opt, num_samples=N, accum_steps=k)
        losses.append(float(step(nt.init_train_state(m, opt), None)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for p, q in zip(accum.parameters(), full.parameters()):
        _close(p.grad, q.grad, 1e-5)


def test_ema_beta_schedule_and_generator_draws():
    """EMA after each step (``test_train_features.py:146``), ``beta`` read
    from the schedule at the host step count, samples from the generator:
    the same seed gives the same losses."""
    _, tmodel, _ = circular_pair()
    betas = []

    def schedule(step):
        betas.append(step)
        return min(1.0, 0.5 + 0.25 * step)

    losses = []
    for _ in range(2):
        m = copy.deepcopy(tmodel)
        m.p = GaussVonMises()
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        state = nt.init_train_state(m, opt, with_ema=True)
        step = nt.make_reverse_kld_step(opt, num_samples=64, accum_steps=2,
                                        ema_decay=0.95,
                                        beta_schedule=schedule)
        gen = torch.Generator().manual_seed(0)
        losses.append([float(step(state, gen)) for _ in range(2)])
        assert state.step == 2 and np.isfinite(losses[-1]).all()
        diff = max(float((e - p.detach()).abs().max()) for e, p in
                   zip(nt.ema_model(state).parameters(), m.parameters()))
        assert diff > 0
    assert losses[0] == losses[1] and betas == [0, 1, 0, 1]


def test_skip_nonfinite_discards_a_nan_step_and_is_a_no_op_otherwise():
    """``test_train_features.py:198,222`` on the variational step: a NaN
    loss (here a NaN beta) leaves parameters, Adam state and EMA bitwise
    unchanged and advances the counter; finite steps match unguarded
    ones."""
    _, tmodel, _ = circular_pair()
    z0 = base_draws(64, 4, scale=SCALE)
    runs = []
    for guard in (False, True):
        m = _torch_fixed(tmodel, [z0])
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        state = nt.init_train_state(m, opt, with_ema=True)
        step = nt.make_reverse_kld_step(opt, num_samples=64, ema_decay=0.9,
                                        skip_nonfinite=guard)
        step(state, None)
        runs.append([p.detach().clone() for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))

    m = _torch_fixed(tmodel, [z0])
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    state = nt.init_train_state(m, opt, with_ema=True)
    step = nt.make_reverse_kld_step(
        opt, num_samples=64, ema_decay=0.9, skip_nonfinite=True,
        beta_schedule=lambda s: float("nan") if s == 1 else 1.0)
    step(state, None)
    before = ([p.detach().clone() for p in m.parameters()],
              copy.deepcopy(opt.state_dict()["state"]),
              [e.detach().clone() for e in state.ema.parameters()])
    loss = step(state, None)
    assert not np.isfinite(float(loss)) and state.step == 2
    assert all(torch.equal(a, b) for a, b in
               zip(before[0], [p.detach() for p in m.parameters()]))
    assert all(torch.equal(a, b) for a, b in
               zip(before[2], list(state.ema.parameters())))
    after = opt.state_dict()["state"]
    assert all(torch.equal(after[i][k], before[1][i][k])
               for i in before[1] for k in before[1][i])
    assert np.isfinite(float(step(state, None)))


def test_cpu_step_launches_no_kernel_and_refuses_what_waits():
    _, tmodel, _ = circular_pair()
    m = copy.deepcopy(tmodel)
    m.p = GaussVonMises()
    opt = torch.optim.SGD(m.parameters(), lr=1e-3)
    counts = (tk.rqs_fwd.launches, tk.rqs_bwd.launches,
              tk.rqs_bwd_autodiff.launches)
    nt.make_reverse_kld_step(opt, num_samples=32)(
        nt.init_train_state(m, opt), torch.Generator().manual_seed(1))
    assert counts == (tk.rqs_fwd.launches, tk.rqs_bwd.launches,
                      tk.rqs_bwd_autodiff.launches)
    # meshes and donation are taken (tests/test_torch_parallel.py)
    nt.make_reverse_kld_step(opt, num_samples=32, donate=True)
    # post_update changes the model in place: another model is refused
    with pytest.raises(ValueError, match="in place"):
        nt.make_reverse_kld_step(opt, num_samples=32,
                                 post_update=copy.deepcopy)(
            nt.init_train_state(m, opt), torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="divide"):
        nt.make_reverse_kld_step(opt, num_samples=30, accum_steps=4)
