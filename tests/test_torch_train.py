"""The port's training step (``nf_tpu_torch.parallel``) and its data
(``nf_tpu_torch.distributions.TwoMoons``) against the JAX package.

Whole-model gradients: the JAX ``build_nsf`` and the port's share weights
through the weight bridge (perturbed off the identity, as in
``tests/test_torch_nsf.py``); the JAX gradient tree goes through
``export_state_dict`` (which only copies and permutes head rows) to the
reference names, and the port's bin-major head rows are permuted back.
The JAX side runs its default CPU dispatch and, with
``set_fused_head_mode("on")``, the fused head+spline Pallas kernels with
their backward in interpret mode; the port runs its plain CPU path.
Tolerance 1e-4 abs (the bar of ``tests/test_torch_nsf.py``) on the loss
and on every gradient divided by ``max(max |gradient|, 1)``, the JAX
package's gradient bar. The training features (EMA, accumulation, the
non-finite guard, ``reshape_for_accum``) are held to what
``tests/test_train_features.py`` asks of the JAX step.
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
from nf_tpu.distributions import TwoMoons as JTwoMoons
from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch.compat import _head_to_bin_major
from nf_tpu_torch.nets.resnet import ResidualNet

TOL = 1e-4
SMALL = dict(K=2, hidden=16, num_bins=4)
BATCH = 300


def _perturbed_pair(dim, seed, scale=0.2):
    """(JAX model, port model on the CPU) with the same weights."""
    jmodel = jmodels.build_nsf(jax.random.PRNGKey(seed), dim=dim, **SMALL)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in export_state_dict(jmodel).items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        sd[k] = v
    jmodel = import_state_dict(jmodel, sd)
    tmodel = nt.load_reference_state_dict(
        nt.build_nsf(dim=dim, device="cpu", **SMALL), sd)
    return jmodel, tmodel


def _inputs(dim, seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * 1.5).astype(np.float32)


def _heads(tmodel):
    return {f"{name}.final_layer.": mod.bin_major_head
            for name, mod in tmodel.named_modules()
            if isinstance(mod, ResidualNet)
            and mod.bin_major_head is not None}


def _to_port_layout(tmodel, sd):
    """Reference-named arrays -> the port's layout (bin-major head rows)."""
    heads = _heads(tmodel)
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


@pytest.mark.parametrize("jax_dispatch", ["default", "fused_head_on"])
@pytest.mark.parametrize("dim", [2, 3])
def test_forward_kld_gradients_match_jax(dim, jax_dispatch):
    jmodel, tmodel = _perturbed_pair(dim, seed=dim)
    x = _inputs(dim)
    params, static = partition(jmodel)
    if jax_dispatch == "fused_head_on":
        jshf.set_fused_head_mode("on")
    try:
        loss_j, grads = jax.jit(jax.value_and_grad(
            lambda p: combine(p, static).forward_kld(jnp.asarray(x))))(params)
    finally:
        jshf.set_fused_head_mode("auto")
    want = _to_port_layout(tmodel, export_state_dict(combine(grads, static)))
    loss_t = tmodel.forward_kld(torch.from_numpy(x))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               atol=TOL, rtol=0)
    named = dict(tmodel.named_parameters())
    assert named and set(named) <= set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad, want[name])


def test_sgd_steps_match_optax():
    """Two steps of ``make_forward_kld_step`` with ``torch.optim.SGD``
    against the JAX step with ``optax.sgd``: SGD is linear in the
    gradients, so the parameters stay comparable at the bar."""
    lr = 0.05
    jmodel, tmodel = _perturbed_pair(2, seed=5)
    batches = [_inputs(2, seed=s) for s in (1, 2)]
    jopt = optax.sgd(lr)
    jstate, static = jpar.init_train_state(jmodel, jopt)
    jstep = jpar.make_forward_kld_step(static, jopt)
    topt = torch.optim.SGD(tmodel.parameters(), lr=lr)
    tstate = nt.init_train_state(tmodel, topt)
    tstep = nt.make_forward_kld_step(topt)
    for x in batches:
        jstate, loss_j = jstep(jstate, jnp.asarray(x))
        loss_t = tstep(tstate, torch.from_numpy(x))
        np.testing.assert_allclose(float(loss_t), float(loss_j), atol=TOL,
                                   rtol=0)
    assert tstate.step == int(jstate.step) == 2
    want = _to_port_layout(
        tmodel, export_state_dict(jpar.model_of_state(jstate, static)))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=TOL,
                                   rtol=0, err_msg=name)


def _port_model(seed=3):
    return _perturbed_pair(2, seed=seed)[1]


def _twomoons(n, seed=0):
    return nt.TwoMoons().sample(n, generator=torch.Generator().manual_seed(
        seed))


def test_ema_matches_manual_recurrence():
    model = _port_model()
    x = _twomoons(64)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    state = nt.init_train_state(model, opt, with_ema=True)
    decay = 0.9
    step = nt.make_forward_kld_step(opt, ema_decay=decay)
    manual = [p.detach().clone() for p in model.parameters()]
    for _ in range(3):
        step(state, x)
        manual = [decay * e + (1 - decay) * p.detach()
                  for e, p in zip(manual, model.parameters())]
    ema = nt.ema_model(state)
    for e, m in zip(ema.parameters(), manual):
        torch.testing.assert_close(e, m, atol=1e-6, rtol=0)
    assert all(not e.requires_grad for e in ema.parameters())
    with torch.no_grad():
        assert torch.isfinite(ema.log_prob(x)).all()
    assert max(float((e - p.detach()).abs().max()) for e, p in
               zip(ema.parameters(), model.parameters())) > 0


def test_grad_accum_matches_full_batch():
    """The forward KLD is a batch mean: the mean of equal microbatch
    gradients is the full-batch gradient (``test_train_features.py:48``)."""
    x = _twomoons(64)
    m1 = _port_model()
    m2 = copy.deepcopy(m1)
    o1 = torch.optim.Adam(m1.parameters(), lr=1e-3)
    o2 = torch.optim.Adam(m2.parameters(), lr=1e-3)
    s1, s2 = nt.init_train_state(m1, o1), nt.init_train_state(m2, o2)
    loss_full = nt.make_forward_kld_step(o1)(s1, x)
    loss_acc = nt.make_forward_kld_step(o2, accum_steps=4)(
        s2, nt.reshape_for_accum(x, 4))
    np.testing.assert_allclose(float(loss_acc), float(loss_full), rtol=1e-5)
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        _close(p2.grad, p1.grad, 1e-5)
        torch.testing.assert_close(p2, p1, atol=1e-6, rtol=0)


def _snapshot(state):
    return ([p.detach().clone() for p in state.model.parameters()],
            copy.deepcopy(state.optimizer.state_dict()["state"]),
            [e.detach().clone() for e in state.ema.parameters()]
            if state.ema is not None else [])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_skip_nonfinite_discards_bad_update():
    """``test_train_features.py:198``: a NaN batch leaves parameters,
    optimizer state and EMA bitwise unchanged and advances the step; a
    clean batch then updates."""
    model = _port_model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = nt.init_train_state(model, opt, with_ema=True)
    step = nt.make_forward_kld_step(opt, ema_decay=0.9, skip_nonfinite=True)
    x = _twomoons(32)
    step(state, x)  # give Adam its state
    params, opt_state, ema = _snapshot(state)
    x_bad = x.clone()
    x_bad[0, 0] = float("nan")
    loss = step(state, x_bad)
    assert not np.isfinite(float(loss)) and state.step == 2
    p2, o2, e2 = _snapshot(state)
    assert _same(p2, params) and _same(e2, ema)
    assert all(torch.equal(o2[i][k], opt_state[i][k])
               for i in opt_state for k in opt_state[i])
    loss = step(state, x)
    assert np.isfinite(float(loss)) and state.step == 3
    assert not _same(_snapshot(state)[0], params)


def test_skip_nonfinite_first_step_rolls_back_to_a_fresh_state():
    """A NaN on the very first step: the Adam state created by the step is
    rolled back to zeros, and the next clean step matches a fresh one."""
    model = _port_model()
    twin = copy.deepcopy(model)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    opt_twin = torch.optim.Adam(twin.parameters(), lr=1e-3)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt, skip_nonfinite=True)
    x = _twomoons(32)
    x_bad = x.clone()
    x_bad[3, 1] = float("inf")
    step(state, x_bad)
    nt.make_forward_kld_step(opt_twin)(nt.init_train_state(twin, opt_twin),
                                       x)
    step(state, x)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)


def test_skip_nonfinite_with_grad_accum():
    """A NaN in any microbatch skips the whole update
    (``test_train_features.py:259``)."""
    model = _port_model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt, accum_steps=2, skip_nonfinite=True)
    x = _twomoons(32)
    x[20, 1] = float("inf")  # second microbatch
    params = [p.detach().clone() for p in model.parameters()]
    loss = step(state, nt.reshape_for_accum(x, 2))
    assert not np.isfinite(float(loss)) and state.step == 1
    assert _same([p.detach() for p in model.parameters()], params)


def test_reshape_for_accum_validates():
    with pytest.raises(ValueError, match="divisible"):
        nt.reshape_for_accum(torch.zeros(10, 2), 3)
    x, y = torch.zeros(12, 2), torch.zeros(12)
    xr, yr = nt.reshape_for_accum((x, y), 3)
    assert xr.shape == (3, 4, 2) and yr.shape == (3, 4)


def test_step_refuses_what_waits_for_later_slices():
    model = _port_model()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with pytest.raises(NotImplementedError, match="residual-flow"):
        nt.make_forward_kld_step(opt, post_update=lambda m: m)
    with pytest.raises(NotImplementedError, match="residual-flow"):
        nt.make_forward_kld_step(opt, with_key=True)
    state = nt.init_train_state(model, opt)
    with pytest.raises(ValueError, match="no EMA params"):
        nt.ema_model(state)
    with pytest.raises(ValueError, match="no EMA slot"):
        nt.make_forward_kld_step(opt, ema_decay=0.9)(state, _twomoons(8))
    other = torch.optim.SGD(model.parameters(), lr=1e-2)
    with pytest.raises(ValueError, match="not the optimizer"):
        nt.make_forward_kld_step(other)(state, _twomoons(8))
    assert nt.model_of_state(state) is model


def test_two_moons_log_prob_matches_jax():
    rng = np.random.default_rng(11)
    z = rng.uniform(-3.0, 3.0, (500, 2)).astype(np.float32)
    want = np.asarray(JTwoMoons().log_prob(jnp.asarray(z)))
    got = nt.TwoMoons().log_prob(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_two_moons_sampling_is_seeded_and_inside_the_box():
    a, b = _twomoons(1000, seed=4), _twomoons(1000, seed=4)
    assert a.shape == (1000, 2) and torch.equal(a, b)
    assert float(a.abs().max()) <= 3.0
    # rejection sampling accepts where the density is high: the samples'
    # mean log-density sits far above the uniform proposals'
    prop = torch.rand((1000, 2), generator=torch.Generator().manual_seed(
        5)) * 6.0 - 3.0
    tm = nt.TwoMoons()
    assert float(tm.log_prob(a).mean()) > float(tm.log_prob(prop).mean()) + 5
    if not torch.cuda.is_available():  # no generator: the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nt.TwoMoons().sample(4)
