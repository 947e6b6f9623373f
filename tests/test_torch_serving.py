"""The port's serving functions (``nf_tpu_torch.serving``) and
``LULinear.with_cache`` against the JAX package, on the CPU.

A small ``build_nsf`` (K = 2, hidden 16, 4 bins) is built in JAX, its
exported state dict perturbed with numpy noise (N(0, 0.2²); with the
identity init every spline is the identity) and loaded into both the JAX
model and the port's. The port's ``compile_log_prob`` and
``compile_log_prob_buckets`` are held against JAX's at ragged batch sizes
on the same numpy inputs, within 1e-4 abs (the port's bar for a whole
model, ``tests/test_torch_nsf.py``). On the CPU a compiled function runs
the eager model on its bound weights; the captured CUDA graphs are held
against eager calls by ``tests/test_torch_cuda.py`` on the card.
``LULinear.with_cache`` is held against JAX's ``with_cache`` within 1e-5,
as ``tests/test_flows_basic.py`` holds JAX's cache to its uncached layer.
"""

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
from nf_tpu.flows.mixing import LULinear as JLULinear
from nf_tpu_torch import serving
from nf_tpu_torch.flows import LULinear

TOL = 1e-4
CACHE_TOL = 1e-5
SMALL = dict(dim=2, K=2, hidden=16, num_bins=4)
RAGGED = (1, 3, 17, 100)
MAX_BATCH = 100
_PAIRS = {}


def _perturbed_state_dict(jmodel, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in export_state_dict(jmodel).items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _pair(seed=0):
    """(JAX model, port model on the CPU) with the same perturbed weights;
    built once per seed."""
    if seed not in _PAIRS:
        jmodel = jmodels.build_nsf(jax.random.PRNGKey(seed), **SMALL)
        sd = _perturbed_state_dict(jmodel, seed)
        _PAIRS[seed] = (import_state_dict(jmodel, sd),
                        nt.load_reference_state_dict(
                            nt.build_nsf(device="cpu", **SMALL), sd))
    return _PAIRS[seed]


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2)) * 1.5).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("n", RAGGED)
def test_compile_log_prob_matches_jax(n):
    jmodel, tmodel = _pair()
    x = _inputs(n, seed=n)
    want = jserving.compile_log_prob(jmodel, (n, 2))(jnp.asarray(x))
    fn = nt.compile_log_prob(tmodel, (n, 2))
    got = fn(torch.from_numpy(x))
    assert got.shape == (n,) and got.dtype == torch.float32
    _close(got, want)
    assert fn.launches == {}  # no graph on the CPU


def test_compile_log_prob_buckets_matches_jax():
    jmodel, tmodel = _pair()
    jfn = jserving.compile_log_prob_buckets(jmodel, MAX_BATCH, (2,))
    tfn = nt.compile_log_prob_buckets(tmodel, MAX_BATCH, (2,))
    assert tfn.buckets == jfn.buckets == (1, 2, 4, 8, 16, 32, 64, 100)
    for n in RAGGED:
        x = _inputs(n, seed=10 + n)
        got = tfn(torch.from_numpy(x))
        assert got.shape == (n,)
        _close(got, jfn(jnp.asarray(x)))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        tfn(torch.zeros(MAX_BATCH + 1, 2))
    with pytest.raises(ValueError, match="empty"):
        tfn(torch.zeros(0, 2))


def test_buckets_pad_with_the_last_row():
    """A request is padded with its last row (JAX's ``mode="edge"``): the
    bucket's input holds the request, then copies of its last row."""
    _, tmodel = _pair()
    tfn = nt.compile_log_prob_buckets(tmodel, 8, (2,))
    x = torch.from_numpy(_inputs(5, seed=3))
    tfn(x)
    padded = tfn._fns[8]._compiled.inputs[0]
    assert torch.equal(padded[:5], x)
    assert torch.equal(padded[5:], x[-1:].expand(3, 2))


def test_compile_log_prob_checks_its_inputs():
    _, tmodel = _pair()
    fn = nt.compile_log_prob(tmodel, (4, 2))
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros(3, 2))
    with pytest.raises(TypeError, match="float64"):
        fn(torch.zeros(4, 2, dtype=torch.float64))


def test_with_model_rebinds_and_the_old_handle_keeps_its_weights():
    """``with_model`` answers with the new weights; the first handle goes
    on answering with its own, before and after the second one ran, as
    JAX's ``CompiledFn.with_model`` does; training the original model in
    place changes neither."""
    (ja, ta), (jb, tb) = _pair(0), _pair(1)
    x = _inputs(17, seed=4)
    fa = nt.compile_log_prob(ta, (17, 2))
    fb = fa.with_model(tb)
    jfa = jserving.compile_log_prob(ja, (17, 2))
    jfb = jfa.with_model(jb)
    for _ in range(2):
        _close(fb(torch.from_numpy(x)), jfb(jnp.asarray(x)))
        _close(fa(torch.from_numpy(x)), jfa(jnp.asarray(x)))
    held = fa(torch.from_numpy(x))
    copy_of_held = held.clone()
    moved = nt.build_nsf(device="cpu", **SMALL)
    moved.load_state_dict(ta.state_dict())
    fm = fa.with_model(moved)
    with torch.no_grad():
        for p in moved.parameters():
            p.add_(0.5)
    _close(fm(torch.from_numpy(x)), jfa(jnp.asarray(x)))
    fb(torch.from_numpy(x))
    assert torch.equal(held, copy_of_held)
    buckets = nt.compile_log_prob_buckets(ta, 32, (2,))
    rebound = buckets.with_model(tb)
    _close(rebound(torch.from_numpy(x)), jfb(jnp.asarray(x)))
    _close(buckets(torch.from_numpy(x)), jfa(jnp.asarray(x)))


def test_with_model_raises_on_another_structure():
    _, tmodel = _pair()
    fn = nt.compile_log_prob(tmodel, (4, 2))
    wider = nt.build_nsf(device="cpu", **dict(SMALL, hidden=32))
    with pytest.raises(ValueError, match="with_model"):
        fn.with_model(wider)
    deeper = nt.build_nsf(device="cpu", **dict(SMALL, K=3))
    with pytest.raises(ValueError, match="with_model"):
        fn.with_model(deeper)
    with pytest.raises(ValueError, match="with_model"):
        nt.compile_log_prob_buckets(tmodel, 4, (2,)).with_model(wider)


def test_sampler_draws_as_the_eager_sampler_from_the_same_seed():
    _, tmodel = _pair()
    fn = nt.compile_sampler(tmodel, 64)
    for seed in (0, 7, 0):
        z, log_q = fn(seed)
        with torch.no_grad():
            z_e, log_q_e = tmodel.sample(
                64, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(z, z_e) and torch.equal(log_q, log_q_e)
    with pytest.raises(TypeError, match="integer seed"):
        fn(torch.Generator())


@pytest.mark.parametrize("call", [
    lambda m: nt.compile_sampler(m, 4, typed_key=True),
    lambda m: serving.export_sampler(m, 4, typed_key=True),
], ids=["typed_key", "export_typed_key"])
def test_what_is_not_ported_raises(call):
    _, tmodel = _pair()
    with pytest.raises(NotImplementedError, match="seed"):
        call(tmodel)


def _lu_pair(features=5, seed=0):
    jlu = JLULinear.create(jax.random.PRNGKey(seed), features,
                           identity_init=False)
    tlu = LULinear(features)
    with torch.no_grad():
        for name in ("lower_entries", "upper_entries",
                     "unconstrained_upper_diag", "bias"):
            getattr(tlu, name).copy_(torch.from_numpy(
                np.array(getattr(jlu, name))))
    return jlu, tlu


@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_lu_linear_with_cache_matches_jax(method):
    jlu, tlu = _lu_pair()
    x = np.random.default_rng(5).standard_normal((64, 5)).astype(np.float32)
    jcached, tcached = jlu.with_cache(), tlu.with_cache()
    zj, ldj = getattr(jcached, method)(jnp.asarray(x))
    with torch.no_grad():
        zt, ldt = getattr(tcached, method)(torch.from_numpy(x))
        zu, ldu = getattr(tlu, method)(torch.from_numpy(x))
    _close(zt, zj, CACHE_TOL)
    _close(ldt, ldj, CACHE_TOL)
    _close(zt, zu, CACHE_TOL)  # the cache against the uncached layer
    _close(ldt, ldu, CACHE_TOL)
    _close(tcached.cache_logabsdet, jcached.cache_logabsdet, CACHE_TOL)
    _close(tcached.cache_weight, jcached.cache_weight, CACHE_TOL)
    _close(tcached.cache_inverse, jcached.cache_inverse, CACHE_TOL)


def test_lu_linear_cache_is_a_new_module():
    """``with_cache`` and ``without_cache`` return new layers and leave
    ``self`` as it was; the cache is not part of the state dict."""
    _, tlu = _lu_pair()
    cached = tlu.with_cache()
    assert cached is not tlu and tlu.cache_weight is None
    assert set(cached.state_dict()) == set(tlu.state_dict())
    plain = cached.without_cache()
    assert plain.cache_weight is None and cached.cache_weight is not None
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (32, 5)).astype(np.float32))
    with torch.no_grad():
        _close(cached.inverse(cached.forward(x)[0])[0], x, CACHE_TOL)
        _close(plain.forward(x)[0], tlu.forward(x)[0], 0.0)


def test_cached_model_serves_the_same_log_prob():
    """A model whose mixing layers carry the cache serves the uncached
    model's log_prob (a compiled function of either)."""
    _, tmodel = _pair()
    cached = nt.build_nsf(device="cpu", **SMALL)
    cached.load_state_dict(tmodel.state_dict())
    for flow in cached.flows:
        if hasattr(flow, "linear"):
            flow.linear = flow.linear.with_cache()
    x = torch.from_numpy(_inputs(100, seed=8))
    _close(nt.compile_log_prob(cached, (100, 2))(x),
           nt.compile_log_prob(tmodel, (100, 2))(x), CACHE_TOL)
