"""The port's rejection sampler (``nf_tpu_torch/distributions/target.py``)
against the JAX package's ``lax.while_loop`` sampler, on the CPU.

* The law: the port's eager loop and its sync-free pool against JAX's
  ``rejection_sample`` (Smiley's density), ``TwoMoons.sample``,
  ``RingMixture.sample`` and ``ImagePrior.sample`` at N = 20000 over
  three keys: means and covariances within 4 sigma of their sampling
  error, quadrant shares within 4 sigma, and a two-sample KS test per
  coordinate with p > 1e-3. JAX keys and torch generators give different
  numbers, so the draws are compared by their law, not draw for draw.
* Compaction: the uniforms replayed from the same generator seed give the
  accepted proposals in proposal order, the first N, across rounds; the
  drop row never leaks into the batch.
* Exactness: a low-acceptance target in small forced rounds still returns
  N samples; a short pool flags ``full`` false; ``ImagePrior`` raises
  after its rounds run out.
* An eager draw depends on the generator's state alone, not on what the
  object drew before.
* The two forms are bitwise equal from one generator state, also under
  ``torch.use_deterministic_algorithms``.
* ``TwoIndependent`` with a half not drawn by rejection
  (``CircularGaussianMixture``) against JAX's law; its pool methods refuse
  such a half.
* The sizing: the pool and the rate's lower bound hold at ``SHORTFALL``
  by the exact binomial tails.
* The in-step draw: the twins' ``_utils.train`` draws the same batch for
  the same ``(seed, it)`` and raises when a draw falls short.
"""

import argparse
import functools

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import nf_tpu.distributions as jdist
import nf_tpu_torch as nt
from nf_tpu.distributions.target import rejection_sample as j_rejection
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch.distributions import target as ttarget

N = 20000
SIGMAS = 4.0
KS_P = 1e-3
KEYS = (0, 1, 2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _image(seed=11, shape=(12, 16)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) ** 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_draws(name, key, n):
    key = jax.random.PRNGKey(key)
    if name == "smiley":
        return j_rejection(jdist.Smiley().log_prob, key, n, 2)
    if name == "two_moons":
        return jdist.TwoMoons().sample(key, n)
    if name == "rings":
        return jdist.RingMixture().sample(key, n)
    return jdist.ImagePrior.create(_image()).sample(key, n)


def _port_target(name):
    if name == "smiley":
        return tdist.Smiley()
    if name == "two_moons":
        return tdist.TwoMoons()
    if name == "rings":
        return tdist.RingMixture()
    return tdist.ImagePrior(_image(), device="cpu")


def _port_draws(name, form, seed, n):
    if name == "smiley" and form == "eager":
        return ttarget.rejection_sample(tdist.Smiley().log_prob, n, 2,
                                        _gen(seed))
    target = _port_target(name)
    if form == "eager":
        return target.sample(n, _gen(seed))
    x, full = target.sampler(n, _gen(seed + 1000))(_gen(seed))
    assert bool(full)
    return x


def _within(diff, sigma, what):
    z = np.abs(diff) / sigma
    assert np.all(z <= SIGMAS), (what, diff, sigma)


def _assert_same_law(a, b):
    """Means and covariances within SIGMAS of their sampling error,
    quadrant shares of each pair of coordinates within SIGMAS, and a KS
    test per coordinate above KS_P."""
    n, d = a.shape
    assert b.shape == (n, d)
    assert np.all(np.isfinite(b))
    # means
    _within(a.mean(0) - b.mean(0),
            np.sqrt(a.var(0) / n + b.var(0) / n), "mean")
    # covariances: each entry's sampling error from the products' spread
    ca, cb = a - a.mean(0), b - b.mean(0)
    pa = (ca[:, :, None] * ca[:, None, :]).reshape(n, d * d)
    pb = (cb[:, :, None] * cb[:, None, :]).reshape(n, d * d)
    _within(pa.mean(0) - pb.mean(0),
            np.sqrt(pa.var(0) / n + pb.var(0) / n), "covariance")
    # quadrant shares (the modes of two moons and the image's halves)
    centre = np.concatenate([a, b]).mean(0)
    for i in range(0, d, 2):
        qa = (a[:, i] > centre[i]) * 2 + (a[:, i + 1] > centre[i + 1])
        qb = (b[:, i] > centre[i]) * 2 + (b[:, i + 1] > centre[i + 1])
        sa = np.bincount(qa, minlength=4) / n
        sb = np.bincount(qb, minlength=4) / n
        pooled = (sa + sb) / 2
        _within(sa - sb, np.sqrt(pooled * (1 - pooled) * 2 / n) + 1e-12,
                "quadrant shares")
    for i in range(d):
        assert stats.ks_2samp(a[:, i], b[:, i]).pvalue > KS_P, i


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("form", ["eager", "pool"])
@pytest.mark.parametrize("name", ["smiley", "two_moons", "rings", "image"])
def test_law_matches_jax(name, form, key):
    a = np.asarray(_jax_draws(name, key, N), np.float64)  # both forms
    b = _port_draws(name, form, 100 + key, N).numpy().astype(np.float64)
    assert a.shape == (N, 2)
    _assert_same_law(a, b)


@pytest.mark.parametrize("key", KEYS)
def test_two_independent_with_an_exact_half_matches_jax(key):
    """A half drawn exactly (``CircularGaussianMixture``) beside one drawn
    by rejection, as JAX's ``TwoIndependent`` takes any target."""
    a = jdist.TwoIndependent(
        target1=jdist.TwoMoons(), target2=jdist.CircularGaussianMixture()
    ).sample(jax.random.PRNGKey(key), N)
    ti = tdist.TwoIndependent(tdist.TwoMoons(),
                              tdist.CircularGaussianMixture())
    b = ti.sample(N, _gen(200 + key))
    assert b.shape == (N, 4)
    _assert_same_law(np.asarray(a, np.float64), b.numpy().astype(np.float64))
    # rounds fixed for the rejection half only
    c = ti.sample(N, _gen(200 + key), round_size=(4096, None))
    assert torch.equal(c[:, :2], tdist.TwoMoons().sample(
        N, _gen(200 + key), round_size=4096))


def test_two_independent_pools_refuse_a_half_not_drawn_by_rejection():
    ti = tdist.TwoIndependent(tdist.TwoMoons(),
                              tdist.CircularGaussianMixture())
    for call in (lambda: ti.pool_size(100, _gen(0)),
                 lambda: ti.sampler(100, _gen(0)),
                 lambda: ti.sample_pool(100, (4096, 4096), _gen(0)),
                 lambda: ti.sample(100, _gen(0), round_size=(None, 4096))):
        with pytest.raises(ValueError, match="CircularGaussianMixture is not "
                                             "drawn by rejection"):
            call()


@pytest.mark.parametrize("name", ["two_moons", "image"])
def test_eager_draw_depends_on_the_generator_alone(name):
    """The rounds are sized from the draw's own counts: the same
    generator state gives the same batch whatever the object drew before,
    in two rounds."""
    target = _port_target(name)
    first = target.sample(5000, _gen(9))
    target.sample(300, _gen(1))
    target.pool_size(700, _gen(2))
    assert torch.equal(target.sample(5000, _gen(9)), first)
    assert torch.equal(_port_target(name).sample(5000, _gen(9)), first)
    # two rounds, two host reads: 5000 proposals, then one sized round
    assert torch.equal(ttarget.rejection_loop(
        target._acceptance(), 5000, 2, _gen(9), torch.float32,
        torch.device("cpu"), max_rounds=2), first)


def test_acceptance_rate_matches_jax():
    """TwoMoons' acceptance, counted by the port's rounds, within 4 sigma
    of the rate JAX's density gives numpy's uniform proposals."""
    rate = ttarget.AcceptanceRate()
    ttarget.rejection_loop(tdist.TwoMoons()._acceptance(), N, 2, _gen(3),
                           torch.float32, torch.device("cpu"), rate=rate)
    port = rate.accepted / rate.proposed
    rng = np.random.default_rng(4)
    m = 1 << 21
    z = rng.random((m, 2)).astype(np.float32) * 6 - 3
    lp = np.asarray(jdist.TwoMoons().log_prob(jax.numpy.asarray(z)))
    want = float(np.mean(np.exp(lp) > rng.random(m)))
    sigma = np.sqrt(want * (1 - want) * (1 / m + 1 / rate.proposed))
    assert abs(port - want) <= SIGMAS * sigma, (port, want)


def _replayed(target, seed, rounds, m, n):
    """The first ``n`` accepted of ``rounds`` rounds of ``m`` proposals,
    the uniforms drawn from ``seed`` in the sampler's order."""
    gen = _gen(seed)
    accept_of = target._acceptance()
    kept = []
    for _ in range(rounds):
        eps = torch.rand((m, 2), generator=gen)
        prob = torch.rand((m,), generator=gen)
        z, accept = accept_of(eps, prob)
        kept.append(z[accept])
    return torch.cat(kept)[:n]


@pytest.mark.parametrize("name", ["two_moons", "image"])
def test_compaction_is_proposal_order(name):
    target = _port_target(name)
    n, m = 300, 1000
    # several rounds: the count carries from round to round
    want = _replayed(target, 7, 40, m, n)
    assert want.shape[0] == n
    got = target.sample(n, _gen(7), round_size=m)
    assert torch.equal(got, want)
    # one pool that falls short: the accepted ones in order, then zeros
    x, full = target.sample_pool(n, m, _gen(7))
    first = _replayed(target, 7, 1, m, n)
    k = first.shape[0]
    assert 0 < k < n and not bool(full)
    assert torch.equal(x[:k], first)
    assert torch.equal(x[k:], torch.zeros_like(x[k:]))
    # a pool that fills: exactly the first n
    x, full = target.sample_pool(n, 40 * m, _gen(7))
    assert bool(full)
    assert torch.equal(x, _replayed(target, 7, 1, 40 * m, n))


class _Narrow(tdist.Target):
    """A bump of width 0.02 at (1, 1): it accepts 7e-5 of the proposals
    (2 pi 0.02^2 / 36), and a zero row lies ~2500 nats below it."""

    def log_prob(self, z, context=None):
        return -0.5 * torch.sum(((z - 1) / 0.02) ** 2, dim=1)


def test_low_acceptance_fills_exactly():
    target = _Narrow()
    rate = ttarget.AcceptanceRate()
    x = ttarget.rejection_loop(target._acceptance(), 20, 2, _gen(1),
                               torch.float32, torch.device("cpu"),
                               round_size=4096, rate=rate)
    assert x.shape == (20, 2)
    assert float(target.log_prob(x).min()) > -40
    assert rate.proposed >= 20 * 4096  # many rounds
    assert torch.equal(target.sample(20, _gen(1), round_size=4096), x)
    # sized rounds reach the same count
    y = target.sample(20, _gen(2))
    assert y.shape == (20, 2) and float(target.log_prob(y).min()) > -40
    _, full = target.sample_pool(20, 4096, _gen(3))
    assert not bool(full)


def test_image_prior_gives_up_after_its_rounds():
    prior = tdist.ImagePrior(_image(), device="cpu")
    prior.max_rounds = 3
    with pytest.raises(RuntimeError, match="after 3 rounds"):
        prior.sample(1000, _gen(0), round_size=10)


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("name", ["two_moons", "rings", "smiley", "image"])
def test_forms_are_bitwise_equal(name, deterministic):
    target = _port_target(name)
    pool = target.pool_size(2000, _gen(5))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        eager = target.sample(2000, _gen(6), round_size=pool)
        x, full = target.sample_pool(2000, pool, _gen(6))
    finally:
        torch.use_deterministic_algorithms(was)
    assert bool(full) and torch.equal(eager, x)


def test_two_independent_pools_both_halves():
    ti = tdist.TwoIndependent(tdist.RingMixture(1), tdist.RingMixture(2))
    draw = ti.sampler(500, _gen(0))
    x, full = draw(_gen(1))
    assert x.shape == (500, 4) and bool(full)
    pools = ti.pool_size(500, _gen(0))  # the sampler's calibration again
    assert draw.args[1] == pools
    eager = ti.sample(500, _gen(1), round_size=pools)
    assert torch.equal(eager, x)
    _, full = ti.sample_pool(500, (pools[0], 10), _gen(1))
    assert not bool(full)


@pytest.mark.parametrize("accepted,proposed", [(40, 512), (4000, 65536),
                                               (300000, 4800000)])
@pytest.mark.parametrize("n", [512, 65536])
def test_sizing_holds_at_the_shortfall(accepted, proposed, n):
    rate = ttarget.AcceptanceRate()
    rate.add(proposed, accepted)
    p = rate.lower_bound()
    assert 0 < p < accepted / proposed
    # a rate as low as the bound makes the observed count a 1e-12 event
    assert stats.binom.sf(accepted - 1, proposed, p) <= ttarget.SHORTFALL
    m = rate.pool(n)
    assert stats.binom.cdf(n - 1, m, p) <= ttarget.SHORTFALL
    # and it is not wasteful: 10% fewer proposals would not hold
    assert stats.binom.cdf(n - 1, int(m * 0.9), p) > ttarget.SHORTFALL


def test_sizing_needs_a_bound():
    rate = ttarget.AcceptanceRate()
    assert rate.round_size(512) == 512  # the first round: JAX's size
    rate.add(512, 10)  # below the bound's threshold: double
    assert rate.lower_bound() == 0
    assert rate.round_size(502) == 1024
    with pytest.raises(ValueError, match="no lower bound"):
        rate.pool(512)
    rate.add(1024, 20)  # a loose bound: the round grows by GROWTH at most
    assert 0 < rate.lower_bound() < 1e-3
    assert rate.round_size(472) == ttarget.GROWTH * 1536 < rate.pool(472)


# --- the twins' in-step draw ------------------------------------------------

def _twin_model():
    return nt.build_nsf(dim=2, K=2, hidden=8, num_bins=4,
                        target=tdist.TwoMoons(), device="cpu", seed=0)


def _recording(draw, into):
    def record(gen):
        batch, full = draw(gen)
        into.append(batch.clone())
        return batch, full
    return record


def test_train_draws_inside_the_step_from_seed_and_iteration():
    from examples_torch import _utils

    args = argparse.Namespace(iters=3, lr=1e-3, seed=4, log_every=0,
                              num_samples=256)
    runs = []
    for _ in range(2):
        model = _twin_model()
        draw = _utils.target_draw(model.p, args, torch.device("cpu"))
        got = []
        _, hist = _utils.train(model, _utils.ForwardKLD(
            draw=_recording(draw, got)), args)
        assert bool(torch.isfinite(hist.losses).all())
        runs.append((got, draw))
    (a, draw), (b, _) = runs
    assert len(a) == len(b) == 3
    for it in range(3):
        assert torch.equal(a[it], b[it])
        want, full = draw(_gen(_utils.keyed_seed(args.seed, it)))
        assert bool(full) and torch.equal(a[it], want)
    assert not torch.equal(a[0], a[1])


def test_train_raises_when_a_draw_falls_short():
    from examples_torch import _utils

    args = argparse.Namespace(iters=2, lr=1e-3, seed=0, log_every=0)
    model = _twin_model()
    short = functools.partial(model.p.sample_pool, 256, 300)
    with pytest.raises(RuntimeError, match="fell short"):
        _utils.train(model, _utils.ForwardKLD(draw=short), args)
