"""The targets take ``context=`` and ignore it, as the JAX package's do
(``nf_tpu/distributions/target.py:61,96,133,151``): each target's
``sample`` (and the rejection-sampled ones' ``sample_pool``) with
``context=object()`` gives bitwise the draws of the same call without it,
from the same generator state, on the CPU."""

import numpy as np
import pytest
import torch

from nf_tpu_torch import distributions as tdist

N = 300
POOL = 4096


def _targets():
    image = np.random.default_rng(0).random((8, 8)).astype(np.float32)
    return {
        "two_moons": tdist.TwoMoons(),
        "ring_mixture": tdist.RingMixture(),
        "circular_gaussian_mixture": tdist.CircularGaussianMixture(),
        "two_independent": tdist.TwoIndependent(tdist.TwoMoons(),
                                                tdist.RingMixture()),
        "two_independent_circular": tdist.TwoIndependent(
            tdist.CircularGaussianMixture(), tdist.TwoMoons()),
        "smiley": tdist.Smiley(),
        "image_prior": tdist.ImagePrior(image, device="cpu"),
    }


def _draws(fn):
    out = []
    for kw in ({}, {"context": object()}):
        gen = torch.Generator().manual_seed(11)
        out.append(fn(gen, kw))
    return out


@pytest.mark.parametrize("name", list(_targets()))
def test_sample_takes_and_ignores_context(name):
    target = _targets()[name]
    a, b = _draws(lambda gen, kw: target.sample(N, gen, device="cpu", **kw))
    assert a.shape == (N, 2 * (1 + name.startswith("two_independent")))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["two_moons", "ring_mixture",
                                  "two_independent", "smiley",
                                  "image_prior"])
def test_sample_pool_takes_and_ignores_context(name):
    target = _targets()[name]
    pool = (POOL, POOL) if name == "two_independent" else POOL
    (a, full_a), (b, full_b) = _draws(
        lambda gen, kw: target.sample_pool(N, pool, gen, device="cpu",
                                           **kw))
    assert torch.equal(a, b) and bool(full_a) == bool(full_b)
