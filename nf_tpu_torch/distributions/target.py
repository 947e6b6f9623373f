"""Analytic target densities and rejection sampling
(``nf_tpu/distributions/target.py``; reference
``normflows/distributions/target.py``).

The sampler is the JAX package's ``lax.while_loop`` body on the device:
each round proposes a fixed-shape batch of uniform points, accepts each
with probability ``exp(log_prob - max_log_prob)``, gives the accepted ones
the slots ``count + cumsum(accept) - 1`` and scatters them into a static
buffer whose extra last row takes every dropped write (JAX's
``mode="drop"``). The count stays on the device; the eager loop's test
``count < N`` is the one host read of a round. The first ``N`` accepted
points of an i.i.d. proposal stream, in proposal order, have the same law
whatever a round proposes: the first round proposes ``N``, as JAX's
do, and each later one as many points as fill the rest but for a chance
of ``SHORTFALL``, from the rate the draw's own rounds measured
(:class:`AcceptanceRate`). So a draw is a function of the generator's
state alone, and takes two host reads as a rule. The sync-free form
proposes one fixed pool, sized beforehand by an eager draw, and returns
the batch with a device flag ``full``: that is the draw a CUDA graph
captures. Randomness comes from an explicit ``torch.Generator``, and
the samples live on its device.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from .._device import resolve_device

# the chance that a sized round or pool falls short of its batch, and the
# level at which AcceptanceRate's lower bound on the rate holds
SHORTFALL = 1e-12
_LOG_SHORTFALL = math.log(1 / SHORTFALL)
# the most points one round of the eager loop proposes, and the most times
# the proposals before it
MAX_ROUND = 1 << 24
GROWTH = 64
# the fewest points of a draw that sizes a pool: more acceptances than
# ln(1 / SHORTFALL), so that the rate has a lower bound
_CALIBRATION = 64


class AcceptanceRate:
    """The proposals and acceptances of one draw's eager rounds, counted
    on the host (each round's count is read there for the loop's test
    anyway): they size the draw's later rounds, and a pool.

    For ``m`` proposals at rate ``p`` the accepted count ``X`` is
    binomial, and Chernoff's lower tail ``P(X < n) <= exp(-(mp - n)^2 /
    (2 mp))`` is at most ``SHORTFALL`` once ``mp >= n + L + sqrt(L^2 +
    2 n L)``, ``L = ln(1 / SHORTFALL)``. ``p`` is replaced by a lower
    bound: after ``a`` acceptances of ``m0`` proposals, Chernoff's upper
    tail ``P(X >= mu + t) <= exp(-t^2 / (2 mu + t))`` puts ``m0 p`` above
    ``a - t``, ``t = (sqrt(L^2 + 8 a L) - L) / 2``, but for a chance of
    ``SHORTFALL``. Below ``L`` acceptances there is no such bound: the
    first round proposes the batch's size, as the JAX package's rounds do,
    and each round after it doubles the proposals made so far. A bound
    from a few acceptances is loose, so a sized round proposes at most
    ``GROWTH`` times the proposals before it: a round of millions after a
    first round of 512 would cost more than the read it saves."""

    def __init__(self):
        self.proposed = 0
        self.accepted = 0

    def add(self, proposed, accepted):
        self.proposed += proposed
        self.accepted += accepted

    def lower_bound(self):
        """A lower bound on the rate (0: none yet)."""
        a, L = self.accepted, _LOG_SHORTFALL
        t = (math.sqrt(L * L + 8 * a * L) - L) / 2
        return max(a - t, 0.0) / self.proposed if self.proposed else 0.0

    def pool(self, num_samples):
        """Proposals that yield ``num_samples`` acceptances but for a
        chance of ``SHORTFALL``; raises without a bound on the rate."""
        p, L = self.lower_bound(), _LOG_SHORTFALL
        if p <= 0:
            raise ValueError(
                f"no lower bound on the acceptance rate yet ({self.accepted}"
                f" of {self.proposed} proposals accepted): draw eagerly "
                f"first")
        mean = num_samples + L + math.sqrt(L * L + 2 * num_samples * L)
        return max(num_samples, math.ceil(mean / p))

    def round_size(self, need):
        """The proposals of an eager round that still needs ``need``
        acceptances."""
        if self.lower_bound() > 0:
            return min(self.pool(need), GROWTH * self.proposed, MAX_ROUND)
        if self.proposed:
            return min(max(need, 2 * self.proposed), MAX_ROUND)
        return need


def _uniform_acceptance(log_prob_fn, prop_scale, prop_shift, max_log_prob):
    """The targets' acceptance (``target.py:35-37``): a uniform point on
    the proposal box, kept where ``exp(log_prob - max_log_prob)`` exceeds
    its uniform draw."""
    def accept(eps, prob):
        z_ = prop_scale * eps + prop_shift
        return z_, torch.exp(log_prob_fn(z_) - max_log_prob) > prob
    return accept


def _round(accept_of, m, generator, buf, total):
    """One round of the JAX package's loop body (``target.py:32-42``) on
    ``m`` proposals: the accepted points go after the ``total`` taken so
    far in ``buf``, whose last row takes the rejected ones and those past
    the batch. Returns the new total (unclamped: slots past the batch drop
    all the same); reads nothing on the host."""
    n = buf.shape[0] - 1
    eps = torch.rand((m, buf.shape[1]), generator=generator,
                     dtype=buf.dtype, device=buf.device)
    prob = torch.rand((m,), generator=generator, dtype=buf.dtype,
                      device=buf.device)
    z, accept = accept_of(eps, prob)
    slots = torch.where(accept, total + torch.cumsum(accept, 0) - 1, n)
    buf.index_put_((torch.clamp_max(slots, n),), z)
    return total + torch.sum(accept)


def _buffers(num_samples, n_dims, dtype, device):
    return (torch.zeros((num_samples + 1, n_dims), dtype=dtype,
                        device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def rejection_loop(accept_of, num_samples, n_dims, generator, dtype, device,
                   round_size=None, max_rounds=None, rate=None):
    """The eager sampler: rounds of ``accept_of(eps, prob) -> (points,
    accepted)`` on uniform draws until ``num_samples`` are accepted, each
    round sized by the draw's own :class:`AcceptanceRate` (``rate``, which
    takes the rounds' counts; None: a new one), or ``round_size`` points.
    The result depends on the generator's state alone. The host reads the
    device once per round, for the loop's test. Raises after
    ``max_rounds`` rounds (None: no limit, as in JAX)."""
    rate = AcceptanceRate() if rate is None else rate
    buf, total = _buffers(num_samples, n_dims, dtype, device)
    taken = rounds = 0
    while taken < num_samples:
        if rounds == max_rounds:
            raise RuntimeError(f"rejection sampling: {taken} of "
                               f"{num_samples} samples accepted after "
                               f"{rounds} rounds")
        m = round_size or rate.round_size(num_samples - taken)
        total = _round(accept_of, m, generator, buf, total)
        now = int(total)  # the loop's test: the round's one host read
        rate.add(m, now - taken)
        taken = now
        rounds += 1
    return buf[:num_samples]


def rejection_pool(accept_of, num_samples, n_dims, pool, generator, dtype,
                   device):
    """The sync-free sampler: one round of ``pool`` proposals; returns the
    batch and a device bool, true when the batch is full (rows past the
    count are zeros). For one generator state it is bitwise the eager loop
    with ``round_size=pool`` whenever that loop's first round fills."""
    buf, total = _buffers(num_samples, n_dims, dtype, device)
    total = _round(accept_of, pool, generator, buf, total)
    return buf[:num_samples], total >= num_samples


def _device_of(generator, device):
    if device is None and generator is not None:
        device = generator.device
    return resolve_device(device)


def rejection_sample(log_prob_fn, num_samples, n_dims, generator=None,
                     prop_scale=6.0, prop_shift=-3.0, max_log_prob=0.0,
                     dtype=torch.float32, device=None):
    """Uniform-proposal rejection sampler (``target.py:23``): propose
    points on ``[prop_shift, prop_shift + prop_scale]^n``, accept each
    with probability ``exp(log_prob - max_log_prob)``, until
    ``num_samples`` are accepted (:func:`rejection_loop`). ``device``
    defaults to the generator's (None: CUDA)."""
    return rejection_loop(
        _uniform_acceptance(log_prob_fn, prop_scale, prop_shift,
                            max_log_prob),
        num_samples, n_dims, generator, dtype, _device_of(generator, device))


class RejectionSampled:
    """The sampling methods of a density drawn by rejection. A subclass
    sets ``n_dims`` and defines ``_acceptance()`` (``accept(eps, prob) ->
    (points, accepted)`` on uniform ``eps`` and ``prob``) and
    ``_device(generator, device)``."""

    max_rounds = None

    def sample(self, num_samples=1, generator=None, device=None,
               round_size=None, context=None):
        """``num_samples`` draws by the eager loop, its rounds sized from
        the rate they measure (or ``round_size`` points each).
        ``context`` is taken and ignored, as the JAX package's targets take
        it (``target.py:61``)."""
        return rejection_loop(self._acceptance(), num_samples, self.n_dims,
                              generator, torch.float32,
                              self._device(generator, device), round_size,
                              self.max_rounds)

    def sample_pool(self, num_samples, pool, generator=None, device=None,
                    context=None):
        """``(samples, full)`` from one round of ``pool`` proposals, with
        no host read (:func:`rejection_pool`); ``context`` is ignored."""
        return rejection_pool(self._acceptance(), num_samples, self.n_dims,
                              pool, generator, torch.float32,
                              self._device(generator, device))

    def pool_size(self, num_samples, generator=None, device=None):
        """The pool that fills ``num_samples`` but for a chance of
        ``SHORTFALL``, from the rate that one eager draw from ``generator``
        measures (of at least ``_CALIBRATION`` points, so that the rate has
        a bound)."""
        rate = AcceptanceRate()
        rejection_loop(self._acceptance(), max(num_samples, _CALIBRATION),
                       self.n_dims, generator, torch.float32,
                       self._device(generator, device), None,
                       self.max_rounds, rate)
        return rate.pool(num_samples)

    def sampler(self, num_samples, generator=None, device=None):
        """The sync-free draw of ``num_samples`` that a captured step runs,
        ``draw(generator) -> (samples, full)``, its pool fixed now by
        :meth:`pool_size` (a capture cannot read the device)."""
        return functools.partial(
            self.sample_pool, num_samples,
            self.pool_size(num_samples, generator, device), device=device)


class Target(RejectionSampled, nn.Module):
    """Abstract 2D test target with rejection sampling
    (reference ``target.py:8-73``)."""

    def __init__(self, prop_scale=6.0, prop_shift=-3.0, n_dims=2,
                 max_log_prob=0.0):
        super().__init__()
        self.prop_scale = prop_scale
        self.prop_shift = prop_shift
        self.n_dims = n_dims
        self.max_log_prob = max_log_prob

    def log_prob(self, z, context=None):
        raise NotImplementedError("The log probability is not implemented yet.")

    def _acceptance(self):
        return _uniform_acceptance(self.log_prob, self.prop_scale,
                                   self.prop_shift, self.max_log_prob)

    def _device(self, generator, device):
        return _device_of(generator, device)


class TwoMoons(Target):
    """Bimodal two-moons density (reference ``target.py:100-132``)."""

    def log_prob(self, z, context=None):
        a = torch.abs(z[:, 0])
        norm = torch.sqrt(torch.sum(z ** 2, dim=1))
        return (-0.5 * ((norm - 2) / 0.2) ** 2
                - 0.5 * ((a - 2) / 0.3) ** 2
                + torch.log1p(torch.exp(-4 * a / 0.09)))


class ConditionalDiagGaussian(Target):
    """Gaussian target whose context is ``[mean, std]``, ``(B, 2d)``
    (``nf_tpu/distributions/target.py:140-156``; reference
    ``target.py:199-225``). The package exports it as
    ``ConditionalDiagGaussianTarget``, the JAX package's name."""

    def log_prob(self, z, context=None):
        d = z.shape[-1]
        loc, scale = context[:, :d], context[:, d:]
        return -0.5 * d * math.log(2 * math.pi) - torch.sum(
            torch.log(scale) + 0.5 * ((z - loc) / scale) ** 2, dim=-1)

    def sample(self, num_samples=1, generator=None, context=None):
        """``num_samples`` draws, row i at ``context[i]``; the generator
        lives on the context's device."""
        d = context.shape[-1] // 2
        loc, scale = context[:, :d], context[:, d:]
        eps = torch.randn((num_samples, d), generator=generator,
                          dtype=context.dtype, device=context.device)
        return loc + scale * eps


class CircularGaussianMixture(nn.Module):
    """Two-dimensional Gaussian mixture with ``n_modes`` modes on the
    circle of radius 2 (``nf_tpu/distributions/target.py:78-102``;
    reference ``target.py:135-175``), each of scale ``2/3 sin(pi /
    n_modes)``. Sampling is exact: a mode, then a Gaussian draw around
    it, on the generator's device (None: CUDA)."""

    def __init__(self, n_modes=8):
        super().__init__()
        self.n_modes = n_modes
        self.scale = 2 / 3 * math.sin(math.pi / n_modes)

    def _locs(self, dtype, device):
        # float64 on the device, as the JAX package builds them in numpy;
        # no host-to-device copy, so a captured call can evaluate it
        phi = (2 * math.pi / self.n_modes) * torch.arange(
            self.n_modes, dtype=torch.float64, device=device)
        locs = torch.stack([2 * torch.sin(phi), 2 * torch.cos(phi)], dim=1)
        return locs.to(dtype)

    def log_prob(self, z, context=None):
        locs = self._locs(z.dtype, z.device)
        d = torch.sum((z[:, None, :] - locs) ** 2, dim=2) \
            / (2 * self.scale ** 2)
        return (-math.log(2 * math.pi * self.scale ** 2 * self.n_modes)
                + torch.logsumexp(-d, dim=1))

    def sample(self, num_samples=1, generator=None, device=None,
               context=None):
        """Exact draws; ``context`` is ignored (``target.py:96``)."""
        if device is None and generator is not None:
            device = generator.device
        dev = resolve_device(device)
        eps = torch.randn((num_samples, 2), generator=generator, device=dev)
        mode = torch.randint(0, self.n_modes, (num_samples,),
                             generator=generator, device=dev)
        phi = (2 * math.pi / self.n_modes) * mode
        loc = torch.stack([2 * torch.sin(phi), 2 * torch.cos(phi)], dim=1)
        return eps * self.scale + loc


class RingMixture(Target):
    """Mixture of ``n_rings`` concentric rings of radii ``2 (i + 1) /
    n_rings`` and width ``1 / (4 n_rings)`` (``target.py:105-119``;
    reference ``target.py:178-196``), sampled by rejection."""

    def __init__(self, n_rings=2):
        super().__init__()
        self.n_rings = n_rings
        self.ring_scale = 1 / 4 / n_rings

    def log_prob(self, z, context=None):
        norm = torch.sqrt(torch.sum(z ** 2, dim=1))
        radii = (2 / self.n_rings) * torch.arange(
            1, self.n_rings + 1, dtype=torch.float64, device=z.device)
        radii = radii.to(z.dtype)
        d = ((norm[:, None] - radii) ** 2) / (2 * self.ring_scale ** 2)
        return torch.logsumexp(-d, dim=1)


class TwoIndependent(Target):
    """Product of two independent targets of equal dimension, the first
    on the first half of the features (``target.py:122-137``; reference
    ``target.py:76-97``), for augmented flows."""

    def __init__(self, target1, target2):
        super().__init__()
        self.target1 = target1
        self.target2 = target2

    def log_prob(self, z, context=None):
        z1, z2 = torch.chunk(z, 2, dim=1)
        return self.target1.log_prob(z1) + self.target2.log_prob(z2)

    def sample(self, num_samples=1, generator=None, device=None,
               round_size=None, context=None):
        """Each half drawn by its own target (``target.py:133-137``);
        ``round_size``, a pair, fixes the rounds of halves drawn by
        rejection (None: as they size them); ``context`` is ignored."""
        sizes = round_size or (None, None)
        return torch.cat([
            t.sample(num_samples, generator, device=device) if r is None
            else _rejection_half(t).sample(num_samples, generator, device,
                                           round_size=r)
            for t, r in zip((self.target1, self.target2), sizes)], dim=1)

    def sample_pool(self, num_samples, pool, generator=None, device=None,
                    context=None):
        """Each half from its own pool (``pool``: a pair); full when both
        are. Both halves must be drawn by rejection. ``context`` is
        ignored."""
        (x1, f1), (x2, f2) = (
            _rejection_half(t).sample_pool(num_samples, p, generator, device)
            for t, p in zip((self.target1, self.target2), pool))
        return torch.cat([x1, x2], dim=1), f1 & f2

    def pool_size(self, num_samples, generator=None, device=None):
        return tuple(_rejection_half(t).pool_size(num_samples, generator,
                                                  device)
                     for t in (self.target1, self.target2))


def _rejection_half(target):
    """A half of a :class:`TwoIndependent` that must be drawn by rejection:
    only such a half has round sizes and a sync-free pool."""
    if not isinstance(target, RejectionSampled):
        raise ValueError(
            f"TwoIndependent: the half {type(target).__name__} is not drawn "
            f"by rejection, so it has no round size or sync-free pool; "
            f"sample() draws it as it is")
    return target
