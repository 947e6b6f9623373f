"""Analytic target densities and rejection sampling
(``nf_tpu/distributions/target.py``; reference
``normflows/distributions/target.py``).

The JAX package runs its sampler as a ``lax.while_loop`` over fixed-size
proposal batches so that it compiles; PyTorch runs eagerly, so here the
loop is a plain Python loop over the same fixed-size batches, filling the
output in the order samples are accepted. Randomness comes from an
explicit ``torch.Generator``, and the samples live on its device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device


def rejection_sample(log_prob_fn, num_samples, n_dims, generator=None,
                     prop_scale=6.0, prop_shift=-3.0, max_log_prob=0.0,
                     dtype=torch.float32, device=None):
    """Uniform-proposal rejection sampler (``target.py:23``): propose
    ``num_samples`` points on ``[prop_shift, prop_shift + prop_scale]^n``
    per round, accept each with probability ``exp(log_prob -
    max_log_prob)``, until ``num_samples`` are accepted. ``device``
    defaults to the generator's (None: CUDA)."""
    if device is None and generator is not None:
        device = generator.device
    dev = resolve_device(device)
    out = torch.empty((num_samples, n_dims), dtype=dtype, device=dev)
    count = 0
    while count < num_samples:
        eps = torch.rand((num_samples, n_dims), generator=generator,
                         dtype=dtype, device=dev)
        z_ = prop_scale * eps + prop_shift
        prob = torch.rand((num_samples,), generator=generator, dtype=dtype,
                          device=dev)
        accepted = z_[torch.exp(log_prob_fn(z_) - max_log_prob) > prob]
        take = min(accepted.shape[0], num_samples - count)
        out[count:count + take] = accepted[:take]
        count += take
    return out


class Target(nn.Module):
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

    def sample(self, num_samples=1, generator=None, device=None):
        return rejection_sample(self.log_prob, num_samples, self.n_dims,
                                generator, self.prop_scale, self.prop_shift,
                                self.max_log_prob, device=device)


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

    def sample(self, num_samples=1, generator=None, device=None):
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

    def sample(self, num_samples=1, generator=None, device=None):
        return torch.cat([
            self.target1.sample(num_samples, generator, device=device),
            self.target2.sample(num_samples, generator, device=device)],
            dim=1)
