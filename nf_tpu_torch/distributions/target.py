"""Analytic target densities and rejection sampling
(``nf_tpu/distributions/target.py:23-75,140-156``; reference
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
