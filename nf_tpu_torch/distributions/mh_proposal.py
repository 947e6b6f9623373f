"""Metropolis-Hastings proposals (``nf_tpu/distributions/mh_proposal.py``;
reference ``normflows/distributions/mh_proposal.py``).

The JAX package's ``propose(key, z)`` draws from a key. Here a proposal
splits it in two: :meth:`MHProposal.draw` takes its noise from a
``torch.Generator`` and :meth:`MHProposal.propose_with` moves ``z`` by it
deterministically, so a test can hand both frameworks the same noise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_LOG2PI = math.log(2 * math.pi)


class MHProposal(nn.Module):
    """Proposal API: ``propose(z, generator) -> (z', log q(z|z') - log
    q(z'|z))`` (reference ``mh_proposal.py:6-44``)."""

    def draw(self, z, generator=None):
        """The noise of one proposal from ``z``."""
        raise NotImplementedError

    def propose_with(self, z, noise):
        """``(z', log-ratio)`` of the proposal from ``z`` with ``noise``."""
        raise NotImplementedError

    def sample(self, z, generator=None):
        raise NotImplementedError

    def log_prob(self, z_, z):
        raise NotImplementedError

    def propose(self, z, generator=None):
        return self.propose_with(z, self.draw(z, generator))


class DiagGaussianProposal(MHProposal):
    """Symmetric Gaussian random walk ``z' = z + scale * eps``
    (reference ``mh_proposal.py:47-83``). ``scale`` is a buffer of shape
    ``(1, *shape)``, named as the reference's."""

    def __init__(self, shape, scale, dtype=torch.float32):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape)
        self.register_buffer("scale",
                             torch.as_tensor(scale, dtype=dtype)[None].clone())

    def draw(self, z, generator=None):
        return torch.randn((z.shape[0],) + self.shape, generator=generator,
                           dtype=z.dtype, device=z.device)

    def propose_with(self, z, noise):
        # symmetric: the log-ratio is 0
        return noise * self.scale + z, torch.zeros(
            z.shape[0], dtype=z.dtype, device=z.device)

    def sample(self, z, generator=None):
        return self.propose_with(z, self.draw(z, generator))[0]

    def log_prob(self, z_, z):
        d = math.prod(self.shape)
        return -0.5 * d * _LOG2PI - torch.sum(
            torch.log(self.scale) + 0.5 * ((z_ - z) / self.scale) ** 2,
            dim=tuple(range(1, z.ndim)))
