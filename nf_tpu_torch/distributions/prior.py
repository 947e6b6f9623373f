"""Unnormalized 2D log-densities for variational inference
(``nf_tpu/distributions/prior.py``; reference
``normflows/distributions/prior.py``)."""

from __future__ import annotations

import torch
from torch import nn


class PriorDistribution(nn.Module):
    """Abstract prior (``prior.py:15-20``; reference ``prior.py:6-17``)."""

    def log_prob(self, z, context=None):
        raise NotImplementedError


class TwoModes(PriorDistribution):
    """Bimodal 2D density, a ring of radius ``loc`` cut into two modes on
    the first axis (``prior.py:80-93``; reference ``prior.py:107-149``)."""

    def __init__(self, loc=2.0, scale=0.2):
        super().__init__()
        self.loc = loc
        self.scale = scale

    def log_prob(self, z, context=None):
        a = torch.abs(z[:, 0])
        eps = abs(self.loc)
        norm = torch.sqrt(torch.sum(z ** 2, dim=1))
        return (-0.5 * ((norm - self.loc) / (2 * self.scale)) ** 2
                - 0.5 * ((a - eps) / (3 * self.scale)) ** 2
                + torch.log1p(torch.exp(-2 * (a * eps)
                                        / (3 * self.scale) ** 2)))
