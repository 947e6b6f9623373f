"""Model container (``nf_tpu/core.py:30-97``; reference
``normflows/core.py``): a base distribution and a chain of flows."""

from __future__ import annotations

import torch
from torch import nn


class NormalizingFlow(nn.Module):
    """Base distribution ``q0`` + flow chain + optional target ``p``
    (reference ``core.py:9-213``). ``forward`` maps latent -> data."""

    def __init__(self, q0, flows, p=None):
        super().__init__()
        self.q0 = q0
        self.flows = nn.ModuleList(flows)
        self.p = p

    def forward(self, z, context=None):
        """Latent z -> flow variable x (reference ``core.py:27``)."""
        for flow in self.flows:
            z, _ = flow.forward(z, context=context)
        return z

    def forward_and_log_det(self, z, context=None):
        """(reference ``core.py:40``)"""
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for flow in self.flows:
            z, log_d = flow.forward(z, context=context)
            log_det = log_det + log_d
        return z, log_det

    def inverse(self, x, context=None):
        """Flow variable x -> latent z (reference ``core.py:56``)."""
        for flow in reversed(self.flows):
            x, _ = flow.inverse(x, context=context)
        return x

    def inverse_and_log_det(self, x, context=None):
        """(reference ``core.py:70``)"""
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for flow in reversed(self.flows):
            x, log_d = flow.inverse(x, context=context)
            log_det = log_det + log_d
        return x, log_det

    def log_prob(self, x, context=None):
        """Per-sample log q(x) (reference ``core.py:182``)."""
        z, log_q = self.inverse_and_log_det(x, context=context)
        return log_q + self.q0.log_prob(z)

    def forward_kld(self, x, context=None):
        """MLE loss value -E[log q(x)] (reference ``core.py:87``). On CUDA
        its backward runs through the spline kernels' backward kernels (C
        and E)."""
        return -torch.mean(self.log_prob(x, context=context))

    def sample(self, num_samples=1, generator=None, context=None):
        """Draw samples with their log q (reference ``core.py:167``).
        ``generator`` lives on the model's device."""
        z, log_q = self.q0.forward(num_samples, generator=generator)
        for flow in self.flows:
            z, log_det = flow.forward(z, context=context)
            log_q = log_q - log_det
        return z, log_q
