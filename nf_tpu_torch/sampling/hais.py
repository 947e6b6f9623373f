"""Hamiltonian annealed importance sampling (``nf_tpu/sampling/hais.py``;
reference ``normflows/sampling/hais.py:8-49``).

The chains are independent over the sample axis and advance in lockstep,
every HMC layer one batched pass over all of them. The prior draws first
from the generator, then each layer in turn (``HamiltonianMonteCarlo.
draw``), where the JAX package splits its key once per layer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..distributions.linear_interpolation import LinearInterpolation
from ..flows.stochastic import HamiltonianMonteCarlo


class HAIS(nn.Module):
    """Annealed importance sampling with HMC transitions between the
    ``prior`` and the ``target``."""

    def __init__(self, prior, target, layers):
        super().__init__()
        self.prior = prior
        self.target = target
        self.layers = nn.ModuleList(layers)

    @classmethod
    def create(cls, betas, prior, target, num_leapfrog, step_size, log_mass,
               device=None):
        """``betas``: the annealing schedule, ``1 = beta_0 > ... > beta_n =
        0`` (reference ``hais.py:17-35``); the layers run ``n - 1`` down
        to 1, layer i on ``beta_i * log p + (1 - beta_i) * log prior``.
        ``step_size`` (its log is each layer's ``log_step_size``) and
        ``log_mass`` broadcast over the features. On ``device`` (None:
        CUDA, raising if it is absent)."""
        dev = resolve_device(device)
        betas = np.asarray(betas)
        n = betas.shape[0] - 1
        log_step_size = torch.log(torch.as_tensor(step_size,
                                                  dtype=torch.float32))
        layers = [HamiltonianMonteCarlo(
            LinearInterpolation(target, prior, alpha=float(betas[i])),
            num_leapfrog, log_step_size, log_mass)
            for i in range(n - 1, 0, -1)]
        return cls(prior, target, layers).to(dev)

    def sample_with_stats(self, num_samples, generator=None):
        """``(samples, log_weights, acceptance)``; ``acceptance`` is each
        annealing layer's HMC accept rate, ``(n_layers,)``, a device
        tensor (``nf_tpu/sampling/hais.py:41``)."""
        samples, log_weights = self.prior.forward(num_samples, generator)
        log_weights = -log_weights
        acceptance = []
        for layer in self.layers:
            samples, lw_add, acc = layer.forward_with_stats(
                samples, generator=generator)
            log_weights = log_weights + lw_add
            acceptance.append(acc)
        log_weights = log_weights + self.target.log_prob(samples)
        acc = (torch.cat(acceptance) if acceptance else
               torch.zeros((0,), dtype=samples.dtype,
                           device=samples.device))
        return samples, log_weights, acc

    def sample(self, num_samples=1, generator=None):
        """Weighted samples ``(samples, log_weights)`` (reference
        ``hais.py:37-49``), with the signature of
        ``NormalizingFlow.sample``: ``serving.compile_sampler`` serves it
        as one CUDA graph."""
        samples, log_weights, _ = self.sample_with_stats(num_samples,
                                                         generator)
        return samples, log_weights
