"""VAE decoders, the likelihoods p(x|z) (``nf_tpu/distributions/
decoder.py``; reference ``normflows/distributions/decoder.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_LOG2PI = math.log(2 * math.pi)


def _tile_x_to_z(x, z):
    """``x`` repeated along a sample axis to match a flattened batch of
    ``z`` (reference ``decoder.py:63-67``)."""
    if z.shape[0] > x.shape[0]:
        reps = z.shape[0] // x.shape[0]
        x = x[:, None].repeat_interleave(reps, dim=1)
        x = x.reshape((-1,) + tuple(x.shape[2:]))
    return x


class BaseDecoder(nn.Module):
    """Abstract decoder p(x|z) (reference ``decoder.py:6-31``)."""

    def forward(self, z):
        raise NotImplementedError

    def log_prob(self, x, z):
        raise NotImplementedError


class NNDiagGaussianDecoder(BaseDecoder):
    """Diagonal Gaussian likelihood with mean and log-variance from
    ``net(z)`` (reference ``decoder.py:34-73``)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def _mean_log_var(self, z):
        mean_std = self.net(z)
        n_hidden = mean_std.shape[1] // 2
        return mean_std[:, :n_hidden], mean_std[:, n_hidden:]

    def forward(self, z):
        mean, log_var = self._mean_log_var(z)
        return mean, torch.exp(0.5 * log_var)

    def log_prob(self, x, z):
        mean, log_var = self._mean_log_var(z)
        var = torch.exp(log_var)
        x = _tile_x_to_z(x, z)
        # the normaliser takes the data's dimensionality, as the JAX
        # package's deliberate fix of the reference (which takes z's,
        # ``decoder.py:65-67``): a d_x-dimensional Gaussian needs
        # -d_x/2 log(2 pi)
        d = math.prod(mean.shape[1:])
        return -0.5 * d * _LOG2PI - 0.5 * torch.sum(
            torch.log(var) + (x - mean) ** 2 / var,
            dim=tuple(range(1, x.ndim)))


class NNBernoulliDecoder(BaseDecoder):
    """Bernoulli likelihood with logits ``net(z)``, through the
    numerically stable log-sigmoid (reference ``decoder.py:76-102``)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, z):
        return torch.sigmoid(self.net(z))

    def log_prob(self, x, z):
        score = self.net(z)
        x = _tile_x_to_z(x, z)
        return torch.sum(x * F.logsigmoid(score)
                         + (1 - x) * F.logsigmoid(-score),
                         dim=tuple(range(1, x.ndim)))
