"""Log-space linear interpolation of two densities, the annealing bridge of
HAIS and of stochastic normalizing flows
(``nf_tpu/distributions/linear_interpolation.py``; reference
``normflows/distributions/linear_interpolation.py:1-27``)."""

from __future__ import annotations

from torch import nn


class LinearInterpolation(nn.Module):
    """``log p = alpha * log p1 + (1 - alpha) * log p2``.

    ``dist1`` and ``dist2`` are held, not registered as submodules: each
    belongs to its owner (a model's base and target, a HAIS's prior and
    target), which moves and saves it. A bridge over a model's base would
    otherwise put the base's tensors into the state dict a second time,
    under names the reference's state dict does not have (the reference's
    bridge is a plain object too). The bridge itself has no state."""

    def __init__(self, dist1, dist2, alpha=0.5):
        super().__init__()
        self.__dict__["dist1"] = dist1
        self.__dict__["dist2"] = dist2
        self.alpha = float(alpha)

    def log_prob(self, z, context=None):
        return (self.alpha * self.dist1.log_prob(z)
                + (1 - self.alpha) * self.dist2.log_prob(z))
