"""Data transforms as flows (``nf_tpu/transforms.py``; reference
``normflows/transforms.py:8-76``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .flows.base import Flow, zero_log_det_like_z
from .utils.nn import sum_except_batch


class Logit(Flow):
    """``logit(alpha + (1 - alpha) * x)`` with its exact log-det
    (reference ``transforms.py:8-47``). ``forward`` maps logits to pixels,
    ``inverse`` pixels to logits (the density direction). With ``beta =
    1 - 2 alpha`` and ``d`` the features of a row, the inverse's log-det
    is ``d log(beta) - sum log z - sum log(1 - z)``."""

    def __init__(self, alpha=0.05):
        super().__init__()
        self.alpha = alpha

    def forward(self, z, context=None, generator=None):
        beta = 1 - 2 * self.alpha
        ls = sum_except_batch(F.logsigmoid(z))
        mls = sum_except_batch(F.logsigmoid(-z))
        d = math.prod(z.shape[1:])
        log_det = -math.log(beta) * d + ls + mls
        return (torch.sigmoid(z) - self.alpha) / beta, log_det

    def inverse(self, z, context=None, generator=None):
        beta = 1 - 2 * self.alpha
        z = self.alpha + beta * z
        logz = torch.log(z)
        log1mz = torch.log(1 - z)
        d = math.prod(z.shape[1:])
        log_det = (math.log(beta) * d - sum_except_batch(logz)
                   - sum_except_batch(log1mz))
        return logz - log1mz, log_det


class Shift(Flow):
    """A constant shift, e.g. [0, 1] to [-0.5, 0.5] (reference
    ``transforms.py:50-76``)."""

    def __init__(self, shift=-0.5):
        super().__init__()
        self.shift = shift

    def forward(self, z, context=None, generator=None):
        return z - self.shift, zero_log_det_like_z(z)

    def inverse(self, z, context=None, generator=None):
        return z + self.shift, zero_log_det_like_z(z)
