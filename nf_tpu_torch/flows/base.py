"""Flow layer contract and structural combinators
(``nf_tpu/flows/base.py``; reference ``normflows/flows/base.py:5-81``).

Every layer is an ``nn.Module`` whose ``forward(z)`` and ``inverse(z)``
return ``(z', log_det)`` with a per-sample ``log_det`` of shape ``(B,)``.
``forward`` maps latent -> data.
"""

from __future__ import annotations

import torch
from torch import nn


def zero_log_det_like_z(z):
    """Per-sample zero log-det (reference ``flows/base.py:81``)."""
    return torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


class Flow(nn.Module):
    """Abstract invertible layer."""

    def forward(self, z, context=None):
        raise NotImplementedError("Forward pass has not been implemented.")

    def inverse(self, z, context=None):
        raise NotImplementedError("This flow has no algebraic inverse.")


class Reverse(Flow):
    """Swap a layer's forward and inverse (reference ``flows/base.py:27``)."""

    def __init__(self, flow):
        super().__init__()
        self.flow = flow

    def forward(self, z, context=None):
        return self.flow.inverse(z, context=context)

    def inverse(self, z, context=None):
        return self.flow.forward(z, context=context)


class Composite(Flow):
    """Sequential composition of flows (reference ``flows/base.py:48``)."""

    def __init__(self, flows):
        super().__init__()
        self.flows = nn.ModuleList(flows)

    def forward(self, z, context=None):
        log_det_tot = zero_log_det_like_z(z)
        for flow in self.flows:
            z, log_det = flow.forward(z, context=context)
            log_det_tot = log_det_tot + log_det
        return z, log_det_tot

    def inverse(self, z, context=None):
        log_det_tot = zero_log_det_like_z(z)
        for flow in reversed(self.flows):
            z, log_det = flow.inverse(z, context=context)
            log_det_tot = log_det_tot + log_det
        return z, log_det_tot
