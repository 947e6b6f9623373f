"""Periodic coordinate flows (``nf_tpu/flows/periodic.py``; reference
``normflows/flows/periodic.py:6-73``). Buffers ``ind`` (the periodic
coordinates), ``bound`` and, for the shift, ``shift`` carry the
reference's names."""

from __future__ import annotations

import numpy as np
import torch

from .base import Flow, zero_log_det_like_z


def _wrap(v, bound):
    """``v`` into ``[-bound, bound)``."""
    return torch.remainder(v + bound, 2 * bound) - bound


class PeriodicWrap(Flow):
    """Map periodic coordinates back into ``[-bound, bound)`` on the
    inverse pass (reference ``periodic.py:6-33``); forward is the
    identity."""

    def __init__(self, ind, bound=1.0, dtype=torch.float32):
        super().__init__()
        ind = torch.as_tensor(np.asarray(ind).reshape(-1), dtype=torch.int64)
        self.register_buffer("ind", ind)
        self.register_buffer("bound", torch.broadcast_to(
            torch.as_tensor(bound, dtype=dtype), ind.shape).clone())

    def forward(self, z, context=None, generator=None):
        return z, zero_log_det_like_z(z)

    def inverse(self, z, context=None, generator=None):
        out = z.clone()
        out[..., self.ind] = _wrap(z[..., self.ind], self.bound)
        return out, zero_log_det_like_z(z)


class PeriodicShift(Flow):
    """Shift and wrap periodic coordinates (reference
    ``periodic.py:36-73``)."""

    def __init__(self, ind, bound=1.0, shift=0.0, dtype=torch.float32):
        super().__init__()
        ind = torch.as_tensor(np.asarray(ind).reshape(-1), dtype=torch.int64)
        self.register_buffer("ind", ind)
        self.register_buffer("bound", torch.broadcast_to(
            torch.as_tensor(bound, dtype=dtype), ind.shape).clone())
        self.register_buffer("shift", torch.broadcast_to(
            torch.as_tensor(shift, dtype=dtype), ind.shape).clone())

    def forward(self, z, context=None, generator=None):
        out = z.clone()
        out[..., self.ind] = _wrap(z[..., self.ind] + self.shift, self.bound)
        return out, zero_log_det_like_z(z)

    def inverse(self, z, context=None, generator=None):
        out = z.clone()
        out[..., self.ind] = _wrap(z[..., self.ind] - self.shift, self.bound)
        return out, zero_log_det_like_z(z)
