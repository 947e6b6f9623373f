"""Feature-reshaping flows: Split, Merge, Squeeze
(``nf_tpu/flows/reshape.py:20-117``; reference
``normflows/flows/reshape.py:9-128``).

The checkerboard split is a parity pattern fixed by the shape, applied as
strided slices and ``torch.where`` selects (the JAX package's form; the
reference gathers with boolean masks). Each layer moves data only: its
log-det is a tensor of zeros (the JAX package returns the number 0.0,
which adds the same).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Flow, zero_log_det_like_z


def _leading_parity(shape_no_batch_no_last):
    """Parity of the index sum over every axis but the batch and the last
    one (numpy, from the shape alone): an array of that shape, 0-d when
    there are no such axes."""
    grids = np.indices(shape_no_batch_no_last)
    return grids.sum(axis=0) % 2


def _parity(shape, like):
    s = _leading_parity(tuple(shape))
    return torch.as_tensor(s, device=like.device)[None, ..., None]


class Split(Flow):
    """Split the features into two sets (reference ``reshape.py:9-84``):
    ``"channel"`` halves axis 1 (the first half takes an odd channel),
    ``"channel_inv"`` swaps the halves, ``"checkerboard"`` and
    ``"checkerboard_inv"`` select by the parity of the index sum over all
    non-batch axes, along the last axis (which must be even)."""

    def __init__(self, mode="channel"):
        super().__init__()
        if not (mode in ("channel", "channel_inv")
                or "checkerboard" in mode):
            raise NotImplementedError(f"Mode {mode} is not implemented.")
        self.mode = mode

    def _split(self, z):
        if self.mode in ("channel", "channel_inv"):
            first = (z.shape[1] + 1) // 2
            a, b = z[:, :first], z[:, first:]
            return [a, b] if self.mode == "channel" else [b, a]
        s = _parity(z.shape[1:-1], z)
        even, odd = z[..., 0::2], z[..., 1::2]
        if "inv" in self.mode:  # z1 where the last index k = s (mod 2)
            return [torch.where(s == 0, even, odd),
                    torch.where(s == 0, odd, even)]
        return [torch.where(s == 0, odd, even),
                torch.where(s == 0, even, odd)]

    def _merge(self, z1, z2):
        if self.mode == "channel":
            return torch.cat([z1, z2], dim=1)
        if self.mode == "channel_inv":
            return torch.cat([z2, z1], dim=1)
        s = _parity(z1.shape[1:-1], z1)
        z1r = torch.repeat_interleave(z1, 2, dim=-1)
        z2r = torch.repeat_interleave(z2, 2, dim=-1)
        k = torch.arange(z1r.shape[-1], device=z1.device)
        if "inv" in self.mode:
            cb = (k % 2) == (s % 2)
        else:
            cb = (k % 2) == (1 - s % 2)
        return torch.where(cb, z1r, z2r)

    def forward(self, z, context=None, generator=None):
        return self._split(z), zero_log_det_like_z(z)

    def inverse(self, z, context=None, generator=None):
        z1, z2 = z
        return self._merge(z1, z2), zero_log_det_like_z(z1)


class Merge(Split):
    """Split with forward and inverse interchanged (reference
    ``reshape.py:87``)."""

    def forward(self, z, context=None, generator=None):
        return super().inverse(z, context=context, generator=generator)

    def inverse(self, z, context=None, generator=None):
        return super().forward(z, context=context, generator=generator)


class Squeeze(Flow):
    """The 2x2 space-to-channel squeeze of multiscale models (reference
    ``reshape.py:103-128``), NCHW. As in the reference, the *inverse* is
    the squeeze (the density direction) and ``forward`` the unsqueeze."""

    def forward(self, z, context=None, generator=None):
        # channel-to-space: (B, 4C, H, W) -> (B, C, 2H, 2W)
        b, c4, h, w = z.shape
        z = z.reshape(b, c4 // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
        return z.reshape(b, c4 // 4, 2 * h, 2 * w), zero_log_det_like_z(z)

    def inverse(self, z, context=None, generator=None):
        # space-to-channel: (B, C, H, W) -> (B, 4C, H/2, W/2)
        b, c, h, w = z.shape
        z = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        return z.reshape(b, 4 * c, h // 2, w // 2), zero_log_det_like_z(z)
