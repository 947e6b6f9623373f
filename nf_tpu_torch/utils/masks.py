"""Binary mask builders (reference ``normflows/utils/masks.py:4``)."""

from __future__ import annotations

import torch


def create_alternating_binary_mask(features, even=True, dtype=torch.float32):
    """Alternating 1010.../0101... mask of length ``features``."""
    idx = torch.arange(features)
    start = 0 if even else 1
    return ((idx % 2) == (start % 2)).to(dtype)
