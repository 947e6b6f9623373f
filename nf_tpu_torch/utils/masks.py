"""Binary mask builders (``nf_tpu/utils/masks.py``; reference
``normflows/utils/masks.py:4,20,35``)."""

from __future__ import annotations

import torch


def create_alternating_binary_mask(features, even=True, dtype=torch.float32):
    """Alternating 1010.../0101... mask of length ``features``."""
    idx = torch.arange(features)
    start = 0 if even else 1
    return ((idx % 2) == (start % 2)).to(dtype)


def create_mid_split_binary_mask(features, dtype=torch.float32):
    """Ones on the first ceil(features / 2) entries, zeros after
    (reference ``masks.py:20``)."""
    midpoint = features // 2 if features % 2 == 0 else features // 2 + 1
    return (torch.arange(features) < midpoint).to(dtype)


def create_random_binary_mask(features, generator=None,
                              dtype=torch.float32):
    """ceil(features / 2) ones at places drawn from ``generator``
    (reference ``masks.py:35``; the JAX package draws them from a key)."""
    num_ones = features // 2 if features % 2 == 0 else features // 2 + 1
    perm = torch.randperm(features, generator=generator)
    mask = torch.zeros(features, dtype=dtype)
    mask[perm[:num_ones]] = 1.0
    return mask
