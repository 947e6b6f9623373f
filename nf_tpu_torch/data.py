"""Zero-download image data (``nf_tpu/data.py:154-170``).

The port keeps its own copy of the JAX package's procedural image classes:
pure numpy, so a seed gives the same images and labels in both packages,
bit for bit.
"""

from __future__ import annotations

import numpy as np


def procedural_image_classes(seed: int, n: int, num_classes: int = 10,
                             size: int = 32, channels: int = 3):
    """Class-structured procedural RGB images (uint8 NCHW) and int32
    labels, the stand-in for CIFAR-10 of the image recipes: a
    class-dependent coloured sinusoid and a uniform texture."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n)
    yy, xx = np.mgrid[0:size, 0:size] / size
    phase = y[:, None, None] / num_classes * 2 * np.pi
    base = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy)[None] + phase)
    rgb = np.stack([np.cos(phase), np.sin(phase),
                    np.cos(2 * phase)], 1)[:, :channels]
    img = 0.6 * base[:, None] * (0.5 + 0.5 * rgb)
    img = img + 0.1 * rng.random((n, channels, size, size))
    return ((np.clip(img, 0, 1) * 255).astype(np.uint8),
            y.astype(np.int32))
