"""Unnormalized 2D log-densities for variational inference
(``nf_tpu/distributions/prior.py``; reference
``normflows/distributions/prior.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .target import RejectionSampled, _device_of, _uniform_acceptance

# rounds of ImagePrior.sample before it gives up (JAX's loop has no limit):
# an image whose mean intensity, relative to its brightest pixel, is a
# accepts a of the proposals on average
IMAGE_PRIOR_MAX_ROUNDS = 10000


class PriorDistribution(nn.Module):
    """Abstract prior (``prior.py:15-20``; reference ``prior.py:6-17``)."""

    def log_prob(self, z, context=None):
        raise NotImplementedError


class ImagePrior(RejectionSampled, PriorDistribution):
    """A 2D density drawn by an image's intensities (``prior.py:22-77``;
    reference ``prior.py:20-104``): pixel ``(i, j)`` of the flipped,
    transposed image covers a cell of ``x_range`` x ``y_range``.
    ``log_prob`` looks up the pixel; ``sample`` is rejection sampling on
    the device, the targets' loop (``target.py``'s notes) with JAX's
    acceptance: a uniform point of the unit square is kept where its
    pixel's intensity exceeds a uniform draw. ``device`` places the
    buffers ``image`` and ``density`` (None: CUDA); the draws lie there
    too."""

    n_dims = 2
    max_rounds = IMAGE_PRIOR_MAX_ROUNDS

    def __init__(self, image, x_range=(-3.0, 3.0), y_range=(-3.0, 3.0),
                 eps=1e-10, device=None):
        super().__init__()
        image_ = np.flip(np.asarray(image, np.float32), 0).T + eps
        image_ = image_ / np.max(image_)
        density = np.log(image_ / np.sum(image_))
        dev = resolve_device(device)
        self.register_buffer("image", torch.from_numpy(
            np.ascontiguousarray(image_)).to(dev))
        self.register_buffer("density", torch.from_numpy(
            np.ascontiguousarray(density)).to(dev))
        self.x_range = tuple(float(v) for v in x_range)
        self.y_range = tuple(float(v) for v in y_range)
        scale = [[self.x_range[1] - self.x_range[0],
                  self.y_range[1] - self.y_range[0]]]
        shift = [[self.x_range[0], self.y_range[0]]]
        self.register_buffer("scale", torch.tensor(scale).to(dev),
                             persistent=False)
        self.register_buffer("shift", torch.tensor(shift).to(dev),
                             persistent=False)

    def _pixels(self, z_):
        """Pixel indices of points ``z_`` in the unit square."""
        rows, cols = self.image.shape
        return ((z_[:, 0] * (rows - 1)).to(torch.int64),
                (z_[:, 1] * (cols - 1)).to(torch.int64))

    def log_prob(self, z, context=None):
        z_ = torch.clamp((z - self.shift) / self.scale, 0.0, 1.0)
        return self.density[self._pixels(z_)]

    def _acceptance(self):
        def accept(eps, prob):
            return (eps * self.scale + self.shift,
                    self.image[self._pixels(eps)] > prob)
        return accept

    def _device(self, generator, device):
        return self.image.device


class TwoModes(PriorDistribution):
    """Bimodal 2D density, a ring of radius ``loc`` cut into two modes on
    the first axis (``prior.py:80-93``; reference ``prior.py:107-149``)."""

    def __init__(self, loc=2.0, scale=0.2):
        super().__init__()
        self.loc = loc
        self.scale = scale

    def log_prob(self, z, context=None):
        a = torch.abs(z[:, 0])
        eps = abs(self.loc)
        norm = torch.sqrt(torch.sum(z ** 2, dim=1))
        return (-0.5 * ((norm - self.loc) / (2 * self.scale)) ** 2
                - 0.5 * ((a - eps) / (3 * self.scale)) ** 2
                + torch.log1p(torch.exp(-2 * (a * eps)
                                        / (3 * self.scale) ** 2)))


def _coord_first(z):
    """The coordinate axis first (``prior.py:96-100``)."""
    return torch.movedim(z, -1, 0) if z.ndim > 1 else z


def _envelope(z_, scale):
    """The sinusoidal densities' Gaussian envelope on the 4-norm."""
    norm4 = torch.sum(torch.abs(z_) ** 4, dim=0) ** 0.25
    return -0.5 * (norm4 / (20 * scale)) ** 4


class Sinusoidal(PriorDistribution):
    """Sinusoidal density (``prior.py:110-120``; reference
    ``prior.py:152-193``)."""

    def __init__(self, scale=0.1, period=1.0):
        super().__init__()
        self.scale = scale
        self.period = period

    def _w1(self, z_):
        return torch.sin(2 * math.pi / self.period * z_[0])

    def log_prob(self, z, context=None):
        z_ = _coord_first(z)
        return (-0.5 * ((z_[1] - self._w1(z_)) / self.scale) ** 2
                + _envelope(z_, self.scale))


class _SinusoidalShifted(Sinusoidal):
    """A sinusoidal density whose curve is split by ``w(z_0)``: the
    log-density of ``|z_1 - w_1 + w/2|`` around ``|w/2|``, mirrored."""

    def _w(self, z0):
        raise NotImplementedError

    def log_prob(self, z, context=None):
        z_ = _coord_first(z)
        w = self._w(z_[0])
        eps = torch.abs(w / 2)
        a = torch.abs(z_[1] - self._w1(z_) + w / 2)
        return (-0.5 * ((a - eps) / self.scale) ** 2
                + torch.log1p(torch.exp(-2 * (eps * a) / self.scale ** 2))
                + _envelope(z_, self.scale))


class Sinusoidal_gap(_SinusoidalShifted):
    """Sinusoidal density with a gap (``prior.py:123-139``; reference
    ``prior.py:196-246``)."""

    def _w(self, z0):
        return 3.0 * torch.exp(-0.5 * ((z0 - 1.0) / 0.6) ** 2)


class Sinusoidal_split(_SinusoidalShifted):
    """Sinusoidal density with a split (``prior.py:142-158``; reference
    ``prior.py:249-299``)."""

    def _w(self, z0):
        return 3.0 * torch.sigmoid((z0 - 1.0) / 0.3)


class Smiley(RejectionSampled, PriorDistribution):
    """Smiley-face density (``prior.py:161-167``; reference
    ``prior.py:302-327``). ``sample`` is rejection sampling on the
    targets' proposal (``[-3, 3]^2``; the density's maximum is 0). The
    JAX package's ``sample`` reads proposal attributes its prior does not
    carry, so there it raises; here it samples."""

    n_dims = 2

    def __init__(self, scale=0.2):
        super().__init__()
        self.scale = scale

    def log_prob(self, z, context=None):
        z_ = _coord_first(z)
        norm = torch.sqrt(torch.sum(z_ ** 2, dim=0))
        return (-0.5 * ((norm - 2.0) / (2 * self.scale)) ** 2
                - 0.5 * ((torch.abs(z_[1] + 0.8) - 1.2)
                         / (2 * self.scale)) ** 2)

    def _acceptance(self):
        return _uniform_acceptance(self.log_prob, 6.0, -3.0, 0.0)

    def _device(self, generator, device):
        return _device_of(generator, device)
