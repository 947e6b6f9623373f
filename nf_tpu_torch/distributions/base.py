"""Base distributions (``nf_tpu/distributions/base.py``; reference
``normflows/distributions/base.py``).

``forward(num_samples, generator=None, context=None) -> (z, log_p)``
samples with log density; ``log_prob(z, context=None)`` evaluates it. The
unconditional bases ignore ``context``, as the JAX package's do
(``nf_tpu/distributions/base.py:27-33``); the class-conditional image
bases take labels ``y`` in its place. Randomness comes from an explicit
``torch.Generator`` on the distribution's device. A base with a
``temperature`` samples at it; :meth:`BaseDistribution.with_temperature`
gives a copy at another one that shares the tensors (the JAX package's
``temperature`` is a static field, set the same way).
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..utils.nn import complement_indices, one_hot

_LOG2PI = math.log(2 * math.pi)


class BaseDistribution(nn.Module):
    """Abstract base distribution (reference ``distributions/base.py:8``)."""

    def forward(self, num_samples=1, generator=None, context=None):
        raise NotImplementedError

    def log_prob(self, z, context=None):
        raise NotImplementedError

    def sample(self, num_samples=1, generator=None, context=None):
        z, _ = self.forward(num_samples, generator, context)
        return z

    def with_temperature(self, temperature):
        """A copy of this distribution that samples at ``temperature`` (its
        log-scale raised by ``log(temperature)``), sharing every tensor
        (``base.py:37``); raises where the distribution has no temperature
        (``temperature=None``: the untempered distribution)."""
        if "temperature" not in self.__dict__:
            raise NotImplementedError(
                "This distribution does not support temperature annealed "
                "sampling")
        return replace(self, temperature=temperature)


def replace(module, **attrs):
    """A shallow copy of ``module`` with plain attributes ``attrs`` set:
    it shares every parameter, buffer and submodule, so a graph captured
    through the copy reads the original's tensors."""
    new = copy.copy(module)
    for name, value in attrs.items():
        setattr(new, name, value)
    return new


class DiagGaussian(BaseDistribution):
    """Diagonal Gaussian with loc/log_scale (reference ``base.py:52-103``).
    A non-trainable one keeps them as buffers, as the reference does."""

    def __init__(self, shape, trainable=True, dtype=torch.float32):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape)
        self.d = math.prod(self.shape)
        loc = torch.zeros((1,) + self.shape, dtype=dtype)
        log_scale = torch.zeros((1,) + self.shape, dtype=dtype)
        if trainable:
            self.loc = nn.Parameter(loc)
            self.log_scale = nn.Parameter(log_scale)
        else:
            self.register_buffer("loc", loc)
            self.register_buffer("log_scale", log_scale)

    def forward(self, num_samples=1, generator=None, context=None):
        eps = torch.randn((num_samples,) + self.shape, generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        return _gaussian_sample(self.loc, self.log_scale, eps)

    def log_prob(self, z, context=None):
        return _gaussian_log_prob(self.loc, self.log_scale, z)


def _gaussian_sample(loc, log_scale, eps):
    """``(loc + exp(log_scale) * eps, its log density)``."""
    z = loc + torch.exp(log_scale) * eps
    d = math.prod(eps.shape[1:])
    log_p = -0.5 * d * _LOG2PI - torch.sum(
        log_scale + 0.5 * eps ** 2, dim=tuple(range(1, eps.ndim)))
    return z, log_p


def _gaussian_log_prob(loc, log_scale, z):
    eps = (z - loc) / torch.exp(log_scale)
    d = math.prod(z.shape[1:])
    return -0.5 * d * _LOG2PI - torch.sum(
        log_scale + 0.5 * eps ** 2, dim=tuple(range(1, z.ndim)))


class ConditionalDiagGaussian(BaseDistribution):
    """Diagonal Gaussian whose mean and log-scale come from a context
    encoder (``nf_tpu/distributions/base.py:95-127``; reference
    ``base.py:106-155``): ``context_encoder(context)`` gives ``(B, 2d)``,
    the mean its first half and the log-scale its second. A draw takes as
    many samples as the context has rows."""

    def __init__(self, shape, context_encoder):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape)
        self.context_encoder = context_encoder

    def _params(self, context):
        out = self.context_encoder(context)
        split = out.shape[-1] // 2
        return out[..., :split], out[..., split:]

    def forward(self, num_samples=1, generator=None, context=None):
        mean, log_scale = self._params(context)
        eps = torch.randn((num_samples,) + self.shape, generator=generator,
                          dtype=mean.dtype, device=mean.device)
        return _gaussian_sample(mean, log_scale, eps)

    def log_prob(self, z, context=None):
        mean, log_scale = self._params(context)
        return _gaussian_log_prob(mean, log_scale, z)


class UniformGaussian(BaseDistribution):
    """Per-index mix of uniform entries (width ``scale``, centred at 0) at
    ``ind`` and Gaussian ones elsewhere (``nf_tpu/distributions/base.py:
    160-205``; reference ``base.py:198-270``): the base of the circular
    NSF. Buffers ``scale``, ``ind``, ``ind_`` and ``inv_perm`` carry the
    reference's names."""

    def __init__(self, ndim, ind, scale=None, dtype=torch.float32):
        super().__init__()
        ind, other, inv_perm = complement_indices(ndim, ind)
        self.ndim = ndim
        scale = (torch.ones(ndim, dtype=dtype) if scale is None
                 else torch.as_tensor(scale, dtype=dtype).clone())
        self.register_buffer("scale", scale)
        self.register_buffer("ind", torch.tensor(ind, dtype=torch.int64))
        self.register_buffer("ind_", torch.tensor(other, dtype=torch.int64))
        self.register_buffer("inv_perm",
                             torch.tensor(inv_perm, dtype=torch.int64))

    def forward(self, num_samples=1, generator=None, context=None):
        z = self.sample(num_samples, generator=generator)
        return z, self.log_prob(z)

    def sample(self, num_samples=1, generator=None, context=None):
        kw = dict(generator=generator, dtype=self.scale.dtype,
                  device=self.scale.device)
        eps_u = torch.rand((num_samples, self.ind.shape[0]), **kw) - 0.5
        eps_g = torch.randn((num_samples, self.ind_.shape[0]), **kw)
        z = torch.cat([eps_u, eps_g], dim=-1)[..., self.inv_perm]
        return self.scale * z

    def log_prob(self, z, context=None):
        log_p_u = torch.broadcast_to(-torch.log(self.scale[self.ind]),
                                     (z.shape[0], self.ind.shape[0]))
        sc = self.scale[self.ind_]
        log_p_g = (-0.5 * _LOG2PI - torch.log(sc)
                   - 0.5 * (z[..., self.ind_] / sc) ** 2)
        return torch.sum(log_p_u, -1) + torch.sum(log_p_g, -1)


class ClassCondDiagGaussian(BaseDistribution):
    """Class-conditional diagonal Gaussian (``base.py:215-269``; reference
    ``base.py:273-344``): ``loc`` and ``log_scale`` (``*shape``,
    num_classes), one column per class, selected by the labels ``y``
    (integers (B,) or one-hot (B, num_classes)). Without ``y`` a draw
    takes its labels uniformly from ``generator`` first."""

    def __init__(self, shape, num_classes, dtype=torch.float32):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.shape = shape
        self.num_classes = num_classes
        self.temperature = None
        self.loc = nn.Parameter(torch.zeros(shape + (num_classes,),
                                            dtype=dtype))
        self.log_scale = nn.Parameter(torch.zeros(shape + (num_classes,),
                                                  dtype=dtype))

    def _params(self, y):
        yt = one_hot(y, self.num_classes, self.loc.dtype).T
        perm = (len(self.shape),) + tuple(range(len(self.shape)))
        loc = (self.loc @ yt).permute(perm)
        log_scale = (self.log_scale @ yt).permute(perm)
        if self.temperature is not None:
            log_scale = log_scale + math.log(self.temperature)
        return loc, log_scale

    def forward(self, num_samples=1, generator=None, y=None):
        if y is None:
            y = _draw_labels(num_samples, self.num_classes, generator,
                             self.loc.device)
        num_samples = y.shape[0]
        loc, log_scale = self._params(y)
        eps = torch.randn((num_samples,) + self.shape, generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        return _gaussian_sample(loc, log_scale, eps)

    def log_prob(self, z, y=None):
        loc, log_scale = self._params(y)
        return _gaussian_log_prob(loc, log_scale, z)


def _draw_labels(num_samples, num_classes, generator, device):
    return torch.randint(0, num_classes, (num_samples,), generator=generator,
                         device=device)


class GlowBase(BaseDistribution):
    """Glow's base (``base.py:272-346``; reference ``base.py:347-471``): a
    Gaussian per channel, its mean ``loc * exp(3 loc_logs)`` and
    log-scale ``log_scale * exp(3 log_scale_logs)`` (``logscale_factor``
    3), with, given ``num_classes``, per-class offsets ``loc_cc`` and
    ``log_scale_cc`` selected by the labels ``y``."""

    def __init__(self, shape, num_classes=None, logscale_factor=3.0,
                 dtype=torch.float32):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.shape = shape
        self.num_classes = num_classes
        self.logscale_factor = logscale_factor
        self.temperature = None
        pshape = (1, shape[0]) + (1,) * (len(shape) - 1)
        for name in ("loc", "loc_logs", "log_scale", "log_scale_logs"):
            setattr(self, name, nn.Parameter(torch.zeros(pshape,
                                                         dtype=dtype)))
        for name in ("loc_cc", "log_scale_cc"):
            self.register_parameter(name, nn.Parameter(torch.zeros(
                num_classes, shape[0], dtype=dtype))
                if num_classes is not None else None)

    @property
    def class_cond(self):
        return self.num_classes is not None

    def _params(self, y):
        loc = self.loc * torch.exp(self.loc_logs * self.logscale_factor)
        log_scale = self.log_scale * torch.exp(
            self.log_scale_logs * self.logscale_factor)
        if self.class_cond:
            y = one_hot(y, self.num_classes, self.loc.dtype)
            cshape = (y.shape[0], self.shape[0]) + (1,) * (len(self.shape)
                                                           - 1)
            loc = loc + (y @ self.loc_cc).reshape(cshape)
            log_scale = log_scale + (y @ self.log_scale_cc).reshape(cshape)
        if self.temperature is not None:
            log_scale = log_scale + math.log(self.temperature)
        return loc, log_scale

    def _log_p(self, log_scale, sq):
        d = math.prod(self.shape)
        num_pix = math.prod(self.shape[1:])
        dims = tuple(range(1, len(self.shape) + 1))
        return (-0.5 * d * _LOG2PI - num_pix * torch.sum(log_scale, dim=dims)
                - 0.5 * torch.sum(sq, dim=dims))

    def forward(self, num_samples=1, generator=None, y=None):
        if self.class_cond:
            if y is None:
                y = _draw_labels(num_samples, self.num_classes, generator,
                                 self.loc.device)
            num_samples = y.shape[0]
        loc, log_scale = self._params(y)
        eps = torch.randn((num_samples,) + self.shape, generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        z = loc + torch.exp(log_scale) * eps
        return z, self._log_p(log_scale, eps ** 2)

    def log_prob(self, z, y=None):
        loc, log_scale = self._params(y)
        return self._log_p(log_scale, ((z - loc) / torch.exp(log_scale)) ** 2)
