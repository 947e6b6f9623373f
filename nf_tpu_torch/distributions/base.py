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

from .._device import resolve_device
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


class Uniform(BaseDistribution):
    """Box-uniform distribution on ``[low, high]^shape``
    (``nf_tpu/distributions/base.py:130-157``; reference
    ``base.py:158-195``). It holds no tensor: draws land on the
    generator's device (None: CUDA)."""

    def __init__(self, shape, low=-1.0, high=1.0):
        super().__init__()
        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.low = float(low)
        self.high = float(high)
        self.log_prob_val = -math.prod(self.shape) * math.log(high - low)

    def forward(self, num_samples=1, generator=None, context=None):
        dev = resolve_device(generator.device if generator is not None
                             else None)
        u = torch.rand((num_samples,) + self.shape, generator=generator,
                       device=dev)
        z = self.low + (self.high - self.low) * u
        return z, torch.full((num_samples,), self.log_prob_val,
                             dtype=z.dtype, device=dev)

    def log_prob(self, z, context=None):
        out_range = (z < self.low) | (z > self.high)
        ind_inf = torch.any(out_range.reshape(z.shape[0], -1), dim=-1)
        return torch.where(ind_inf, -math.inf, self.log_prob_val).to(z.dtype)


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


class AffineGaussian(BaseDistribution):
    """A standard Gaussian pushed through an affine-constant flow, or with
    ``num_classes`` a class-conditional one (``CCAffineConst``), sampled
    at ``temperature`` (``base.py:349-411``; reference
    ``base.py:474-570``). The flow is the submodule ``transform``
    (``s``, ``t`` and, class-conditional, ``s_cc``, ``t_cc``). Without
    ``y`` a class-conditional draw takes its labels uniformly from
    ``generator`` first."""

    def __init__(self, shape, affine_shape, num_classes=None,
                 dtype=torch.float32):
        super().__init__()
        from ..flows.affine import AffineConstFlow, CCAffineConst

        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.num_classes = num_classes
        self.temperature = None
        self.transform = (CCAffineConst(affine_shape, num_classes, dtype)
                          if num_classes is not None
                          else AffineConstFlow(affine_shape, dtype=dtype))

    @property
    def class_cond(self):
        return self.num_classes is not None

    def _log_scale(self):
        return math.log(self.temperature) if self.temperature else 0.0

    def forward(self, num_samples=1, generator=None, y=None):
        s = self.transform.s
        if self.class_cond:
            if y is None:
                y = _draw_labels(num_samples, self.num_classes, generator,
                                 s.device)
            num_samples = y.shape[0]
            y = one_hot(y, self.num_classes, s.dtype)
        log_scale = self._log_scale()
        d = math.prod(self.shape)
        dims = tuple(range(1, len(self.shape) + 1))
        eps = torch.randn((num_samples,) + self.shape, generator=generator,
                          dtype=s.dtype, device=s.device)
        z = math.exp(log_scale) * eps
        log_p = (-0.5 * d * _LOG2PI - d * log_scale
                 - 0.5 * torch.sum(eps ** 2, dim=dims))
        z, log_det = (self.transform.forward(z, y=y) if self.class_cond
                      else self.transform.forward(z))
        return z, log_p - log_det

    def log_prob(self, z, y=None):
        log_scale = self._log_scale()
        d = math.prod(self.shape)
        dims = tuple(range(1, len(self.shape) + 1))
        z, log_p = (self.transform.inverse(z, y=y) if self.class_cond
                    else self.transform.inverse(z))
        z = z / math.exp(log_scale)
        return (log_p - d * log_scale - 0.5 * d * _LOG2PI
                - 0.5 * torch.sum(z ** 2, dim=dims))


class GaussianMixture(BaseDistribution):
    """Diagonal Gaussian mixture of ``n_modes`` modes in ``dim``
    dimensions (``base.py:414-469``; reference ``base.py:573-659``):
    ``loc`` and ``log_scale`` (1, n_modes, dim) and ``weight_scores`` (1,
    n_modes), the log of the normalised weights. ``loc`` defaults to
    standard normal draws from ``generator``, ``scale`` and ``weights`` to
    ones. A non-trainable mixture keeps them as buffers."""

    def __init__(self, n_modes, dim, loc=None, scale=None, weights=None,
                 trainable=True, generator=None, dtype=torch.float32):
        super().__init__()
        self.n_modes = n_modes
        self.dim = dim
        if loc is None:
            loc = torch.randn((n_modes, dim), generator=generator,
                              dtype=dtype)
        loc = torch.as_tensor(loc, dtype=dtype)[None]
        scale = (torch.ones((n_modes, dim), dtype=dtype) if scale is None
                 else torch.as_tensor(scale, dtype=dtype))[None]
        weights = (torch.ones(n_modes, dtype=dtype) if weights is None
                   else torch.as_tensor(weights, dtype=dtype))[None]
        weights = weights / torch.sum(weights, dim=1, keepdim=True)
        for name, value in (("loc", loc), ("log_scale", torch.log(scale)),
                            ("weight_scores", torch.log(weights))):
            if trainable:
                setattr(self, name, nn.Parameter(value.clone()))
            else:
                self.register_buffer(name, value.clone())

    def forward(self, num_samples=1, generator=None, context=None):
        weights = torch.softmax(self.weight_scores, dim=1)
        # the mode by inverting the weights' CDF at a uniform draw: no
        # host check of the weights, as torch.multinomial makes
        u = torch.rand((num_samples, 1), generator=generator,
                       dtype=self.loc.dtype, device=self.loc.device)
        cdf = torch.cumsum(weights[0], dim=0)
        mode = torch.clamp_max(torch.sum(u >= cdf, dim=1), self.n_modes - 1)
        mode_1h = one_hot(mode, self.n_modes, self.loc.dtype)[..., None]
        eps = torch.randn((num_samples, self.dim), generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        scale_sample = torch.sum(torch.exp(self.log_scale) * mode_1h, dim=1)
        loc_sample = torch.sum(self.loc * mode_1h, dim=1)
        z = eps * scale_sample + loc_sample
        return z, self.log_prob(z)

    def log_prob(self, z, context=None):
        weights = torch.softmax(self.weight_scores, dim=1)
        eps = (z[:, None, :] - self.loc) / torch.exp(self.log_scale)
        log_p = (-0.5 * self.dim * _LOG2PI + torch.log(weights)
                 - 0.5 * torch.sum(eps ** 2, dim=2)
                 - torch.sum(self.log_scale, dim=2))
        return torch.logsumexp(log_p, dim=1)


class GaussianPCA(BaseDistribution):
    """Low-rank-plus-noise Gaussian, covariance ``W^T W + sigma^2 I``
    (``base.py:472-520``; reference ``base.py:662-719``). As in the JAX
    package, the density is the correct ``-d/2 log 2 pi - 1/2 log det
    Sigma - 1/2 z^T Sigma^-1 z`` (the reference drops the log of the
    determinant), and a draw adds the ``sigma`` noise so the samples
    follow it. ``W`` is drawn from ``generator``."""

    def __init__(self, dim, latent_dim=None, sigma=0.1, generator=None,
                 dtype=torch.float32):
        super().__init__()
        latent_dim = dim if latent_dim is None else latent_dim
        self.dim = dim
        self.latent_dim = latent_dim
        self.loc = nn.Parameter(torch.zeros(1, dim, dtype=dtype))
        self.W = nn.Parameter(torch.randn((latent_dim, dim),
                                          generator=generator, dtype=dtype))
        self.log_sigma = nn.Parameter(torch.tensor(math.log(sigma),
                                                   dtype=dtype))

    def _sig(self):
        eye = torch.eye(self.dim, dtype=self.W.dtype, device=self.W.device)
        return self.W.T @ self.W + torch.exp(self.log_sigma * 2) * eye

    def forward(self, num_samples=1, generator=None, context=None):
        kw = dict(generator=generator, dtype=self.loc.dtype,
                  device=self.loc.device)
        eps = torch.randn((num_samples, self.latent_dim), **kw)
        noise = torch.exp(self.log_sigma) * torch.randn(
            (num_samples, self.dim), **kw)
        z_ = eps @ self.W + noise
        return z_ + self.loc, self._log_prob_centered(z_)

    def _log_prob_centered(self, z_):
        sig = self._sig()
        logdet = torch.linalg.slogdet(sig)[1]
        quad = torch.sum(z_ * torch.linalg.solve(sig, z_.T).T, dim=1)
        return -0.5 * self.dim * _LOG2PI - 0.5 * logdet - 0.5 * quad

    def log_prob(self, z, context=None):
        return self._log_prob_centered(z - self.loc)
