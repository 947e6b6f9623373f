"""Lipschitz-constrained networks for residual flows
(``nf_tpu/nets/lipschitz.py:32-396``; reference ``normflows/nets/
lipschitz.py``, from the residual-flows codebase).

Induced-norm normalisation by power iteration. The vectors ``u`` and
``v`` are registered buffers (the reference's names) that
:meth:`InducedNormLinear.update_power_iteration` advances under
``torch.no_grad()`` and writes in place (``copy_``): a training step
captured as a CUDA graph keeps their addresses, and
``nf_tpu_torch.utils.optim.update_lipschitz`` can run inside it. The
forward pass reads the stored ``u`` and ``v`` detached (the JAX package's
``stop_gradient``) and divides the weight by ``max(1, sigma / coeff)``,
so the gradient flows through sigma's dependence on the weight
(reference ``lipschitz.py:267-269``).

The (p, q) induced norms take every static order the JAX package takes,
through ``domain`` / ``codomain`` and the dual projections
:func:`normalize_u` / :func:`normalize_v`; (2, 2), the spectral norm, is
the one the reference's ``LipschitzMLP`` / ``LipschitzCNN`` instantiate.
Initial weights and vectors are drawn on the host from the constructor's
``generator``, as the port's other modules draw theirs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.nn import softplus


def _l2_normalize(x, eps=1e-12):
    return x / (torch.linalg.vector_norm(x) + eps)


def vector_norm(x, p):
    """``(sum |x|^p)^(1/p)`` over the flattened vector (reference
    ``vector_norm``)."""
    x = torch.abs(x.reshape(-1))
    return torch.sum(x ** p) ** (1.0 / p)


def projmax(v):
    """One-hot at the argmax of ``|v|`` (the reference's in-place
    ``projmax_``), by comparison: nothing waits for the device."""
    idx = torch.argmax(torch.abs(v))
    return (torch.arange(v.shape[0], device=v.device) == idx).to(v.dtype)


def _phase(x):
    """``x / |x|`` with 0 -> 1 (the reference sets NaN phases to 1)."""
    xabs = torch.abs(x)
    return torch.where(xabs > 0, x / torch.where(xabs > 0, xabs, 1.0), 1.0)


def normalize_v(v, domain, eps=1e-12):
    """Project onto the unit ``domain``-norm sphere along the dual-scaling
    direction (reference ``normalize_v``); ``domain`` a static float."""
    domain = float(domain)
    if domain == 2.0:
        return _l2_normalize(v, eps)
    if domain == 1.0:
        return projmax(v)
    vabs = torch.abs(v)
    vabs = vabs / (torch.max(vabs) + eps)
    vabs = vabs ** (1.0 / (domain - 1.0))
    return _phase(v) * vabs / (vector_norm(vabs, domain) + eps)


def normalize_u(u, codomain, eps=1e-12):
    """Dual projection for the output side (reference ``normalize_u``);
    ``codomain`` a static float, ``inf`` the max coordinate."""
    codomain = float(codomain)
    if codomain == 2.0:
        return _l2_normalize(u, eps)
    if codomain == float("inf"):
        return projmax(u)
    uabs = torch.abs(u)
    uabs = uabs / (torch.max(uabs) + eps)
    uabs = uabs ** (codomain - 1.0)
    if codomain == 1.0:
        return _phase(u) * uabs / (torch.max(torch.abs(uabs)) + eps)
    return _phase(u) * uabs / (vector_norm(uabs, codomain / (codomain - 1.0))
                               + eps)


def leaky_elu(x, a=0.3):
    """``a x + (1 - a) elu(x)`` (reference ``leaky_elu``)."""
    return a * x + (1 - a) * F.elu(x)


def asym_squash(x):
    """An unconstrained scalar squashed into (1, 5), for learnable-order
    norms (reference ``asym_squash``)."""
    return torch.tanh(-leaky_elu(-x + 0.5493061829986572)) * 2.0 + 3.0


class Swish(nn.Module):
    """``x * sigmoid(softplus(beta) * x) / 1.1`` with a trainable ``beta``
    (reference ``lipschitz.py:642-648``); Lipschitz constant <= 1."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.beta = nn.Parameter(torch.full((1,), 0.5, dtype=dtype))

    def forward(self, x):
        return x * torch.sigmoid(x * softplus(self.beta)) / 1.1


def _uniform(shape, bound, generator, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def _normal(n, generator, dtype):
    return torch.randn(n, generator=generator, dtype=dtype)


class _InducedNorm(nn.Module):
    """What the dense and the convolutional layer share: the weight, the
    optional bias, the buffers ``u`` and ``v``, and the power iteration
    over the layer's map ``w @ v`` and its adjoint."""

    def _setup(self, weight, bias, u, v, coeff, n_iterations, domain,
               codomain):
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None
        self.register_buffer("u", u)
        self.register_buffer("v", v)
        self.coeff = coeff
        self.n_iterations = n_iterations
        self.domain = float(domain)
        self.codomain = float(codomain)

    def _warm_start(self, make_uv):
        """The 200-iteration warm start (reference ``lipschitz.py:148``);
        past (2, 2), ten restarts from ``make_uv()`` keep the largest sigma
        (``lipschitz.py:176-194``)."""
        self.update_power_iteration(200)
        if (self.domain, self.codomain) == (2.0, 2.0):
            return
        with torch.no_grad():
            best_u, best_v = self.u.clone(), self.v.clone()
            best = self.scale
            for _ in range(10):
                u, v = make_uv()
                self.u.copy_(u)
                self.v.copy_(v)
                self.update_power_iteration(200)
                scale = self.scale
                better = scale > best
                best_u = torch.where(better, self.u, best_u)
                best_v = torch.where(better, self.v, best_v)
                best = torch.maximum(best, scale)
            self.u.copy_(best_u)
            self.v.copy_(best_v)

    def _map(self, v, w):
        raise NotImplementedError()

    def _adjoint(self, u, w):
        raise NotImplementedError()

    def update_power_iteration(self, n_iterations=None):
        """Advance the u/v power iteration ``n_iterations`` steps (default
        the layer's ``n_iterations``) in place; returns the layer
        (``lipschitz.py:171-185``)."""
        n = n_iterations if n_iterations is not None else self.n_iterations
        with torch.no_grad():
            w = self.weight.detach()
            u, v = self.u, self.v
            for _ in range(n):
                u = normalize_u(self._map(v, w), self.codomain)
                v = normalize_v(self._adjoint(u, w), self.domain)
            self.u.copy_(u)
            self.v.copy_(v)
        return self

    def _sigma(self):
        """``u . (W v)`` with ``u`` and ``v`` detached: a function of the
        weight only."""
        return torch.dot(self.u.detach(), self._map(self.v.detach(),
                                                    self.weight))

    @property
    def scale(self):
        """The current induced-norm estimate sigma (a diagnostic)."""
        return self._sigma()

    def _effective_weight(self):
        factor = torch.clamp_min(self._sigma() / self.coeff, 1.0)
        return self.weight / factor


class InducedNormLinear(_InducedNorm):
    """Induced-norm normalised dense layer (``lipschitz.py:111-205``;
    reference ``lipschitz.py:132-295``)."""

    def __init__(self, in_features, out_features, bias=True, coeff=0.97,
                 n_iterations=5, zero_init=False, domain=2.0, codomain=2.0,
                 generator=None, dtype=torch.float32):
        super().__init__()
        bound_w = float(np.sqrt(1.0 / in_features))
        weight = _uniform((out_features, in_features),
                          bound_w * np.sqrt(3) * np.sqrt(2), generator, dtype)
        if zero_init:
            weight = weight / 1000.0  # the iteration cannot start at 0
        b = (_uniform((out_features,), bound_w, generator, dtype)
             if bias else None)

        def make_uv():
            return (normalize_u(_normal(out_features, generator, dtype),
                                codomain),
                    normalize_v(_normal(in_features, generator, dtype),
                                domain))

        self._setup(weight, b, *make_uv(), coeff, n_iterations, domain,
                    codomain)
        self._warm_start(make_uv)

    def _map(self, v, w):
        return w @ v

    def _adjoint(self, u, w):
        return w.T @ u

    def forward(self, x):
        return F.linear(x, self._effective_weight(), self.bias)


class InducedNormConv2d(_InducedNorm):
    """Induced-norm normalised convolution (``lipschitz.py:208-342``;
    reference ``lipschitz.py:295-610``). A k x k kernel's power iteration
    runs a convolution and its transpose on whole input-shaped vectors, so
    ``spatial_dims`` (H, W) is given at construction; a 1 x 1 kernel's is
    the dense layer's on its (out, in) matrix. The transpose is the JAX
    package's ``conv_transpose(transpose_kernel=True)``: a convolution of
    the stride-dilated input with the flipped, transposed kernel, padded
    by ``padding`` on each side."""

    def __init__(self, in_channels, out_channels, kernel_size, spatial_dims,
                 stride=1, padding=None, bias=True, coeff=0.97,
                 n_iterations=5, zero_init=False, domain=2.0, codomain=2.0,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if padding is None:
            padding = kernel_size // 2
        self.stride = stride
        self.padding = padding
        self.spatial_dims = tuple(int(s) for s in spatial_dims)
        bound_w = float(np.sqrt(1.0 / (in_channels * kernel_size ** 2)))
        weight = _uniform((out_channels, in_channels, kernel_size,
                           kernel_size), bound_w * np.sqrt(3) * np.sqrt(2),
                          generator, dtype)
        if zero_init:
            weight = weight / 1000.0
        b = (_uniform((out_channels,), bound_w, generator, dtype)
             if bias else None)
        h, w = self.spatial_dims
        # the output's shape for one input-shaped vector
        self.out_shape = tuple(self._conv(torch.zeros(
            (1, in_channels, h, w), dtype=dtype), weight).shape)
        if kernel_size == 1:
            n_in, n_out = in_channels, out_channels
        else:
            n_in, n_out = in_channels * h * w, int(np.prod(self.out_shape))
        # the JAX package draws v before u here (lipschitz.py:256-266)
        v = normalize_v(_normal(n_in, generator, dtype), domain)
        u = normalize_u(_normal(n_out, generator, dtype), codomain)
        self._setup(weight, b, u, v, coeff, n_iterations, domain, codomain)
        self.update_power_iteration(200)

    def _pointwise(self):
        return self.weight.shape[-1] == 1 and self.weight.shape[-2] == 1

    def _conv(self, x, w):
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)

    def _conv_t(self, y, w):
        s = self.stride
        if s > 1:
            n, c, h, w_ = y.shape
            dilated = y.new_zeros((n, c, (h - 1) * s + 1, (w_ - 1) * s + 1))
            dilated[:, :, ::s, ::s] = y
            y = dilated
        return F.conv2d(y, w.flip(-1, -2).transpose(0, 1),
                        padding=self.padding)

    def _map(self, v, w):
        if self._pointwise():
            return w[:, :, 0, 0] @ v
        c_in = w.shape[1]
        h, w_sp = self.spatial_dims
        return self._conv(v.reshape(1, c_in, h, w_sp), w).reshape(-1)

    def _adjoint(self, u, w):
        if self._pointwise():
            return w[:, :, 0, 0].T @ u
        return self._conv_t(u.reshape(self.out_shape), w).reshape(-1)

    def forward(self, x):
        y = self._conv(x, self._effective_weight())
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


class LipschitzMLP(nn.Module):
    """Swish and induced-norm dense layers, Lipschitz constant below
    ``lipschitz_const`` (``lipschitz.py:345-368``; reference
    ``lipschitz.py:14-67``). ``net`` is the reference's ``nn.Sequential``
    (Swish at even indices, the dense layers at odd ones), so reference
    names load as they stand; the last layer starts near zero
    (``init_zeros``)."""

    def __init__(self, channels, lipschitz_const=0.97, max_lipschitz_iter=5,
                 init_zeros=True, generator=None, dtype=torch.float32):
        super().__init__()
        n = len(channels) - 1
        layers = []
        for i in range(n):
            layers += [Swish(dtype), InducedNormLinear(
                channels[i], channels[i + 1], coeff=lipschitz_const,
                n_iterations=max_lipschitz_iter,
                zero_init=(init_zeros and i == n - 1), generator=generator,
                dtype=dtype)]
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class LipschitzCNN(nn.Module):
    """Swish and induced-norm convolutions (``lipschitz.py:371-396``;
    reference ``lipschitz.py:70-129``), the layers in ``net`` as in
    :class:`LipschitzMLP`."""

    def __init__(self, channels, kernel_size, spatial_dims,
                 lipschitz_const=0.97, max_lipschitz_iter=5, init_zeros=True,
                 generator=None, dtype=torch.float32):
        super().__init__()
        n = len(kernel_size)
        layers = []
        for i in range(n):
            layers += [Swish(dtype), InducedNormConv2d(
                channels[i], channels[i + 1], kernel_size[i],
                spatial_dims=spatial_dims, coeff=lipschitz_const,
                n_iterations=max_lipschitz_iter,
                zero_init=(init_zeros and i == n - 1), generator=generator,
                dtype=dtype)]
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)
