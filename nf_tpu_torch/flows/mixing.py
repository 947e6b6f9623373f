"""Mixing layers (``nf_tpu/flows/mixing.py``; reference
``normflows/flows/mixing.py``): the channel permutation of the MAF stack,
Glow's invertible 1x1 convolution, its ``(B, D)`` twin
``InvertibleAffine`` and the LU mixing of the NSF stack."""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..utils.nn import softplus
from .base import Flow


class Permute(Flow):
    """Channel permutation, a fixed random ``"shuffle"`` (drawn from
    ``generator``) or ``"swap"`` of the halves (``mixing.py:29-68``;
    reference ``mixing.py:9-54``). A shuffle keeps the buffers ``perm``
    and ``inv_perm``, the names the JAX exporter writes."""

    def __init__(self, num_channels, mode="shuffle", generator=None):
        super().__init__()
        if mode not in ("shuffle", "swap"):
            raise NotImplementedError(f"The mode {mode} is not implemented.")
        perm = inv_perm = None
        if mode == "shuffle":
            perm = torch.randperm(num_channels, generator=generator)
            inv_perm = torch.argsort(perm)
        self.register_buffer("perm", perm)
        self.register_buffer("inv_perm", inv_perm)
        self.num_channels = num_channels
        self.mode = mode

    def _permute(self, z, perm, first):
        if self.mode == "shuffle":
            z = torch.index_select(z, 1, perm)
        else:
            z = torch.cat([z[:, first:], z[:, :first]], dim=1)
        return z, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)

    def forward(self, z, context=None, generator=None):
        return self._permute(z, self.perm, self.num_channels // 2)

    def inverse(self, z, context=None, generator=None):
        return self._permute(z, self.inv_perm, (self.num_channels + 1) // 2)


def _random_orthogonal(num_channels, generator):
    """A random rotation drawn from ``generator`` (float64), the
    reference's initialisation (``mixing.py:70-84``): a model loaded from
    the JAX package takes its weights from the bridge instead."""
    q, _ = torch.linalg.qr(torch.randn(num_channels, num_channels,
                                       generator=generator,
                                       dtype=torch.float64))
    return q


def _f32(t):
    """A bfloat16 tensor as float32; any other tensor as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


class _LUWeight(Flow):
    """A learned invertible ``W`` (``mixing.py:90-105``): ``use_lu=True``
    keeps ``W = P L U`` as the parameters ``L``, ``U`` and ``log_S`` with
    the buffers ``P``, ``sign_S`` and ``eye`` (the reference's names), so
    ``W^-1`` is two triangular solves and ``log |det W| = sum(log_S)``;
    ``use_lu=False`` keeps ``W`` itself, inverted and its determinant
    taken by ``torch.linalg``. Initialised to a random rotation drawn from
    ``generator``."""

    def __init__(self, num_channels, use_lu, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_channels = num_channels
        self.use_lu = use_lu
        q = _random_orthogonal(num_channels, generator)
        if use_lu:
            p, lower, upper = torch.linalg.lu(q)
            s = torch.diagonal(upper)
            self.L = nn.Parameter(torch.tril(lower, -1).to(dtype))
            self.U = nn.Parameter(torch.triu(upper, 1).to(dtype))
            self.log_S = nn.Parameter(torch.log(torch.abs(s)).to(dtype))
            self.register_buffer("P", p.to(dtype))
            self.register_buffer("sign_S", torch.sign(s).to(dtype))
            self.register_buffer("eye", torch.eye(num_channels,
                                                  dtype=dtype))
        else:
            self.W = nn.Parameter(q.to(dtype))

    def _assemble_w(self, inverse):
        eye = _f32(self.eye)
        lower = torch.tril(_f32(self.L), -1) + eye
        upper = torch.triu(_f32(self.U), 1) + torch.diag(
            _f32(self.sign_S) * torch.exp(_f32(self.log_S)))
        if inverse:
            l_inv = torch.linalg.solve_triangular(lower, eye, upper=False,
                                                  unitriangular=True)
            u_inv = torch.linalg.solve_triangular(upper, eye, upper=True)
            return u_inv @ l_inv @ _f32(self.P).T
        return _f32(self.P) @ lower @ upper

    def _weight(self, inverse):
        """``(W or W^-1, log |det| of it)``. A bfloat16 layer assembles,
        solves, inverts and takes the log-determinant in float32 (neither
        device has a bfloat16 triangular solve, inverse or determinant),
        then casts the weight to bfloat16; the log-det stays float32 until
        the layer's output casts it. A float32 layer computes the same
        operations with no cast."""
        dtype = self.L.dtype if self.use_lu else self.W.dtype
        if self.use_lu:
            w = self._assemble_w(inverse)
            log_det = torch.sum(_f32(self.log_S))
        else:
            weight = _f32(self.W)
            # inv_ex: no check of the factorisation's status, which
            # would wait for the device
            w = torch.linalg.inv_ex(weight).inverse if inverse else weight
            log_det = torch.linalg.slogdet(weight)[1]
        return w.to(dtype), -log_det if inverse else log_det


class Invertible1x1Conv(_LUWeight):
    """Glow's invertible 1x1 convolution on NCHW tensors
    (``mixing.py:97-160``; reference ``mixing.py:57-133``). As in the
    reference, ``forward`` (the sampling direction) applies ``W^-1`` and
    ``inverse`` applies ``W``; the log-det is ``log |det W|`` per pixel
    times H*W. The channel mixing is one product,
    ``einsum("oi,bihw->bohw")``, in float32 as every product of the
    port."""

    def __init__(self, num_channels, use_lu=False, generator=None,
                 dtype=torch.float32):
        super().__init__(num_channels, use_lu, generator, dtype)

    def _mix(self, z, inverse):
        w, log_det = self._weight(inverse)
        z_ = torch.einsum("oi,bihw->bohw", w, z)
        log_det = log_det * (z.shape[2] * z.shape[3])
        return z_, torch.broadcast_to(log_det, (z.shape[0],)).to(z.dtype)

    def forward(self, z, context=None, generator=None):
        return self._mix(z, inverse=True)

    def inverse(self, z, context=None, generator=None):
        return self._mix(z, inverse=False)


class InvertibleAffine(_LUWeight):
    """The invertible 1x1 convolution on ``(B, D)`` features
    (``mixing.py:161-201``; reference ``mixing.py:136-207``): ``forward``
    is ``z @ W^-1``, ``inverse`` ``z @ W``, the log-det ``-+log |det W|``
    for every sample. LU-parametrised by default."""

    def __init__(self, num_channels, use_lu=True, generator=None,
                 dtype=torch.float32):
        super().__init__(num_channels, use_lu, generator, dtype)

    def _mix(self, z, inverse):
        w, log_det = self._weight(inverse)
        return z @ w, torch.broadcast_to(log_det, (z.shape[0],)).to(z.dtype)

    def forward(self, z, context=None, generator=None):
        return self._mix(z, inverse=True)

    def inverse(self, z, context=None, generator=None):
        return self._mix(z, inverse=False)


class _Permutation(Flow):
    """Index-select permutation along ``dim`` (reference
    ``mixing.py:213-247``); the buffer keeps the reference's name."""

    def __init__(self, permutation, dim=1):
        super().__init__()
        self.register_buffer("_permutation",
                             torch.as_tensor(permutation, dtype=torch.int64))
        self.dim = dim

    def forward(self, z, context=None, generator=None):
        z_ = torch.index_select(z, self.dim, self._permutation)
        return z_, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)

    def inverse(self, z, context=None, generator=None):
        z_ = torch.index_select(z, self.dim, torch.argsort(self._permutation))
        return z_, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


class _RandomPermutation(_Permutation):
    """Random fixed permutation (reference ``mixing.py:250-254``)."""

    def __init__(self, features, dim=1, generator=None):
        super().__init__(torch.randperm(features, generator=generator), dim)


_CACHE = ("cache_weight", "cache_inverse", "cache_logabsdet")


class LULinear(Flow):
    """``y = L U x + b`` with unit-diagonal L and ``diag(U) = softplus(raw)
    + eps`` (reference ``mixing.py:368-532``); the inverse is two
    triangular solves and the log-det is ``sum(log diag(U))``.
    :meth:`with_cache` returns a copy that keeps the weight, its inverse
    and the log-det precomputed."""

    def __init__(self, features, eps=1e-3, dtype=torch.float32):
        super().__init__()
        n_tri = ((features - 1) * features) // 2
        # identity init: L = U = I
        self.lower_entries = nn.Parameter(torch.zeros(n_tri, dtype=dtype))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri, dtype=dtype))
        self.unconstrained_upper_diag = nn.Parameter(torch.full(
            (features,), math.log(math.exp(1 - eps) - 1), dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))
        self.register_buffer("_lower_indices",
                             torch.tril_indices(features, features, -1),
                             persistent=False)
        self.register_buffer("_upper_indices",
                             torch.triu_indices(features, features, 1),
                             persistent=False)
        self.features = features
        self.eps = eps
        # with_cache's weight, inverse and log-det; None when not cached
        for name in _CACHE:
            self.register_buffer(name, None, persistent=False)

    @property
    def upper_diag(self):
        return softplus(self.unconstrained_upper_diag) + self.eps

    def _create_lower_upper(self):
        n = self.features
        dtype, device = self.lower_entries.dtype, self.lower_entries.device
        lower = torch.zeros(n, n, dtype=dtype, device=device)
        lower = lower.index_put(tuple(self._lower_indices),
                                self.lower_entries)
        lower = lower + torch.eye(n, dtype=dtype, device=device)
        upper = torch.zeros(n, n, dtype=dtype, device=device)
        upper = upper.index_put(tuple(self._upper_indices),
                                self.upper_entries)
        upper = upper + torch.diag(self.upper_diag)
        return lower, upper

    def logabsdet(self):
        return torch.sum(torch.log(self.upper_diag))

    def with_cache(self):
        """A new layer whose weight ``L U``, its inverse (two triangular
        solves against the identity) and log-det are computed once, for
        serving (``mixing.py:299``); ``self`` is unchanged. The cache is
        computed without gradient and is not part of the state dict;
        training goes on through the uncached layer."""
        new = copy.deepcopy(self)
        with torch.no_grad():
            lower, upper = self._create_lower_upper()
            eye = torch.eye(self.features, dtype=lower.dtype,
                            device=lower.device)
            l_inv = torch.linalg.solve_triangular(lower, eye, upper=False,
                                                  unitriangular=True)
            new.cache_weight = lower @ upper
            new.cache_inverse = torch.linalg.solve_triangular(upper, l_inv,
                                                              upper=True)
            new.cache_logabsdet = self.logabsdet()
        return new

    def without_cache(self):
        """A new layer without the cache (``mixing.py:310``); ``self`` is
        unchanged."""
        new = copy.deepcopy(self)
        for name in _CACHE:
            setattr(new, name, None)
        return new

    def forward(self, z, context=None, generator=None):
        if self.cache_weight is not None:
            out = z @ self.cache_weight.T + self.bias
            ld = self.cache_logabsdet
        else:
            lower, upper = self._create_lower_upper()
            out = (z @ upper.T) @ lower.T + self.bias
            ld = self.logabsdet()
        return out, torch.broadcast_to(ld, (z.shape[0],)).to(z.dtype)

    def inverse(self, z, context=None, generator=None):
        if self.cache_inverse is not None:
            out = (z - self.bias) @ self.cache_inverse.T
            ld = -self.cache_logabsdet
        else:
            # a bfloat16 layer solves in float32 (neither device has a
            # bfloat16 triangular solve) and rounds the solution once
            lower, upper = (_f32(t) for t in self._create_lower_upper())
            rhs = _f32(z - self.bias).T
            sol = torch.linalg.solve_triangular(lower, rhs, upper=False,
                                                unitriangular=True)
            out = torch.linalg.solve_triangular(upper, sol,
                                                upper=True).T.to(z.dtype)
            ld = -self.logabsdet()
        return out, torch.broadcast_to(ld, (z.shape[0],)).to(z.dtype)


class LULinearPermute(Flow):
    """Fixed random permutation composed with an LU linear transform, the
    NSF mixing layer (reference ``mixing.py:535-563``). ``forward``
    applies ``linear.inverse`` then ``permutation.inverse``. ``dtype`` is
    the LU parameters' (the JAX package's ``LULinear.create(dtype=)``);
    a bfloat16 layer's solves run in float32."""

    def __init__(self, num_channels, generator=None, dtype=torch.float32):
        super().__init__()
        self.permutation = _RandomPermutation(num_channels,
                                              generator=generator)
        self.linear = LULinear(num_channels, dtype=dtype)

    def forward(self, z, context=None, generator=None):
        z, log_det = self.linear.inverse(
            z, context=context, generator=generator)
        z, _ = self.permutation.inverse(
            z, context=context, generator=generator)
        return z, log_det

    def inverse(self, z, context=None, generator=None):
        z, _ = self.permutation.forward(
            z, context=context, generator=generator)
        z, log_det = self.linear.forward(
            z, context=context, generator=generator)
        return z, log_det
