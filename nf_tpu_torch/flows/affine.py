"""Affine flow layers (``nf_tpu/flows/affine.py``; reference
``normflows/flows/affine/coupling.py``): the constant scale-and-shift
layer, its class-conditional form, RealNVP's masked coupling and Glow's
affine coupling on a split pair. All are elementwise around plain
products or convolutions; no kernel of the JAX package runs here."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.nn import one_hot, sum_except_batch
from .base import Flow, zero_log_det_like_z
from .reshape import Merge, Split


class AffineConstFlow(Flow):
    """Learned constant scale and shift per dimension, ``z * exp(s) + t``
    (``affine.py:24-78``; reference ``coupling.py:9-54``). ``s`` and ``t``
    have shape ``(1, *shape)``, possibly with broadcast axes of size 1;
    the log-det multiplies ``sum(s)`` by the number of positions each
    entry of ``s`` covers. The JAX package's ``scale=False`` /
    ``shift=False`` switches are not ported: none of its builders or
    layers turns them off."""

    def __init__(self, shape, dtype=torch.float32):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        self.s = nn.Parameter(torch.zeros((1,) + tuple(shape), dtype=dtype))
        self.t = nn.Parameter(torch.zeros((1,) + tuple(shape), dtype=dtype))

    def _log_det(self, z, sign):
        n = math.prod(z.shape[i] for i in range(1, z.ndim)
                      if self.s.shape[i] == 1)
        return (sign * n * torch.sum(self.s)).to(z.dtype).expand(z.shape[0])

    def forward(self, z, context=None, generator=None):
        return z * torch.exp(self.s) + self.t, self._log_det(z, 1)

    def inverse(self, z, context=None, generator=None):
        return (z - self.t) * torch.exp(-self.s), self._log_det(z, -1)


class MaskedAffineFlow(Flow):
    """RealNVP's masked coupling ``f(z) = b*z + (1-b)*(z*exp(s(b*z)) +
    t(b*z))`` (``affine.py:211-250``; reference ``coupling.py:174-229``).
    ``b`` is a buffer of shape ``(1, D)``; ``s`` and ``t`` are the scale
    and shift nets (None: no scaling, no shift). A non-finite output of a
    net becomes NaN, the reference's guard, with no read of the device."""

    def __init__(self, b, t=None, s=None):
        super().__init__()
        self.register_buffer("b", torch.as_tensor(b).clone()[None])
        self.s = s
        self.t = t

    def _nets(self, z_masked):
        scale = _finite_or_nan(self.s(z_masked)) if self.s is not None \
            else torch.zeros_like(z_masked)
        trans = _finite_or_nan(self.t(z_masked)) if self.t is not None \
            else torch.zeros_like(z_masked)
        return scale, trans

    def forward(self, z, context=None, generator=None):
        z_masked = self.b * z
        scale, trans = self._nets(z_masked)
        z_ = z_masked + (1 - self.b) * (z * torch.exp(scale) + trans)
        return z_, sum_except_batch((1 - self.b) * scale)

    def inverse(self, z, context=None, generator=None):
        z_masked = self.b * z
        scale, trans = self._nets(z_masked)
        z_ = z_masked + (1 - self.b) * (z - trans) * torch.exp(-scale)
        return z_, -sum_except_batch((1 - self.b) * scale)


def _finite_or_nan(x):
    return torch.where(torch.isfinite(x), x, torch.nan)


class CCAffineConst(Flow):
    """Class-conditional constant scale and shift (``affine.py:81-128``;
    reference ``coupling.py:57-96``): ``s + y @ s_cc`` and ``t + y @
    t_cc`` for labels ``y``, integers (B,) or one-hot (B, num_classes),
    passed as ``y`` or ``context``."""

    def __init__(self, shape, num_classes, dtype=torch.float32):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        d = math.prod(shape)
        self.shape = shape
        self.num_classes = num_classes
        self.s = nn.Parameter(torch.zeros((1,) + shape, dtype=dtype))
        self.t = nn.Parameter(torch.zeros((1,) + shape, dtype=dtype))
        self.s_cc = nn.Parameter(torch.zeros(num_classes, d, dtype=dtype))
        self.t_cc = nn.Parameter(torch.zeros(num_classes, d, dtype=dtype))

    def _params(self, y):
        y = one_hot(y, self.num_classes, self.s.dtype)
        s = self.s + (y @ self.s_cc).reshape((-1,) + self.shape)
        t = self.t + (y @ self.t_cc).reshape((-1,) + self.shape)
        return s, t

    def _log_det(self, z, s, sign):
        n = math.prod(z.shape[i] for i in range(1, z.ndim)
                      if self.s.shape[i] == 1)
        return sign * n * sum_except_batch(s)

    def forward(self, z, context=None, y=None, generator=None):
        s, t = self._params(context if y is None else y)
        return z * torch.exp(s) + t, self._log_det(z, s, 1)

    def inverse(self, z, context=None, y=None, generator=None):
        s, t = self._params(context if y is None else y)
        return (z - t) * torch.exp(-s), self._log_det(z, s, -1)


class AffineCoupling(Flow):
    """Affine coupling on a split pair ``[z1, z2]`` (``affine.py:141-208``;
    reference ``coupling.py:99-171``): ``param_map(z1)`` gives the shift
    and scale logits interleaved on the channel axis (shift at even
    channels); ``scale_map`` is ``"exp"`` (RealNVP), ``"sigmoid"`` (Glow:
    the forward divides by ``sigmoid(s + 2)``) or ``"sigmoid_inv"``."""

    def __init__(self, param_map, scale=True, scale_map="exp"):
        super().__init__()
        if scale_map not in ("exp", "sigmoid", "sigmoid_inv"):
            raise NotImplementedError("This scale map is not implemented.")
        self.param_map = param_map
        self.scale = scale
        self.scale_map = scale_map

    def _coupling(self, z, inverse):
        z1, z2 = z
        param = self.param_map(z1)
        if not self.scale:
            z2 = z2 - param if inverse else z2 + param
            return [z1, z2], zero_log_det_like_z(z2)
        shift, s = param[:, 0::2], param[:, 1::2]
        if self.scale_map == "exp":
            if inverse:
                return ([z1, (z2 - shift) * torch.exp(-s)],
                        -sum_except_batch(s))
            return [z1, z2 * torch.exp(s) + shift], sum_except_batch(s)
        sig = torch.sigmoid(s + 2)
        log_sig = sum_except_batch(torch.log(sig))
        # "sigmoid" divides in the forward, "sigmoid_inv" multiplies
        divide = (self.scale_map == "sigmoid") != inverse
        if inverse:
            z2 = (z2 - shift) / sig if divide else (z2 - shift) * sig
        else:
            z2 = z2 / sig + shift if divide else z2 * sig + shift
        return [z1, z2], -log_sig if divide else log_sig

    def forward(self, z, context=None, generator=None):
        return self._coupling(z, inverse=False)

    def inverse(self, z, context=None, generator=None):
        return self._coupling(z, inverse=True)


class AffineCouplingBlock(Flow):
    """Split, affine coupling, merge (``affine.py:252-281``; reference
    ``coupling.py:232-267``): ``flows`` is ``[Split, AffineCoupling,
    Merge]``, the reference's list, so the coupling's weights sit under
    ``flows.1.``."""

    def __init__(self, param_map, scale=True, scale_map="exp",
                 split_mode="channel"):
        super().__init__()
        self.flows = nn.ModuleList([
            Split(split_mode), AffineCoupling(param_map, scale, scale_map),
            Merge(split_mode)])

    def forward(self, z, context=None, generator=None):
        log_det_tot = zero_log_det_like_z(z)
        for flow in self.flows:
            z, log_det = flow.forward(z, context=context, generator=generator)
            log_det_tot = log_det_tot + log_det
        return z, log_det_tot

    def inverse(self, z, context=None, generator=None):
        log_det_tot = zero_log_det_like_z(z)
        for flow in reversed(self.flows):
            z, log_det = flow.inverse(z, context=context, generator=generator)
            log_det_tot = log_det_tot + log_det
        return z, log_det_tot
