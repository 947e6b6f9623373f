"""ActNorm and BatchNorm (``nf_tpu/flows/normalization.py:22-87``;
reference ``normflows/flows/normalization.py:7-62``).

The reference sets an ActNorm's parameters from the first batch inside
``forward``. The JAX package makes that an explicit pass before the
compiled step, and so does the port: ``NormalizingFlow.init_from_data`` /
``init_from_samples`` call :meth:`ActNorm.init_data_inverse` /
:meth:`ActNorm.init_data_forward`, which set ``s`` and ``t`` in place
(``copy_``, so a captured step or a rebound served function reads the new
values at the same addresses). ``forward`` and ``inverse`` never read the
``data_dep_init_done`` flag: a served graph or a captured step never waits
for the host.
"""

from __future__ import annotations

import torch

from ..nets import _batch_stats
from .affine import AffineConstFlow
from .base import Flow


class ActNorm(AffineConstFlow):
    """Affine-const flow with data-dependent initialisation. The buffer
    ``data_dep_init_done`` (the reference's name; 1 once set, and as the
    JAX exporter writes it) is read only by the initialisation pass, which
    skips a layer that is already set, as the JAX importer's
    ``initialized`` flag does."""

    def __init__(self, shape, dtype=torch.float32):
        super().__init__(shape, dtype=dtype)
        self.register_buffer("data_dep_init_done",
                             torch.tensor(0.0, dtype=dtype))

    def _stat_dims(self, z):
        # every axis the parameters broadcast over, the batch axis included
        return tuple(i for i in range(z.ndim) if self.s.shape[i] == 1)

    def _init(self, z, inverse):
        if bool(self.data_dep_init_done > 0):
            return
        dims = self._stat_dims(z)
        with torch.no_grad():
            std = torch.std(z, dim=dims, keepdim=True, correction=1)
            mean = torch.mean(z, dim=dims, keepdim=True)
            if inverse:
                # the inverse's output becomes unit Gaussian
                self.s.copy_(torch.log(std + 1e-6))
                self.t.copy_(mean)
            else:
                # the forward's output becomes unit Gaussian
                s = -torch.log(std + 1e-6)
                self.s.copy_(s)
                self.t.copy_(-mean * torch.exp(s))
            self.data_dep_init_done.fill_(1.0)

    def init_data_forward(self, z, context=None, generator=None):
        self._init(z, inverse=False)
        return self.forward(z, context=context, generator=generator)

    def init_data_inverse(self, z, context=None, generator=None):
        self._init(z, inverse=True)
        return self.inverse(z, context=context, generator=generator)


class BatchNorm(Flow):
    """Batch normalisation as a flow layer (``normalization.py:75-87``;
    reference ``normalization.py:42-62``): ``(z - mean) / sqrt(std² +
    eps)`` over the batch, the standard deviation with one degree of
    freedom removed, eps 1e-10, and the log-det ``-sum(log(std² +
    eps)) / 2`` for every sample, the statistics' dependence on the
    parameters ignored. It has only this direction, as in the JAX
    package; ``inverse`` raises. Inside a sharded step the statistics are
    the global batch's (``nets/_batch_stats.py``)."""

    def __init__(self, eps=1e-10):
        super().__init__()
        self.eps = eps

    def forward(self, z, context=None, generator=None):
        shared = _batch_stats.moments(z, (0,), 1)
        if shared is None:
            mean = torch.mean(z, dim=0, keepdim=True)
            std = torch.std(z, dim=0, keepdim=True, correction=1)
            var_eps = std ** 2 + self.eps
        else:  # the global batch of a sharded step (nets/_batch_stats.py)
            mean, var = shared
            var_eps = var + self.eps
        log_det = -0.5 * torch.sum(torch.log(var_eps))
        return ((z - mean) / torch.sqrt(var_eps),
                torch.broadcast_to(log_det, (z.shape[0],)))
