"""Model builders (``nf_tpu/models/builders.py``); this slice ports
:func:`build_nsf`."""

from __future__ import annotations

import torch

from .. import core
from .. import distributions as dist
from .. import flows as nff
from .._device import resolve_device


def build_nsf(dim=2, K=8, hidden=128, num_bins=8, num_blocks=2,
              tail_bound=3.0, permutation=True, target=None, device=None,
              seed=0):
    """Coupled RQ-spline NSF with LULinearPermute mixing
    (``builders.py:76``; reference NSF recipes, e.g. ``comparison.ipynb``).

    Weights are drawn on the host from ``torch.Generator().manual_seed(seed)``
    and moved to ``device`` (None: CUDA, raising if it is absent). The
    splines start as the identity, as in the JAX package."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for i in range(K):
        flows.append(nff.CoupledRationalQuadraticSpline(
            num_input_channels=dim, num_blocks=num_blocks,
            num_hidden_channels=hidden, num_bins=num_bins,
            tail_bound=tail_bound, reverse_mask=(i % 2 == 1),
            generator=gen))
        if permutation:
            flows.append(nff.LULinearPermute(dim, generator=gen))
    q0 = dist.DiagGaussian(dim, trainable=False)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)
