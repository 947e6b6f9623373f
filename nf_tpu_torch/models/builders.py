"""Model builders (``nf_tpu/models/builders.py``): :func:`build_nsf` and
:func:`build_circular_nsf`."""

from __future__ import annotations

import numpy as np
import torch

from .. import core
from .. import distributions as dist
from .. import flows as nff
from .._device import resolve_device


def build_nsf(dim=2, K=8, hidden=128, num_bins=8, num_blocks=2,
              tail_bound=3.0, permutation=True, target=None, device=None,
              seed=0, mixed_precision=False):
    """Coupled RQ-spline NSF with LULinearPermute mixing
    (``builders.py:76``; reference NSF recipes, e.g. ``comparison.ipynb``).

    Weights are drawn on the host from ``torch.Generator().manual_seed(seed)``
    and moved to ``device`` (None: CUDA, raising if it is absent). The
    splines start as the identity, as in the JAX package.
    ``mixed_precision=True`` runs the conditioners in bfloat16
    (:class:`~nf_tpu_torch.nets.MixedPrecision`); where a coupling takes
    the fused head (kernel B) its trunk stays float32, as in the JAX
    package."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for i in range(K):
        flows.append(nff.CoupledRationalQuadraticSpline(
            num_input_channels=dim, num_blocks=num_blocks,
            num_hidden_channels=hidden, num_bins=num_bins,
            tail_bound=tail_bound, reverse_mask=(i % 2 == 1),
            mixed_precision=mixed_precision, generator=gen))
        if permutation:
            flows.append(nff.LULinearPermute(dim, generator=gen))
    q0 = dist.DiagGaussian(dim, trainable=False)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def build_circular_nsf(dim=2, ind_circ=(0,), K=12, hidden=512, num_bins=10,
                       tail_bound=None, target=None, scale=None, device=None,
                       seed=0, mixed_precision=False):
    """Circular autoregressive NSF on a cylinder, the reference paper's
    example (``builders.py:95``; reference ``examples/paper_example_nsf.
    ipynb`` cell 8): K autoregressive RQ-spline layers (MADE with one
    residual block, ``hidden`` units, a permuted input order), then
    ``PeriodicWrap``, over a ``UniformGaussian`` base that is uniform on
    the circular coordinates.

    ``tail_bound`` defaults to pi on the circular features and 3 on the
    others, one bound per feature; ``scale`` to 2*pi on the circular
    features and 1 on the others. Weights and mask orders are drawn on the
    host from ``torch.Generator().manual_seed(seed)`` and moved to
    ``device`` (None: CUDA, raising if it is absent); the splines start as
    the identity. ``mixed_precision=True`` runs the MADEs in bfloat16
    (:class:`~nf_tpu_torch.nets.MixedPrecision`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ind_circ = list(ind_circ)
    if tail_bound is None:
        tail_bound = np.full(dim, 3.0, np.float32)
        tail_bound[ind_circ] = np.pi
    if scale is None:
        scale = np.ones(dim, np.float32)
        scale[ind_circ] = 2 * np.pi
    flows = [nff.CircularAutoregressiveRationalQuadraticSpline(
        num_input_channels=dim, num_blocks=1, num_hidden_channels=hidden,
        ind_circ=ind_circ, num_bins=num_bins, tail_bound=tail_bound,
        permute_mask=True, mixed_precision=mixed_precision, generator=gen)
        for _ in range(K)]
    flows.append(nff.PeriodicWrap(ind_circ, bound=np.pi))
    q0 = dist.UniformGaussian(dim, ind=ind_circ, scale=scale)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)
