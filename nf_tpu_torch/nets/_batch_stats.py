"""Batch statistics over the global batch of a sharded step.

The JAX package's SPMD step normalises ``BatchNorm`` and the batch-norm
conditioners (``nf_tpu/flows/normalization.py:75``, ``nets/resnet.py:26``)
by the mean and variance of the global batch: the arrays are global and
XLA inserts the reduction (``jnp.var``, two passes over the data). In
the port each rank holds its shard of the batch, so a sharded step
(``parallel/train.py``) opens :func:`global_batch` around its forward
pass, and inside it :func:`moments` takes the same two passes across the
ranks of the ``data`` subgroup: it all-reduces each rank's sum and count
(float32) for the mean, then each rank's sum of squared deviations from
that mean for the variance. Both are differentiable all-reduces
(:class:`_AllReduce`: its backward sums the cotangents of every rank's
statistics, so each rank's gradient carries the other ranks' losses
through them, as the global batch's would). One pass (the sum of
squares less the square of the sum) would cancel catastrophically where
the mean is large against the spread: at mean 300 and standard deviation
0.01 it gives a variance of 0 or below in float32.
Outside it, and over a group of one rank, the layers compute their local
statistics exactly as before.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

_GROUPS: list = []


class _AllReduce(torch.autograd.Function):
    """The sum over the ranks of ``group``; its backward is the sum of the
    ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@contextlib.contextmanager
def global_batch(group, size):
    """Batch statistics inside this context span the ``size`` ranks of
    the process group ``group`` (None: the default group); a size of 1
    changes nothing."""
    _GROUPS.append((group, size))
    try:
        yield
    finally:
        _GROUPS.pop()


def moments(x, dims, correction):
    """``(mean, var)`` of ``x`` over ``dims`` (kept) across the global
    batch, the variance with ``correction`` degrees of freedom removed;
    None outside :func:`global_batch` (or over one rank), where the caller
    keeps its local statistics. Two passes, each summed in float32 (a
    bfloat16 ``x`` too: its count stays exact) and all-reduced; the
    results in ``x``'s dtype."""
    if not _GROUPS or _GROUPS[-1][1] == 1:
        return None
    group = _GROUPS[-1][0]
    xf = x.float()
    count = math.prod(x.shape[d] for d in dims)
    s1 = torch.sum(xf, dim=dims, keepdim=True)
    stats = _AllReduce.apply(torch.stack([s1, torch.full_like(s1, count)]),
                             group)
    n = stats[1]
    mean = stats[0] / n
    dev = xf - mean
    squares = _AllReduce.apply(torch.sum(dev * dev, dim=dims, keepdim=True),
                               group)
    return mean.to(x.dtype), (squares / (n - correction)).to(x.dtype)
