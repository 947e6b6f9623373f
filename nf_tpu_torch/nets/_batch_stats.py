"""Batch statistics over the global batch of a sharded step.

The JAX package's SPMD step normalises ``BatchNorm`` and the batch-norm
conditioners (``nf_tpu/flows/normalization.py:75``, ``nets/resnet.py:26``)
by the mean and variance of the global batch: the arrays are global and
XLA inserts the reduction. In the port each rank holds its shard of the
batch, so a sharded step (``parallel/train.py``) opens
:func:`global_batch` around its forward pass, and inside it
:func:`moments` all-reduces each rank's sum, sum of squares and count
over the ``data`` subgroup with a differentiable all-reduce
(:class:`_AllReduce`: its backward sums the cotangents of every rank's
statistics, so each rank's gradient carries the other ranks' losses
through them, as the global batch's would).
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
    keeps its local statistics."""
    if not _GROUPS or _GROUPS[-1][1] == 1:
        return None
    count = math.prod(x.shape[d] for d in dims)
    s1 = torch.sum(x, dim=dims, keepdim=True)
    s2 = torch.sum(x * x, dim=dims, keepdim=True)
    stats = _AllReduce.apply(
        torch.stack([s1, s2, torch.full_like(s1, count)]), _GROUPS[-1][0])
    total, squares, n = stats[0], stats[1], stats[2]
    mean = total / n
    return mean, (squares - total * mean) / (n - correction)
