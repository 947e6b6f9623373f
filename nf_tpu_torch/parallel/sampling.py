"""Sharded sampling (``nf_tpu/parallel/sampling.py``): Monte-Carlo chains
spread over the ranks of a mesh.

SNF and HAIS chains are independent, so they shard as variational samples
do: each rank draws its chains from a stream of its own
(:class:`~nf_tpu_torch.parallel.mesh.RankStreams`), and the global sample
is the ranks' shards in rank order. The weights reduce with one
logsumexp across the ranks.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .mesh import Mesh, RankStreams


def make_sharded_sampler(mesh: Mesh, num_samples: int, axis: str = "data",
                         with_stats: bool = False):
    """Build ``sample(sampler, generator) -> (z, log_w)``: ``sampler`` is
    anything with ``.sample(n, generator) -> (z, log_w)`` (``HAIS``, a
    ``NormalizingFlow``, a base distribution), and each rank draws
    ``num_samples / ranks`` chains from its own stream derived from
    ``generator`` (reproducible for a fixed world size; without a process
    group, ``generator`` itself) and returns its shard of ``(z, log_w)``.

    ``with_stats=True``: the sampler must have ``.sample_with_stats(n,
    generator) -> (z, log_w, acceptance)`` (``HAIS``); ``sample`` returns
    ``(z, log_w, acceptance)``, the accept rates averaged over the ranks
    by an all-reduce (JAX's ``pmean``): each rank's rate is a mean over an
    equal share of the chains, so the average is the global rate."""
    n_dev = mesh.shape[axis]
    if num_samples % n_dev != 0:
        raise ValueError(f"num_samples {num_samples} must divide over "
                         f"{n_dev} devices")
    local = num_samples // n_dev
    collective = mesh.collective_over(axis)
    streams = RankStreams(mesh.axis_index(axis)) if collective else None
    group = mesh.group(axis) if collective else None

    def sample(sampler, generator):
        own = streams.enter(generator) if streams is not None else generator
        try:
            if not with_stats:
                return sampler.sample(local, own)
            z, log_w, acc = sampler.sample_with_stats(local, own)
        finally:
            if streams is not None:
                streams.leave(generator)
        if collective:
            acc = acc.clone()
            dist.all_reduce(acc, group=group)
            acc = acc / n_dev
        return z, log_w, acc

    return sample


def log_normalizer(log_weights, mesh: Mesh = None, axis: str = "data"):
    """The log Z estimate ``logsumexp(log_w) - log N`` from importance
    log-weights. With ``mesh``, ``log_weights`` is this rank's shard over
    ``axis`` and the logsumexp runs over every rank's: a max all-reduce,
    then a sum all-reduce of the shifted exponentials, with N the global
    count."""
    if mesh is None or not mesh.collective_over(axis):
        return torch.logsumexp(log_weights, dim=0) - math.log(
            log_weights.shape[0])
    group = mesh.group(axis)
    peak = torch.max(log_weights).detach().clone()
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    total = torch.sum(torch.exp(log_weights - peak)).reshape(1)
    count = torch.tensor([log_weights.shape[0]], dtype=total.dtype,
                         device=total.device)
    both = torch.cat([total, count])
    dist.all_reduce(both, group=group)
    return peak + torch.log(both[0]) - torch.log(both[1])
