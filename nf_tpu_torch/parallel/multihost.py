"""Multi-process runs (``nf_tpu/parallel/multihost.py``): the process
group, meshes across hosts, and the per-process data path.

* :func:`initialize_distributed` joins the ``torch.distributed`` process
  group: NCCL on CUDA (each rank on ``cuda:{LOCAL_RANK}``), gloo on the
  CPU, so the same multi-process programs run as host-only tests.
* :func:`make_hybrid_mesh`: a mesh whose outer factor of each axis spans
  groups of ranks (hosts) and whose inner factor spans the ranks inside
  a group.
* :func:`per_process_batches` / :func:`host_local_to_global`: every
  process computes the same global batch schedule from a shared seed and
  keeps only its own rows, so N processes feeding 1/N of each batch train
  the model one process trains on all of it.

Without a process group everything here is the one-process case.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..data import _map
from .mesh import Mesh, make_mesh, world

_BACKENDS = {"cpu": "gloo", None: "nccl", "gpu": "nccl", "cuda": "nccl"}


def _env_int(name, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it as an argument or "
                         f"in the environment")
    return int(os.environ[name])


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           platform: Optional[str] = None,
                           **kwargs) -> tuple[int, int]:
    """Join the process group and return ``(rank, world size)``.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous
    (None: ``MASTER_ADDR`` and ``MASTER_PORT`` from the environment);
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``. ``platform="cpu"`` takes the gloo backend; otherwise NCCL,
    each rank on ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` defaults to the
    rank), raising if CUDA is absent. ``kwargs`` go to
    ``torch.distributed.init_process_group``.

    Idempotent: once the group is up, returns its coordinates."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if platform not in _BACKENDS:
        raise ValueError(f"unknown platform {platform!r}: 'cpu' (gloo) or "
                         f"None (NCCL on CUDA)")
    backend = _BACKENDS[platform]
    rank = _env_int("RANK", process_id)
    size = _env_int("WORLD_SIZE", num_processes)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(device)
        kwargs.setdefault("device_id", device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def make_hybrid_mesh(axis_names: Sequence[str], ici_shape: Sequence[int],
                     dcn_shape: Optional[Sequence[int]] = None,
                     devices=None) -> Mesh:
    """A mesh over groups of ranks: axis i spans ``ici_shape[i]`` ranks
    inside each group (the fast links: NVLink inside a host) times
    ``dcn_shape[i]`` groups (the slow ones between hosts). A group is
    ``prod(ici_shape)`` consecutive ranks, as launchers number a host's
    ranks. Keep the axes that talk often at ``dcn_shape[i] == 1``; the
    data-parallel axis usually carries the factor across hosts. With
    ``dcn_shape`` all ones (or None) it is an ordinary mesh.

    Example, 2 hosts of 8 ranks, data-parallel across hosts and
    sample-parallel inside each: ``make_hybrid_mesh(("data", "sample"),
    ici_shape=(1, 8), dcn_shape=(2, 1))``."""
    if dcn_shape is None:
        dcn_shape = (1,) * len(ici_shape)
    if len(axis_names) != len(ici_shape) or len(ici_shape) != len(dcn_shape):
        raise ValueError(
            f"axis_names/ici_shape/dcn_shape lengths differ: "
            f"{len(axis_names)}/{len(ici_shape)}/{len(dcn_shape)}")
    shape = tuple(i * d for i, d in zip(ici_shape, dcn_shape))
    mesh = make_mesh(axis_names, shape, devices)
    n = len(shape)
    # rank = group-major: (dcn coordinates, ici coordinates), then each
    # axis takes its dcn coordinate as the outer factor
    ranks = (np.arange(mesh.size).reshape(tuple(dcn_shape) + tuple(ici_shape))
             .transpose([k for i in range(n) for k in (i, n + i)])
             .reshape(shape))
    return Mesh(mesh.axis_names, ranks, mesh.device, mesh.rank)


def process_slice(global_batch: int,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> slice:
    """This process's contiguous slice of a global batch dimension."""
    pi, pc = world()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(
            f"global batch {global_batch} must divide over {pc} processes")
    local = global_batch // pc
    return slice(pi * local, (pi + 1) * local)


def host_local_to_global(mesh: Mesh, local_batch, axis: str = "data",
                         dim: int = 0):
    """This process's rows of a global batch (a tensor or array, or a
    tuple of them) as tensors on its device. In PyTorch the global array,
    whose dim ``dim`` the processes' rows make up along ``axis``, stays
    implicit: each rank's step takes its own rows, so ``axis`` and
    ``dim`` only name the layout."""
    del axis, dim
    return _map(lambda x: torch.as_tensor(x).to(mesh.device), local_batch)


def per_process_batches(arrays, global_batch: int, mesh: Mesh,
                        num_iters: Optional[int] = None, seed: int = 0,
                        axis: str = "data") -> Iterator:
    """Batches whose semantics do not depend on the process count: every
    process draws the same global index schedule from ``seed`` (numpy's
    ``default_rng``, on the host), gathers only its ``process_slice`` of
    each batch from ``arrays`` (a tuple of equal-length arrays, the same
    on every process) and yields them on its device."""
    if not isinstance(arrays, (tuple, list)):
        arrays = (arrays,)
    n = len(arrays[0])
    rng = np.random.default_rng(seed)
    sl = process_slice(global_batch)
    it = 0
    while num_iters is None or it < num_iters:
        idx = rng.integers(0, n, size=global_batch)[sl]
        batch = tuple(a[idx] for a in arrays)
        yield host_local_to_global(
            mesh, batch if len(batch) > 1 else batch[0], axis=axis)
        it += 1
