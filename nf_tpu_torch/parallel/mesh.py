"""Meshes over the process group's ranks and the layouts that place a
batch on them (``nf_tpu/parallel/mesh.py``).

A flow's parameters are small and replicate; the work scales in the
batch and sample dimension. So the canonical mesh is 1-D over the
``data`` axis: every rank holds the whole model on its one device and
one slice of each batch, and the loss and the gradients are averaged
over the ranks by ``torch.distributed`` collectives. Where JAX places a
global array across its devices, here each process keeps its own rows
and the global array stays implicit. On a mesh of more axes (``("data",
"model")``, ``parallel.tp``) a collective over one axis runs in the
subgroup of ranks along it (:meth:`Mesh.group`).

Each rank drives one device: ``cuda:{LOCAL_RANK}`` under NCCL (see
:func:`~nf_tpu_torch.parallel.multihost.initialize_distributed`), the
CPU under gloo. Without a process group a mesh has one rank, the local
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

# rank r's stream: the caller's seed plus r times the 64-bit golden ratio
# (rank 0 draws the caller's own stream)
_GOLDEN = 0x9E3779B97F4A7C15


def world():
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _own_device():
    """This rank's device: NCCL drives the current CUDA device, gloo the
    CPU; without a process group, CUDA (raising if it is absent)."""
    if not (dist.is_available() and dist.is_initialized()):
        return resolve_device(None)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over the ranks of the process group.

    ``ranks`` holds every rank at its mesh position (shape ``tuple(
    shape.values())``); ``device`` is this process's device, and
    ``rank`` its rank. A collective over an axis runs in this rank's line
    of ranks along it (:meth:`group`)."""

    axis_names: tuple
    ranks: np.ndarray
    device: torch.device
    rank: int
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self):
        """``{axis name: size}``, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self):
        return int(self.ranks.size)

    def axis_index(self, axis):
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def collective_over(self, axis):
        """Whether a reduction over ``axis`` runs a collective: it does
        under a process group (at world size 1 too), over
        :meth:`group`."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        return dist.is_available() and dist.is_initialized()

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (the ranks
        that share its other coordinates), for ``torch.distributed``'s
        ``group=``: None, the default group, where the axis spans every
        rank. The first call per axis creates one group per line with
        ``dist.new_group``, every line in a fixed order, which every rank
        must do at the same point (the step factories do it when they are
        built)."""
        if not self.collective_over(axis):
            return None
        if all(n == 1 for a, n in self.shape.items() if a != axis):
            return None
        if axis not in self._groups:
            lines = np.moveaxis(self.ranks, self.axis_names.index(axis),
                                -1).reshape(-1, self.shape[axis])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[axis] = group
        return self._groups[axis]


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over the process group's ranks (one device each).

    ``shape`` defaults to a 1-D mesh over every rank and must multiply
    to the world size. ``devices``, one per rank in rank order, defaults
    to each rank's own (:func:`world`; NCCL: the current CUDA device,
    gloo: the CPU); without a process group the mesh is one rank, the
    local device (None: CUDA, raising if it is absent)."""
    rank, n = world()
    if devices is None:
        device = _own_device()
    else:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a world of {n} "
                             f"ranks (one device per rank)")
        device = devices[rank]
        if device.type == "cuda":
            resolve_device(device)
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {axis_names}")
    ranks = np.arange(n).reshape(tuple(shape))
    return Mesh(axis_names, ranks, device, rank)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on ``mesh``: ``spec[d]`` names the mesh axis that splits
    dim ``d`` of a tensor (None: replicated), as JAX's ``PartitionSpec``.
    :meth:`local` takes this rank's part. A spec shorter than a tensor's
    rank leaves its trailing dims whole, so ``data_sharding(mesh, 1)``
    splits the leading dim of every tensor of a batch."""

    mesh: Mesh
    spec: tuple = ()

    def block(self, x):
        """This rank's block of the global tensor ``x``, a view where
        ``x`` lies."""
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            if d >= x.ndim:
                raise ValueError(f"spec {self.spec} splits dim {d} of a "
                                 f"{x.ndim}-dim tensor")
            parts = self.mesh.shape[axis]
            if x.shape[d] % parts:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not "
                                 f"divide over the {parts} ranks of axis "
                                 f"{axis!r}")
            n = x.shape[d] // parts
            x = x.narrow(d, self.mesh.axis_index(axis) * n, n)
        return x

    def local(self, x):
        """This rank's block of the global ``x`` (a tensor or an array),
        on the mesh's device."""
        return self.block(torch.as_tensor(x)).to(self.mesh.device)


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data",
                  dim: int = 0) -> NamedSharding:
    """Split dim ``dim`` (the batch or sample dim; ``dim=1`` is the
    microbatched layout ``(accum_steps, micro, ...)``) over ``axis`` and
    replicate the rest; a 0-dim tensor replicates."""
    if ndim == 0:
        return NamedSharding(mesh, ())
    spec = [None] * ndim
    spec[dim] = axis
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


class RankStreams:
    """Rank-distinct random streams derived from a caller's generator, in
    a fixed way (JAX folds the key with the axis index).

    On CUDA, rank r draws from a generator of its own seeded with the
    caller's seed plus ``r * 0x9E3779B97F4A7C15`` (mod 2^64) at the
    caller's Philox offset, and the caller's offset then advances by what
    was drawn; reading and setting seeds and offsets touches only the
    host, so a CUDA graph registered with the rank's generator replays
    them. On the CPU (no offsets), each call draws one 63-bit seed from
    the caller's generator and rank r seeds its own from it the same
    way. Rank 0's CUDA stream is the caller's own. A fixed world size
    gives the same draws, and no two ranks share a seed."""

    def __init__(self, rank):
        self.rank = int(rank)
        self.by_device = {}

    def own(self, device):
        """This rank's generator on ``device``."""
        device = torch.device(device)
        if device not in self.by_device:
            self.by_device[device] = torch.Generator(device=device)
        return self.by_device[device]

    def enter(self, generator):
        """Set this rank's generator from ``generator``'s state and
        return it."""
        own = self.own(generator.device)
        if generator.device.type == "cuda":
            own.manual_seed((generator.initial_seed()
                             + self.rank * _GOLDEN) % 2 ** 64)
            own.set_offset(generator.get_offset())
        else:
            seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))
            own.manual_seed((seed + self.rank * _GOLDEN) % 2 ** 64)
        return own

    def leave(self, generator):
        """Advance ``generator`` past what this rank's generator drew
        (CUDA; on the CPU :meth:`enter` drew already)."""
        if generator.device.type == "cuda":
            generator.set_offset(self.own(generator.device).get_offset())
