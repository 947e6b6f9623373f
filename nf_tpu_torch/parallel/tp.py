"""Tensor-parallel and FSDP-style parameter layouts over a mesh axis
(``nf_tpu/parallel/tp.py``).

Flows have no attention; what a layout splits is the conditioners' dense
layers. :func:`param_shardings` gives each parameter a
:class:`~nf_tpu_torch.parallel.mesh.NamedSharding` by JAX's rule: the
first dimension that the axis size divides, with at least ``min_size``
per block, is split over the axis, and everything else replicates. With
``axis="data"`` the same rule gives FSDP-style (ZeRO-3) sharding.

Where JAX's SPMD partitioner inserts the collectives a layout implies,
``make_forward_kld_step(..., state_shardings=)`` runs them itself: each
rank holds its block of every split parameter and of its optimizer
state, the step gathers the whole parameters over the axis, and the
kernels always see whole, contiguous tensors. The result never depends
on the layout (``parallel/train.py``'s notes).
"""

from __future__ import annotations

from .mesh import Mesh, NamedSharding


def _named_tensors(model_or_state):
    """``{name: parameter}`` of a model or a ``TrainState``'s model."""
    model = getattr(model_or_state, "model", model_or_state)
    return dict(model.named_parameters())


def param_shardings(model_or_state, mesh: Mesh, axis: str = "model",
                    min_size: int = 2):
    """``{parameter name: NamedSharding}`` (``tp.py:23``): each parameter
    split on its first dimension that the size of ``axis`` divides with
    at least ``min_size`` per block (dim 0 first, the output dimension of
    a weight), else replicated; everything replicates at axis size 1."""
    size = mesh.shape[axis]

    def spec(t):
        if t.ndim == 0 or size == 1:
            return ()
        for d in range(t.ndim):
            if t.shape[d] % size == 0 and t.shape[d] // size >= min_size:
                return (None,) * d + (axis,)
        return ()

    return {name: NamedSharding(mesh, spec(t))
            for name, t in _named_tensors(model_or_state).items()}


def shard_params(model_or_state, mesh: Mesh, axis: str = "model",
                 min_size: int = 2):
    """``{parameter name: this rank's block}`` by :func:`param_shardings`
    (``tp.py:52``), each a view of the parameter where it lies."""
    tensors = _named_tensors(model_or_state)
    return {name: sh.block(tensors[name].detach())
            for name, sh in param_shardings(model_or_state, mesh, axis,
                                            min_size).items()}
