"""Flow layer contract and structural combinators
(``nf_tpu/flows/base.py``; reference ``normflows/flows/base.py:5-81``).

Every layer is an ``nn.Module`` whose ``forward(z, context=None,
generator=None)`` and ``inverse(z, context=None, generator=None)`` return
``(z', log_det)`` with a per-sample ``log_det`` of shape ``(B,)``.
``forward`` maps latent -> data. ``generator`` is the random source of a
layer that draws (a residual block's stochastic log-det): the JAX package
passes every layer a ``key`` (``nf_tpu/core.py:24-27``), split once per
layer. A ``torch.Generator`` is stateful, so the port passes one generator
down the whole chain and each drawing layer advances it in turn; there is
no per-layer split. Layers that draw nothing take it and ignore it, and
the containers (``Composite``, ``Scanned``, ``Reverse``, the models of
``core``) hand it on. ``init_data_forward`` and
``init_data_inverse`` are the data-dependent initialisation pass
(``nf_tpu/flows/base.py:46-53``): a layer with such state (``ActNorm``)
sets it in place from the batch it is given, then transforms it; every
other layer only transforms it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def zero_log_det_like_z(z):
    """Per-sample zero log-det (reference ``flows/base.py:81``)."""
    return torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


class Flow(nn.Module):
    """Abstract invertible layer."""

    def forward(self, z, context=None, generator=None):
        raise NotImplementedError("Forward pass has not been implemented.")

    def inverse(self, z, context=None, generator=None):
        raise NotImplementedError("This flow has no algebraic inverse.")

    def init_data_forward(self, z, context=None, generator=None):
        return self.forward(z, context=context, generator=generator)

    def init_data_inverse(self, z, context=None, generator=None):
        return self.inverse(z, context=context, generator=generator)


class Reverse(Flow):
    """Swap a layer's forward and inverse (reference ``flows/base.py:27``)."""

    def __init__(self, flow):
        super().__init__()
        self.flow = flow

    def forward(self, z, context=None, generator=None):
        return self.flow.inverse(z, context=context, generator=generator)

    def inverse(self, z, context=None, generator=None):
        return self.flow.forward(z, context=context, generator=generator)

    def init_data_forward(self, z, context=None, generator=None):
        return self.flow.init_data_inverse(z, context=context,
                                           generator=generator)

    def init_data_inverse(self, z, context=None, generator=None):
        return self.flow.init_data_forward(z, context=context,
                                           generator=generator)


class Composite(Flow):
    """Sequential composition of flows (reference ``flows/base.py:48``)."""

    def __init__(self, flows):
        super().__init__()
        self.flows = nn.ModuleList(flows)

    def forward(self, z, context=None, generator=None):
        return _run(self.flows, "forward", z, context, generator)

    def inverse(self, z, context=None, generator=None):
        return _run(list(reversed(self.flows)), "inverse", z, context,
                    generator)

    def init_data_forward(self, z, context=None, generator=None):
        return _run(self.flows, "init_data_forward", z, context, generator)

    def init_data_inverse(self, z, context=None, generator=None):
        return _run(list(reversed(self.flows)), "init_data_inverse", z,
                    context, generator)


def _run(flows, method, z, context, generator=None):
    """``method`` of each flow in turn, the log-dets summed from zero."""
    log_det_tot = zero_log_det_like_z(z)
    for flow in flows:
        z, log_det = getattr(flow, method)(z, context=context,
                                           generator=generator)
        log_det_tot = log_det_tot + log_det
    return z, log_det_tot


def _signature(module):
    return ([type(m) for m in module.modules()],
            [(n, tuple(t.shape), t.dtype) for n, t in
             module.state_dict().items()])


class Scanned(Flow):
    """K structurally identical units run one after the other
    (``nf_tpu/flows/base.py:129-218``). The JAX package stacks their
    parameters and runs one traced body under ``lax.scan`` to save
    compile time; PyTorch compiles nothing, so here the units stay
    separate modules (``units``) and run in a Python loop. The JAX
    exporter flattens a ``Scanned`` into per-layer names, and
    ``compat.load_reference_state_dict`` maps those onto ``units``.

    :meth:`layers` is the units' layers in order, a plain ``Composite``
    unit opened into its flows: the loop, the data-dependent pass and
    the model containers (:func:`open_scanned`) all run those layers
    with one running log-det sum, so a ``scan=True`` model computes
    exactly what the unrolled model does and agrees with it bitwise.

    ``remat=True`` (the JAX package's ``jax.checkpoint`` of the scan
    body) runs each unit under ``torch.utils.checkpoint`` when autograd
    records: its activations are recomputed in the backward instead of
    kept, memory traded for a second forward. The containers then run the
    ``Scanned`` itself, unit by unit, each unit's log-det summed from
    zero and added to the running sum (the same numbers to rounding); the
    data-dependent pass runs the layers, as without ``remat``."""

    def __init__(self, flows, remat=False):
        super().__init__()
        flows = list(flows)
        if len({repr(_signature(f)) for f in flows}) != 1:
            raise ValueError("Scanned requires structurally identical flows.")
        self.units = nn.ModuleList(flows)
        self.remat = remat

    def layers(self):
        """Every layer of every unit in order (plain ``Composite`` units,
        and plain ``Composite``s inside them, opened)."""
        out = []
        for unit in self.units:
            out += open_composites(unit)
        return out

    def _remat(self, method, z, context, generator):
        units = list(self.units)
        if method == "inverse":
            units.reverse()
        log_det_tot = zero_log_det_like_z(z)
        for unit in units:
            z, log_det = checkpoint(getattr(unit, method), z, context,
                                    generator, use_reentrant=False,
                                    preserve_rng_state=False)
            log_det_tot = log_det_tot + log_det
        return z, log_det_tot

    def forward(self, z, context=None, generator=None):
        if self.remat and torch.is_grad_enabled():
            return self._remat("forward", z, context, generator)
        return _run(self.layers(), "forward", z, context, generator)

    def inverse(self, z, context=None, generator=None):
        if self.remat and torch.is_grad_enabled():
            return self._remat("inverse", z, context, generator)
        return _run(self.layers()[::-1], "inverse", z, context, generator)

    def init_data_forward(self, z, context=None, generator=None):
        return _run(self.layers(), "init_data_forward", z, context,
                    generator)

    def init_data_inverse(self, z, context=None, generator=None):
        return _run(self.layers()[::-1], "init_data_inverse", z, context,
                    generator)


def open_scanned(flows):
    """``flows`` with every ``Scanned`` opened into its layers, but one
    with ``remat=True``, which runs itself (its units checkpointed)."""
    out = []
    for flow in flows:
        opened = isinstance(flow, Scanned) and not flow.remat
        out += flow.layers() if opened else [flow]
    return out


def open_composites(layer):
    """``[layer]``, or a plain ``Composite``'s flows, opened in turn."""
    if type(layer) is Composite:
        return [f for sub in layer.flows for f in open_composites(sub)]
    return [layer]
