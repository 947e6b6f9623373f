"""Training helpers for residual flows (``nf_tpu/utils/optim.py:17,48,75``;
reference ``normflows/utils/optim.py``).

The JAX package rebuilds the model functionally; the port's modules hold
their state, so :func:`update_lipschitz` advances every induced-norm
layer's power iteration in place (its ``u`` and ``v`` written with
``copy_``, at their addresses) and :func:`map_modules` replaces matching
submodules in their parents. Both walk ``nn.Module.modules()``, which
reaches the layers of a ``Scanned`` stack (its ``units``) like any other
submodule.
"""

from __future__ import annotations

from torch import nn

from ..nets.lipschitz import InducedNormConv2d, InducedNormLinear

_INDUCED = (InducedNormLinear, InducedNormConv2d)


def update_lipschitz(model, n_iterations=5):
    """Advance the power iteration of every induced-norm layer of
    ``model`` by ``n_iterations`` steps (reference ``optim.py:28-31``), in
    place; returns ``model``. A training step's ``post_update``: it runs
    after the optimizer's update, inside a captured step too."""
    for module in model.modules():
        if isinstance(module, _INDUCED):
            module.update_power_iteration(n_iterations)
    return model


def lipschitz_scales(model):
    """The current sigma estimate of every induced-norm layer, in module
    order (a diagnostic; device scalars)."""
    return [m.scale for m in model.modules() if isinstance(m, _INDUCED)]


def map_modules(model, match, fn):
    """Replace every submodule of type ``match`` (not descending into
    one) by ``fn(submodule)``, in place, and return ``model`` (or
    ``fn(model)`` when ``model`` itself matches): the port's form of the
    JAX package's functional walk. ``fn`` may return its argument
    changed in place."""
    if isinstance(model, match):
        return fn(model)
    for name, child in list(model.named_children()):
        new = map_modules(child, match, fn)
        if new is not child:
            if not isinstance(new, nn.Module):
                raise TypeError(f"map_modules: fn returned "
                                f"{type(new).__name__} for {name!r}")
            setattr(model, name, new)
    return model
