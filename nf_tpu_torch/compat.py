"""Weight bridge: load a reference (normflows) state dict into the port.

The port's modules carry the reference's names, so a reference state dict
(``{dotted name: array}``, as ``nf_tpu.compat_export.export_state_dict``
emits it, or as a reference model's ``state_dict()`` holds it) maps onto
``model.state_dict()`` key for key. One layout differs: a ResidualNet or
a MADE with a bin-major head orders its final layer's rows param-major
(row ``p*D + d``), the reference feature-major (row ``d*mult + p``); those
rows (weight, bias and, for a MADE, the ``mask`` and ``degrees`` buffers)
are permuted on load. Every MADE mask comes from the state dict: a
``permute_mask`` order drawn by the JAX package cannot be redrawn here.
A conditioner wrapped in ``MixedPrecision`` holds its net under ``net.``,
a level the reference names do not have; those keys are mapped across.
The layers of a ``Scanned`` (and of a plain ``Composite``) in the
container's chain carry flat indices in the reference's names, as the
JAX exporter writes them (``nf_tpu/compat_export.py:278-299``): unit j's
layer m of a ``scan=True`` RealNVP loads from ``flows.{4j + m}.``, and a
``scan=True`` Glow's block j of level i from ``flows.{i}.{j}.``. The
image models' other names are the reference's as they stand: a
multiscale model's ``q0.{i}.``, ``flows.{i}.{j}.`` and ``merges.{i}.``,
the LU 1x1 convolution's ``L``, ``U``, ``log_S``, ``P``, ``sign_S`` and
``eye``, a ``GlowBlock``'s ``flows.0.flows.1.param_map.net.{0,2,4}.``
(its coupling block's coupling, whose ``ConvNet2d`` keeps the
reference's ``nn.Sequential`` indices), then ``flows.1.`` (the 1x1
convolution) and ``flows.2.`` (the ActNorm).

Residual flows load under the reference's names too: a ``Residual``'s
``iresblock.geom_p`` (the logit of the geometric law's p) and
``iresblock.lamb``, its net's ``iresblock.nnet.net.{i}.`` (Swish ``beta``
at even i; the induced-norm layers' ``weight``, ``bias`` and the power
iteration's buffers ``u`` and ``v`` at odd i), a ``Planar``'s ``u``,
``w``, ``b``, a ``Radial``'s ``z_0``, ``beta``, ``alpha`` and ``d``, and a
circular coupling's conditioner ``preprocessing.`` (the periodic
features' ``weights`` and index buffers). The reference's bookkeeping
buffers that compute nothing (an iResBlock's ``last_n_samples``,
``last_firmom``, ``last_secmom``; an induced-norm layer's running
``scale``, and a convolution's ``initialized`` and ``spatial_dims``) are
taken when present and not loaded.

The layers and distributions of the last slice load by the same rule:
``InvertibleAffine`` as the 1x1 convolution (``L``, ``U``, ``log_S``,
``P``, ``sign_S``, ``eye``, or ``W``), ``GaussianMixture``'s ``loc``,
``log_scale``, ``weight_scores``, ``GaussianPCA``'s ``loc``, ``W``,
``log_sigma`` and ``AffineGaussian``'s ``transform.`` (the JAX exporter
writes all of these, ``nf_tpu/compat_export.py:351,381-384``). A batch-norm
``ResidualNet`` or ``ConvResidualNet`` takes ``blocks.i.batch_norm_layers.
j.weight`` and ``.bias``; the reference's ``nn.BatchNorm1d`` also keeps
running statistics, which batch-statistics normalisation never reads, so
they are bookkeeping too. (The JAX exporter raises on a batch-norm net,
``compat_export.py:114-115,147-148``.)

Stochastic flows, HAIS and the VAE load by the reference's names as well,
the names the JAX importer reads (``nf_tpu/compat.py:444-465,692-695``):
an HMC layer's ``log_step_size`` and ``log_mass``, a Metropolis-Hastings
layer's ``proposal.scale``, an encoder's or decoder's ``net.`` (the MLP's
``net.net.{i}.``), ``ConstDiagGaussian``'s ``loc`` and ``scale``, and a
``NormalizingFlowVAE``'s ``prior.``, ``q0.``, ``flows.{i}.`` and
``decoder.``. An MCMC layer holds its target without registering it (the
target, or the model base a bridge reads, belongs to its owner, which
loads it under its own name), so a reference state dict's entries under
the layer's ``target.`` (a reference ``Target``'s proposal buffers, or a
base held a second time) are taken and not loaded. The JAX exporter has
no entry for these modules (``compat_export.py:396``); the tests write
their names from the JAX modules' fields.
"""

from __future__ import annotations

import numpy as np
import torch

from .flows.base import Scanned, open_composites
from .flows.residual import iResBlock
from .flows.stochastic import HamiltonianMonteCarlo, MetropolisHastings
from .nets.lipschitz import InducedNormConv2d, InducedNormLinear
from .nets.made import MADE
from .nets.precision import MixedPrecision
from .nets.resnet import ResidualNet, _BatchAffineNorm


def _head_to_bin_major(arr, head):
    """Reference feature-major head rows -> the port's bin-major rows
    (the inverse of ``nf_tpu/compat_export.py:122-131``)."""
    d, mult = head
    return arr.reshape((d, mult) + arr.shape[1:]).swapaxes(0, 1) \
        .reshape(arr.shape)


def _flat_prefixes(model):
    """``{own prefix: reference prefix}`` of the container's layers: the
    layers of a ``Scanned`` or a plain ``Composite`` at flat indices,
    ``flows.{j}.`` in a flat container and ``flows.{i}.{j}.`` in level i
    of a ``MultiscaleFlow`` (``nf_tpu/compat_export.py:306-315``)."""
    flows = getattr(model, "flows", None)
    if not isinstance(flows, torch.nn.ModuleList):
        return {}
    levels = ([(f"flows.{i}.", level) for i, level in enumerate(flows)]
              if len(flows) and all(isinstance(f, torch.nn.ModuleList)
                                    for f in flows)
              else [("flows.", flows)])
    path = {id(m): name for name, m in model.named_modules()}
    out = {}
    for base, level in levels:
        count = 0
        for flow in level:
            layers = flow.layers() if isinstance(flow, Scanned) \
                else open_composites(flow)
            for layer in layers:
                out[path[id(layer)] + "."] = f"{base}{count}."
                count += 1
    return out


def _reference_names(model, own):
    """``{own key: reference key}``: a :class:`MixedPrecision` wrapper's
    ``net.`` level is not in the reference's names, as the JAX exporter
    passes through the wrapper (``nf_tpu/compat_export.py:377``), and the
    container's layers take flat indices (:func:`_flat_prefixes`)."""
    wrapped = [f"{name}." if name else "" for name, mod in
               model.named_modules() if isinstance(mod, MixedPrecision)]
    flat = _flat_prefixes(model)
    names = {}
    for key in own:
        ref = key
        for prefix in sorted(wrapped, key=len, reverse=True):
            if ref.startswith(prefix + "net."):
                ref = prefix + ref[len(prefix) + 4:]
        prefix = next((p for p in flat if ref.startswith(p)), None)
        if prefix is not None:
            ref = flat[prefix] + ref[len(prefix):]
        names[key] = ref
    return names


# the reference's bookkeeping buffers, which compute nothing
_BOOKKEEPING = (
    (iResBlock, ("last_n_samples", "last_firmom", "last_secmom")),
    ((InducedNormLinear, InducedNormConv2d),
     ("scale", "initialized", "spatial_dims")),
    (_BatchAffineNorm, ("running_mean", "running_var",
                        "num_batches_tracked")),
)


def _bookkeeping_names(model):
    """The reference names of the bookkeeping buffers ``model``'s modules
    would carry in a reference state dict."""
    own = [f"{name}.{suffix}" if name else suffix
           for name, mod in model.named_modules()
           for types, suffixes in _BOOKKEEPING if isinstance(mod, types)
           for suffix in suffixes]
    return set(_reference_names(model, own).values())


def _held_prefixes(model):
    """The reference prefixes of the MCMC layers' unregistered targets."""
    own = [f"{name}.target." if name else "target."
           for name, mod in model.named_modules()
           if isinstance(mod, (HamiltonianMonteCarlo, MetropolisHastings))]
    return tuple(_reference_names(model, own).values())


def load_reference_state_dict(model, state_dict, strict=True):
    """Copy ``state_dict`` into ``model`` in place and return ``model``.
    Raises ``KeyError`` on missing keys, and on unused ones unless
    ``strict`` is False, and ``ValueError`` on a shape mismatch."""
    own = model.state_dict()
    names = _reference_names(model, own)
    missing = sorted(set(names.values()) - set(state_dict))
    held = _held_prefixes(model)
    unused = sorted(k for k in set(state_dict) - set(names.values())
                    - _bookkeeping_names(model)
                    if not (held and k.startswith(held)))
    if missing or (strict and unused):
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:10]}, unused {unused[:10]}")
    heads = {(f"{name}." if name else "") + "final_layer.":
             mod.bin_major_head
             for name, mod in model.named_modules()
             if isinstance(mod, (ResidualNet, MADE))
             and mod.bin_major_head is not None}
    converted = {}
    for name, tensor in own.items():
        value = np.asarray(state_dict[names[name]])
        head = heads.get(name[:name.rfind(".") + 1])
        if head is not None:
            value = _head_to_bin_major(value, head)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{names[name]}: shape {value.shape} in the "
                             f"state dict, {tuple(tensor.shape)} in the "
                             f"model")
        converted[name] = torch.from_numpy(np.array(value))
    # through load_state_dict, so that a MADE layer's numpy copy of its
    # degrees follows the loaded buffer
    model.load_state_dict(converted)
    return model


def import_state_dict(model, state_dict, strict=True):
    """The JAX package's name for :func:`load_reference_state_dict`
    (``nf_tpu/compat.py:730``): load a reference ``state_dict`` into the
    architecturally matching ``model``. ``strict=True`` raises if a key
    goes unused (a structural mismatch), ``strict=False`` ignores such
    keys; a missing key always raises. The port loads in place and
    returns ``model``."""
    return load_reference_state_dict(model, state_dict, strict=strict)


def save_state_dict_npz(state_dict, path):
    """Write a state dict (tensors or arrays) to ``.npz``
    (``nf_tpu/compat.py:712``), which the JAX package's
    ``load_state_dict_npz`` reads as well."""
    arrays = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        arrays[k] = np.asarray(v)
    np.savez(path, **arrays)


def load_state_dict_npz(path):
    """The ``{name: array}`` mapping an ``.npz`` of
    :func:`save_state_dict_npz` (or of the JAX package's) holds
    (``nf_tpu/compat.py:723``), for :func:`import_state_dict`."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
