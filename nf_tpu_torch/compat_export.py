"""Export a port model's weights in the reference (normflows) state-dict
format (``nf_tpu/compat_export.py``), the inverse of
:func:`nf_tpu_torch.compat.load_reference_state_dict`.

``export_state_dict(model)`` maps dotted reference names to numpy
arrays: what a reference model's ``load_state_dict`` takes after
tensor-wrapping, what the JAX package's ``nf_tpu.compat.import_state_dict``
reads, and what the JAX package's exporter emits for the same
architecture, key for key. The port's modules carry the reference's
names, so most entries are the model's own tensors. What differs is
undone on the way out: a bin-major head's rows go back to the
reference's feature-major order, a ``MixedPrecision`` wrapper's ``net.``
level goes, and the layers of a ``Scanned`` (and of a plain
``Composite``) take the container's flat indices.

Coverage is the JAX exporter's, family for family: the containers
(``MultiscaleFlow`` too), the RealNVP layers, the NSF stack, MAF, Glow,
planar and radial layers and the trainable bases; any other module that
holds tensors raises ``NotImplementedError``, as there (the residual
flows, the MCMC layers, the circular NSF's ``UniformGaussian`` base and
``PeriodicWrap``), and so do batch-norm nets and a ``ConvNet2d`` with
ActNorms. Like the JAX exporter it writes the reference's bookkeeping
buffers at their canonical values (``data_dep_init_done`` 1, ``eye`` the
identity, a MADE layer's ``degrees`` zeros: they compute nothing) and
skips a conditioner's ``preprocessing``. Tensors come to the host; a
bfloat16 one is written as float32 (numpy has no bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import core
from .distributions import base as dist_base
from .flows import (
    ActNorm,
    AffineConstFlow,
    AffineCoupling,
    AffineCouplingBlock,
    CCAffineConst,
    Composite,
    Invertible1x1Conv,
    InvertibleAffine,
    LULinear,
    LULinearPermute,
    MaskedAffineFlow,
    Merge,
    Permute,
    Planar,
    Radial,
    Reverse,
    Scanned,
    Split,
)
from .flows.autoregressive import Autoregressive
from .flows.base import open_composites
from .flows.mixing import _Permutation
from .flows.neural_spline.coupling import (
    Coupling,
    PiecewiseRationalQuadraticCDF,
)
from .flows.neural_spline.wrapper import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CircularCoupledRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
)
from .nets.cnn import Conv2d, ConvNet2d, _NetActNorm
from .nets.made import (
    MADE,
    MaskedFeedforwardBlock,
    MaskedLinear,
    MaskedResidualBlock,
)
from .nets.mlp import MLP, Linear
from .nets.precision import MixedPrecision
from .nets.resnet import (
    ConvResidualBlock,
    ConvResidualNet,
    ResidualBlock,
    ResidualNet,
)


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _own(mod, out, p):
    """``mod``'s own parameters and persistent buffers under ``p``."""
    for name, t in mod._parameters.items():
        if t is not None:
            out[p + name] = _np(t)
    for name, t in mod._buffers.items():
        if t is not None and name not in mod._non_persistent_buffers_set:
            out[p + name] = _np(t)


def _e_module(mod, out, p, skip=()):
    """``mod``'s own tensors, then each child through its exporter, under
    the child's attribute name (the reference's, in the port)."""
    _own(mod, out, p)
    for name, child in mod.named_children():
        if name not in skip:
            _export(child, out, f"{p}{name}.")


def _e_masked_linear(mod, out, p):
    _e_module(mod, out, p)
    # degrees are construction-time metadata in the reference (never read
    # in forward); the mask is the operative buffer
    out[p + "degrees"] = np.zeros(mod.weight.shape[0], np.float32)


def _head_to_feature_major(arr, head):
    """The port's bin-major head rows (row ``p*D + d``) back to the
    reference's feature-major ones (row ``d*mult + p``): the inverse of
    ``compat._head_to_bin_major``."""
    d, mult = head
    return arr.reshape((mult, d) + arr.shape[1:]).swapaxes(0, 1) \
        .reshape(arr.shape)


def _head_rows(mod, out, p, names):
    if mod.bin_major_head is not None:
        for name in names:
            key = f"{p}final_layer.{name}"
            if key in out:
                out[key] = _head_to_feature_major(out[key],
                                                  mod.bin_major_head)


def _e_residual_net(mod, out, p):
    # the JAX exporter writes no trunk preprocessing
    _e_module(mod, out, p, skip=("preprocessing",))
    _head_rows(mod, out, p, ("weight", "bias"))


def _e_no_batch_norm(mod, out, p):
    if mod.batch_norm_layers is not None:
        raise NotImplementedError(
            f"batch_norm {type(mod).__name__}s not supported at {p!r}")
    _e_module(mod, out, p)


def _e_convnet2d(mod, out, p):
    if any(isinstance(m, _NetActNorm) for m in mod.net):
        raise NotImplementedError(
            "exporting ConvNet2d with net-ActNorms is not supported")
    _e_module(mod, out, p)


def _e_made(mod, out, p):
    _e_module(mod, out, p, skip=("preprocessing",))
    _head_rows(mod, out, p, ("weight", "bias", "mask"))


def _e_actnorm(mod, out, p):
    _e_module(mod, out, p)
    out[p + "data_dep_init_done"] = np.asarray(1.0, np.float32)


def _e_lu_conv(mod, out, p):
    _e_module(mod, out, p)
    if mod.use_lu:
        out[p + "eye"] = np.eye(mod.num_channels, dtype=np.float32)


def _e_flow_seq(flows, out, p):
    """The layers at flat indices: a ``Scanned``'s layers and a plain
    ``Composite``'s flows each take the next index."""
    cursor = 0
    for flow in flows:
        layers = flow.layers() if isinstance(flow, Scanned) \
            else open_composites(flow)
        for layer in layers:
            _export(layer, out, f"{p}{cursor}.")
            cursor += 1


def _e_container(mod, out, p):
    _export(mod.q0, out, p + "q0.")
    _e_flow_seq(mod.flows, out, p + "flows.")


def _e_multiscale(mod, out, p):
    for i, q in enumerate(mod.q0):
        _export(q, out, f"{p}q0.{i}.")
    for i, level in enumerate(mod.flows):
        _e_flow_seq(level, out, f"{p}flows.{i}.")
    for i, m in enumerate(mod.merges):
        _export(m, out, f"{p}merges.{i}.")
    if mod.transform is not None:
        _export(mod.transform, out, p + "transform.")


def _e_composite(mod, out, p):
    _e_flow_seq(mod.flows, out, p + "flows.")


# the first entry whose type matches applies: subclasses before their bases
_EXPORTERS = (
    (core.MultiscaleFlow, _e_multiscale),
    ((core.NormalizingFlow, core.ClassCondFlow), _e_container),
    (MaskedLinear, _e_masked_linear),
    (ConvNet2d, _e_convnet2d),
    (ResidualNet, _e_residual_net),
    ((ResidualBlock, ConvResidualBlock), _e_no_batch_norm),
    (MADE, _e_made),
    (ActNorm, _e_actnorm),
    ((Invertible1x1Conv, InvertibleAffine), _e_lu_conv),
    (Composite, _e_composite),
    (MixedPrecision, lambda m, o, p: _export(m.net, o, p)),
    ((Linear, Conv2d, MLP, ConvResidualNet, MaskedAffineFlow,
      CCAffineConst, AffineConstFlow, LULinearPermute, LULinear,
      _Permutation, Permute, AffineCouplingBlock, AffineCoupling,
      PiecewiseRationalQuadraticCDF, CoupledRationalQuadraticSpline,
      CircularCoupledRationalQuadraticSpline,
      AutoregressiveRationalQuadraticSpline,
      CircularAutoregressiveRationalQuadraticSpline, Coupling,
      Autoregressive, MaskedResidualBlock, MaskedFeedforwardBlock, Planar,
      Radial, Reverse, Split, Merge, dist_base.GlowBase,
      dist_base.DiagGaussian, dist_base.ClassCondDiagGaussian,
      dist_base.GaussianMixture, dist_base.GaussianPCA,
      dist_base.AffineGaussian, nn.ModuleList, nn.Sequential),
     _e_module),
)


def _export(mod, out, prefix):
    for typ, fn in _EXPORTERS:
        if isinstance(mod, typ):
            fn(mod, out, prefix)
            return
    if next(mod.parameters(), None) is None and \
            next(mod.buffers(), None) is None:
        return  # holds nothing (targets, transforms, activations, ...)
    raise NotImplementedError(
        f"no state-dict exporter for {type(mod).__name__} at {prefix!r}")


def export_state_dict(model) -> dict:
    """``model``'s weights as a reference-format state dict ({dotted name:
    numpy array}); the module's notes give the coverage and the
    bookkeeping conventions."""
    out: dict = {}
    _export(model, out, "")
    return out
