"""Weight bridge: load a reference (normflows) state dict into the port.

The port's modules carry the reference's names, so a reference state dict
(``{dotted name: array}``, as ``nf_tpu.compat_export.export_state_dict``
emits it, or as a reference model's ``state_dict()`` holds it) maps onto
``model.state_dict()`` key for key. One layout differs: a ResidualNet with
a bin-major head orders its final layer's rows param-major (row
``p*D + d``), the reference feature-major (row ``d*mult + p``); those rows
are permuted on load.
"""

from __future__ import annotations

import numpy as np
import torch

from .nets.resnet import ResidualNet


def _head_to_bin_major(arr, head):
    """Reference feature-major head rows -> the port's bin-major rows
    (the inverse of ``nf_tpu/compat_export.py:122-131``)."""
    d, mult = head
    return arr.reshape((d, mult) + arr.shape[1:]).swapaxes(0, 1) \
        .reshape(arr.shape)


def load_reference_state_dict(model, state_dict):
    """Copy ``state_dict`` into ``model`` in place and return ``model``.
    Raises ``KeyError`` on missing or unused keys and ``ValueError`` on a
    shape mismatch."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    unused = sorted(set(state_dict) - set(own))
    if missing or unused:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:10]}, unused {unused[:10]}")
    heads = {f"{name}.final_layer.": mod.bin_major_head
             for name, mod in model.named_modules()
             if isinstance(mod, ResidualNet)
             and mod.bin_major_head is not None}
    with torch.no_grad():
        for name, tensor in own.items():
            value = np.asarray(state_dict[name])
            head = heads.get(name[:name.rfind(".") + 1])
            if head is not None:
                value = _head_to_bin_major(value, head)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: shape {value.shape} in the state "
                                 f"dict, {tuple(tensor.shape)} in the model")
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return model
