"""Mixed-precision conditioner wrapper (``nf_tpu/nets/precision.py:33-62``).

The conditioner nets (the ResidualNet trunks, the MADEs) carry nearly all
of a flow's products; the flow-level math (the splines and the log-det
sums) stays in float32. :class:`MixedPrecision` draws that line: the
parameters stay float32 and get float32 gradients, and the wrapped net's
forward runs on copies cast to ``compute_dtype`` (bfloat16 by default,
which the H100 runs on its tensor cores) together with its float inputs;
float outputs are cast back to the input's dtype. The casts sit inside
autograd, so the optimizer sees float32 master weights.

Every float tensor of the net is cast, its buffers (a MADE's masks, the
periodic features' scale) included, as the JAX package casts every float
leaf; ``torch.autocast``, which casts only the inputs of its listed ops,
would run the rest of the net in float32.

Attribute reads the wrapper does not have go to the wrapped float32 net
(``precision.py:47-52``): ``hidden_features``, ``bin_major_head``,
``final_layer`` and ``features_transposed``. So where a coupling takes the
fused head (kernel B: CUDA, a transposed trunk, B*D >= 4096), the trunk
it runs through ``features_transposed`` and the head kernel B reads stay
float32, as on a TPU; the unfused feed and every MADE run in
``compute_dtype``.

A dropout ``generator`` passes through uncast, as the JAX package passes
its keys (``precision.py:40``); the masks are drawn from float32 uniforms
in either dtype (``nets/_dropout.py``), so a bfloat16 trunk drops the
same activations as its float32 twin.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call


def _cast(x, dtype):
    """``x`` cast to ``dtype`` if it is a float tensor; tuples and lists
    element by element; anything else unchanged."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


class MixedPrecision(nn.Module):
    """Run the conditioner ``net`` in ``compute_dtype``, float32 outside:
    ``net(x, *args, **kwargs)`` with ``net``'s float parameters and
    buffers and every float argument cast to ``compute_dtype``, the float
    outputs cast back to ``x``'s dtype (float32 when ``x`` is not a float
    tensor)."""

    def __init__(self, net, compute_dtype=torch.bfloat16):
        super().__init__()
        self.net = net
        self.compute_dtype = compute_dtype

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("_") or name == "net":
                raise
            return getattr(super().__getattr__("net"), name)

    def forward(self, x, *args, **kwargs):
        out_dtype = x.dtype if x.is_floating_point() else torch.float32
        cd = self.compute_dtype
        tensors = {n: _cast(t, cd) for n, t in self.net.named_parameters()}
        tensors.update((n, _cast(t, cd))
                       for n, t in self.net.named_buffers())
        out = functional_call(
            self.net, tensors, _cast((x,) + args, cd),
            {k: _cast(v, cd) for k, v in kwargs.items()})
        return _cast(out, out_dtype)
