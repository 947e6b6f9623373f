"""GlowBlock (``nf_tpu/flows/glow.py:17-53``; reference
``normflows/flows/affine/glow.py:11-84``): an affine coupling with a
``ConvNet2d`` conditioner (kernels 3, 1, 3), an invertible 1x1
convolution (left out for one channel) and an ActNorm."""

from __future__ import annotations

import torch

from ..nets.cnn import ConvNet2d
from ..nets.precision import MixedPrecision
from .affine import AffineCouplingBlock
from .base import Composite
from .mixing import Invertible1x1Conv
from .normalization import ActNorm


class GlowBlock(Composite):
    """One Glow block, ``flows`` = [AffineCouplingBlock,
    Invertible1x1Conv, ActNorm] (the reference's names, under
    ``flows.0.``, ``flows.1.``, ``flows.2.``); the conditioner's channels
    follow the split mode (reference ``glow.py:49-64``).
    ``mixed_precision=True`` runs the conditioner in bfloat16."""

    def __init__(self, channels, hidden_channels, scale=True,
                 scale_map="sigmoid", split_mode="channel", leaky=0.0,
                 init_zeros=True, use_lu=True, net_actnorm=False,
                 mixed_precision=False, generator=None, dtype=torch.float32):
        num_param = 2 if scale else 1
        if split_mode == "channel":
            channels_ = ((channels + 1) // 2,) + 2 * (hidden_channels,)
            channels_ += (num_param * (channels // 2),)
        elif split_mode == "channel_inv":
            channels_ = (channels // 2,) + 2 * (hidden_channels,)
            channels_ += (num_param * ((channels + 1) // 2),)
        elif "checkerboard" in split_mode:
            channels_ = (channels,) + 2 * (hidden_channels,)
            channels_ += (num_param * channels,)
        else:
            raise NotImplementedError(f"Mode {split_mode} is not implemented.")
        param_map = ConvNet2d(channels_, (3, 1, 3), leaky, init_zeros,
                              actnorm=net_actnorm, generator=generator,
                              dtype=dtype)
        if mixed_precision:
            param_map = MixedPrecision(param_map)
        flows = [AffineCouplingBlock(param_map, scale, scale_map,
                                     split_mode)]
        if channels > 1:
            flows.append(Invertible1x1Conv(channels, use_lu=use_lu,
                                           generator=generator, dtype=dtype))
        flows.append(ActNorm((channels, 1, 1), dtype=dtype))
        super().__init__(flows)
