from .cnn import Conv2d, ConvNet2d
from .lipschitz import (
    InducedNormConv2d,
    InducedNormLinear,
    LipschitzCNN,
    LipschitzMLP,
    Swish,
    asym_squash,
    normalize_u,
    normalize_v,
    projmax,
    vector_norm,
)
from .made import (
    MADE,
    MaskedFeedforwardBlock,
    MaskedLinear,
    MaskedResidualBlock,
)
from .mlp import MLP, Linear, clamp_exp
from .precision import MixedPrecision
from .resnet import (
    ConvResidualBlock,
    ConvResidualNet,
    ResidualBlock,
    ResidualNet,
)

__all__ = ["Conv2d", "ConvNet2d", "ConvResidualBlock", "ConvResidualNet",
           "InducedNormConv2d", "InducedNormLinear", "LipschitzCNN",
           "LipschitzMLP", "Linear", "MADE", "MLP", "MaskedFeedforwardBlock",
           "MaskedLinear", "MaskedResidualBlock", "MixedPrecision",
           "ResidualBlock", "ResidualNet", "Swish", "asym_squash",
           "clamp_exp", "normalize_u", "normalize_v", "projmax",
           "vector_norm"]
