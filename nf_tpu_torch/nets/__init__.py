from .cnn import Conv2d, ConvNet2d
from .lipschitz import (
    InducedNormConv2d,
    InducedNormLinear,
    LipschitzCNN,
    LipschitzMLP,
    Swish,
)
from .made import (
    MADE,
    MaskedFeedforwardBlock,
    MaskedLinear,
    MaskedResidualBlock,
)
from .mlp import MLP, Linear
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
           "ResidualBlock", "ResidualNet", "Swish"]
