from .cnn import Conv2d, ConvNet2d
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
           "Linear", "MADE", "MLP", "MaskedFeedforwardBlock", "MaskedLinear",
           "MaskedResidualBlock", "MixedPrecision", "ResidualBlock",
           "ResidualNet"]
