from .made import (
    MADE,
    MaskedFeedforwardBlock,
    MaskedLinear,
    MaskedResidualBlock,
)
from .mlp import MLP, Linear
from .precision import MixedPrecision
from .resnet import ResidualBlock, ResidualNet

__all__ = ["Linear", "MADE", "MLP", "MaskedFeedforwardBlock", "MaskedLinear",
           "MaskedResidualBlock", "MixedPrecision", "ResidualBlock",
           "ResidualNet"]
