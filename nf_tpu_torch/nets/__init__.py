from .made import (
    MADE,
    MaskedFeedforwardBlock,
    MaskedLinear,
    MaskedResidualBlock,
)
from .mlp import Linear
from .precision import MixedPrecision
from .resnet import ResidualBlock, ResidualNet

__all__ = ["Linear", "MADE", "MaskedFeedforwardBlock", "MaskedLinear",
           "MaskedResidualBlock", "MixedPrecision", "ResidualBlock",
           "ResidualNet"]
