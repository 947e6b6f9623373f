from .mlp import Linear
from .resnet import ResidualBlock, ResidualNet

__all__ = ["Linear", "ResidualBlock", "ResidualNet"]
