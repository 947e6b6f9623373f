from .masks import create_alternating_binary_mask
from .nn import softplus, sum_except_batch

__all__ = ["create_alternating_binary_mask", "softplus", "sum_except_batch"]
