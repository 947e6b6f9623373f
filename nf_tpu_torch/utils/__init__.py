from .masks import create_alternating_binary_mask
from .nn import PeriodicFeaturesElementwise, softplus, sum_except_batch

__all__ = ["PeriodicFeaturesElementwise", "create_alternating_binary_mask",
           "softplus", "sum_except_batch"]
