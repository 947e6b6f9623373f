from .eval import bits_per_dim, bits_per_dim_dataset
from .masks import create_alternating_binary_mask
from .nn import (
    PeriodicFeaturesElementwise,
    one_hot,
    softplus,
    sum_except_batch,
)

__all__ = ["PeriodicFeaturesElementwise", "bits_per_dim",
           "bits_per_dim_dataset", "create_alternating_binary_mask",
           "one_hot", "softplus", "sum_except_batch"]
