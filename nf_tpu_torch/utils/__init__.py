from .eval import bits_per_dim, bits_per_dim_dataset
from .masks import create_alternating_binary_mask
from .optim import lipschitz_scales, map_modules, update_lipschitz
from .nn import (
    PeriodicFeaturesCat,
    PeriodicFeaturesElementwise,
    one_hot,
    softplus,
    sum_except_batch,
)

__all__ = ["PeriodicFeaturesCat", "PeriodicFeaturesElementwise",
           "bits_per_dim", "bits_per_dim_dataset",
           "create_alternating_binary_mask", "lipschitz_scales",
           "map_modules", "one_hot", "softplus", "sum_except_batch",
           "update_lipschitz"]
