from ..nets.cnn import _NetActNorm as ActNorm
from .eval import bits_per_dim, bits_per_dim_dataset
from .masks import (
    create_alternating_binary_mask,
    create_mid_split_binary_mask,
    create_random_binary_mask,
)
from .nn import (
    ClampExp,
    ConstScaleLayer,
    PeriodicFeaturesCat,
    PeriodicFeaturesElementwise,
    one_hot,
    softplus,
    sum_except_batch,
    tile,
)
from .optim import lipschitz_scales, map_modules, update_lipschitz
from .preprocessing import Jitter, Logit, Scale
from .preprocessing import Logit as LogitPreprocessing

# the reference's spellings (normflows ``utils.bitsPerDim``), as the JAX
# package exports them; ``ActNorm`` is the net-side layer of ``ConvNet2d``
# (reference ``utils/nn.py:27``), the flow layer is ``flows.ActNorm``
bitsPerDim = bits_per_dim
bitsPerDimDataset = bits_per_dim_dataset

__all__ = ["ActNorm", "ClampExp", "ConstScaleLayer", "Jitter", "Logit",
           "LogitPreprocessing", "PeriodicFeaturesCat",
           "PeriodicFeaturesElementwise", "Scale", "bitsPerDim",
           "bitsPerDimDataset", "bits_per_dim", "bits_per_dim_dataset",
           "create_alternating_binary_mask", "create_mid_split_binary_mask",
           "create_random_binary_mask", "lipschitz_scales", "map_modules",
           "one_hot", "softplus", "sum_except_batch", "tile",
           "update_lipschitz"]
