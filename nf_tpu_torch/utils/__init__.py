from ..nets.cnn import _NetActNorm as ActNorm
from .config import TrainConfig
from .debug import checked, debug_nans
from .eval import bits_per_dim, bits_per_dim_dataset
from .logging import MetricLogger, effective_sample_size, mcmc_acceptance_rate
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
from .profiling import Named, enable_compilation_cache, throughput, trace
from .serialization import CheckpointManager, load, save

# the reference's spellings (normflows ``utils.bitsPerDim``), as the JAX
# package exports them; ``ActNorm`` is the net-side layer of ``ConvNet2d``
# (reference ``utils/nn.py:27``), the flow layer is ``flows.ActNorm``
bitsPerDim = bits_per_dim
bitsPerDimDataset = bits_per_dim_dataset

__all__ = ["ActNorm", "CheckpointManager", "ClampExp", "ConstScaleLayer",
           "Jitter", "Logit", "LogitPreprocessing", "MetricLogger", "Named",
           "PeriodicFeaturesCat", "PeriodicFeaturesElementwise", "Scale",
           "TrainConfig", "bitsPerDim", "bitsPerDimDataset",
           "bits_per_dim", "bits_per_dim_dataset", "checked",
           "create_alternating_binary_mask", "create_mid_split_binary_mask",
           "create_random_binary_mask", "debug_nans",
           "effective_sample_size", "enable_compilation_cache",
           "lipschitz_scales", "load", "map_modules",
           "mcmc_acceptance_rate", "one_hot", "save", "softplus",
           "sum_except_batch", "throughput", "tile", "trace",
           "update_lipschitz"]
