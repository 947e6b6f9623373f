"""Training and parallelism (``nf_tpu/parallel``): the forward-KLD and
reverse-KLD steps, on one device or sharded over a mesh of
``torch.distributed`` ranks (data-parallel and sample-parallel), the
meshes and layouts (the tensor-parallel and FSDP-style ones of
``tp.py``), multi-process runs and sharded sampling."""

from .mesh import Mesh, NamedSharding, data_sharding, make_mesh, replicated
from .multihost import (
    host_local_to_global,
    initialize_distributed,
    make_hybrid_mesh,
    per_process_batches,
    process_slice,
)
from .sampling import log_normalizer, make_sharded_sampler
from .tp import param_shardings, shard_params
from .train import (
    TrainState,
    ema_model,
    init_train_state,
    make_forward_kld_step,
    make_reverse_kld_step,
    model_of_state,
    reshape_for_accum,
    shard_batch,
)

__all__ = ["Mesh", "NamedSharding", "TrainState", "data_sharding",
           "ema_model", "host_local_to_global", "init_train_state",
           "initialize_distributed", "log_normalizer",
           "make_forward_kld_step", "make_hybrid_mesh", "make_mesh",
           "make_reverse_kld_step", "make_sharded_sampler",
           "model_of_state", "param_shardings", "per_process_batches",
           "process_slice", "replicated", "reshape_for_accum",
           "shard_batch", "shard_params"]
