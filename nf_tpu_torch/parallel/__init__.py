"""Training (``nf_tpu/parallel``). This slice ports the single-device
forward-KLD step; meshes and the sharded steps arrive with the port's
``torch.distributed`` item."""

from .train import (
    TrainState,
    ema_model,
    init_train_state,
    make_forward_kld_step,
    model_of_state,
    reshape_for_accum,
)

__all__ = ["TrainState", "ema_model", "init_train_state",
           "make_forward_kld_step", "model_of_state", "reshape_for_accum"]
