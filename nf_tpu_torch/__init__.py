"""nf_tpu_torch: the PyTorch/CUDA port of ``nf_tpu`` for NVIDIA Hopper.

The package keeps ``nf_tpu``'s module tree and class names. Plain tensor
code is PyTorch; the JAX package's Pallas kernels become CUDA kernels
written by hand (``csrc/``), built with ``nvcc`` at first use. Entry points
default to ``device="cuda"`` and raise when it is absent; the CPU runs the
plain PyTorch versions of the kernels and is reached by asking for it
(``device="cpu"``). Training runs through
``parallel.make_forward_kld_step`` (maximum likelihood) and
``parallel.make_reverse_kld_step`` (variational, against the model's
target); on CUDA their backward goes through the kernels' backward
kernels, the analytic ones or, under
``ops.splines_kernel.set_pallas_bwd_kernel("autodiff")``, kernel D.
"""

from ._device import resolve_device
from .compat import load_reference_state_dict
from .core import NormalizingFlow
from .distributions import TwoMoons
from .models import build_circular_nsf, build_nsf
from .parallel import (
    TrainState,
    ema_model,
    init_train_state,
    make_forward_kld_step,
    make_reverse_kld_step,
    model_of_state,
    reshape_for_accum,
)

__all__ = ["NormalizingFlow", "TrainState", "TwoMoons", "build_circular_nsf",
           "build_nsf", "ema_model", "init_train_state",
           "load_reference_state_dict", "make_forward_kld_step",
           "make_reverse_kld_step", "model_of_state", "reshape_for_accum",
           "resolve_device"]
