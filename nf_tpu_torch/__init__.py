"""nf_tpu_torch: the PyTorch/CUDA port of ``nf_tpu`` for NVIDIA Hopper.

The package keeps ``nf_tpu``'s module tree and class names. Plain tensor
code is PyTorch; the JAX package's Pallas kernels become CUDA kernels
written by hand (``csrc/``), built with ``nvcc`` at first use. Entry points
default to ``device="cuda"`` and raise when it is absent; the CPU runs the
plain PyTorch versions of the kernels and is reached by asking for it
(``device="cpu"``).
"""

from ._device import resolve_device
from .compat import load_reference_state_dict
from .core import NormalizingFlow
from .models import build_nsf

__all__ = ["NormalizingFlow", "build_nsf", "load_reference_state_dict",
           "resolve_device"]
