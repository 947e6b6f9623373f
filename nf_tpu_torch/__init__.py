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
``ops.splines_kernel.set_pallas_bwd_kernel("autodiff")``, kernel D. On
CUDA each step, and each served function of :mod:`nf_tpu_torch.serving`
(``compile_log_prob``, ``compile_sampler``, ``compile_log_prob_buckets``),
runs as one CUDA graph per batch shape; a conditional model's served
functions take the context as a second input (``context_shape``).
``mixed_precision=True`` on the builders runs the conditioners in
bfloat16 (``nets.MixedPrecision``). Builders, all ten of the JAX
package's: ``build_nsf``, ``build_circular_nsf``,
``build_conditional_nsf`` and the image model ``build_image_nsf`` (the
spline kernels), ``build_realnvp``, ``build_maf``,
``build_glow_multiscale``, ``build_residual``, ``build_planar_stack`` and
``build_radial_stack`` (plain products and convolutions, no kernel).
Layers that draw (a residual flow's stochastic log-det, a conditioner's
dropout, an MCMC layer) take ``generator=`` through every flow's
``forward`` / ``inverse`` and the containers' methods, as the JAX
package's take ``key=``; without one nothing is dropped. Stochastic
normalizing flows put ``flows.MetropolisHastings`` and
``flows.HamiltonianMonteCarlo`` layers into a ``NormalizingFlow``
(``sample_with_mcmc_stats`` reports their accept rates);
``sampling.HAIS`` is annealed importance sampling, and
``NormalizingFlowVAE`` a VAE with a flow posterior. ``data`` and
``utils`` hold the input pipeline, checkpoints, metrics, profiling and
debug helpers; ``compat_export.export_state_dict`` writes a model's
weights under the reference's names. ``python -m nf_tpu_torch.train`` is
the training binary, and ``parallel`` shards the steps over the ranks of
a ``torch.distributed`` process group. The image models are
``MultiscaleFlow``s; a class-conditional
one's served functions take the labels as a second input
(``class_cond``), and its sampler a ``temperature``.
"""

from . import compat_export, data, parallel, sampling, transforms, utils
from ._device import resolve_device
from .compat import load_reference_state_dict
from .core import (
    ClassCondFlow,
    ConditionalNormalizingFlow,
    MultiscaleFlow,
    NormalizingFlow,
    NormalizingFlowVAE,
)
from .distributions import ConditionalDiagGaussianTarget, TwoModes, TwoMoons
from .models import (
    build_circular_nsf,
    build_conditional_nsf,
    build_glow_multiscale,
    build_image_nsf,
    build_maf,
    build_nsf,
    build_planar_stack,
    build_radial_stack,
    build_realnvp,
    build_residual,
)
from .nets import MixedPrecision
from .parallel import (
    TrainState,
    ema_model,
    init_train_state,
    make_forward_kld_step,
    make_mesh,
    make_reverse_kld_step,
    model_of_state,
    reshape_for_accum,
    shard_batch,
)
from .serving import (
    BucketedFn,
    CompiledFn,
    compile_log_prob,
    compile_log_prob_buckets,
    compile_sampler,
)

__all__ = ["BucketedFn", "ClassCondFlow", "CompiledFn",
           "ConditionalDiagGaussianTarget", "ConditionalNormalizingFlow",
           "MixedPrecision", "MultiscaleFlow", "NormalizingFlow",
           "NormalizingFlowVAE",
           "TrainState", "TwoModes", "TwoMoons", "build_circular_nsf",
           "build_conditional_nsf", "build_glow_multiscale",
           "build_image_nsf", "build_maf", "build_nsf",
           "build_planar_stack", "build_radial_stack", "build_realnvp",
           "build_residual", "compat_export",
           "data", "parallel", "sampling", "transforms", "utils",
           "compile_log_prob", "compile_log_prob_buckets", "compile_sampler",
           "ema_model", "init_train_state", "load_reference_state_dict",
           "make_forward_kld_step", "make_mesh", "make_reverse_kld_step",
           "model_of_state", "reshape_for_accum", "resolve_device",
           "shard_batch"]
